"""The port's offline state-DB subcommands (``python -m gpud_tpu_torch
compact|metadata|history|remediation``) against ``gpud_tpu.cli``'s, on a
state DB written by the reference and on one written by the port: the same
exit codes and the same output, JSON and text, and the same answer for a
data dir without a DB. The clock is frozen, so both read the same window."""

import json
import re
import time

import pytest

import gpud_tpu.cli as ref_cli
import gpud_tpu_torch.cli as port_cli

from torch_daemon_parity import PKGS

NOW = 1_800_000_000.0


def write_state(pkg, data_dir):
    """A state DB as a daemon of ``pkg`` leaves it: metadata, a ledger with
    two components' transitions, remediation rows, through the writer."""
    db = pkg.sqlite.DB(str(data_dir / "tpud.state"))
    w = pkg.writer.BatchWriter(db)
    md = pkg.metadata.Metadata(db)
    md.set("machine_id", "m-123")
    md.set("token", "t")
    led = pkg.health_history.HealthLedger(db, writer=w)
    for i, (comp, state, reason) in enumerate([
            ("cpu", "Healthy", ""), ("accelerator-x", "Healthy", ""),
            ("accelerator-x", "Unhealthy", "fallen off the bus"), ("cpu", "Degraded", "load"),
            ("accelerator-x", "Healthy", "set healthy"), ("cpu", "Healthy", "")]):
        led.observe(comp, state, reason, now=NOW - 7200 + 600 * i)
    audit = pkg.audit.AuditStore(db, writer=w)
    for i, (action, outcome) in enumerate([("reboot_system", "dry_run"),
                                           ("hardware_inspection", "manual"),
                                           ("set_healthy", "executed")]):
        audit.record(component="accelerator-x", action=action, suggested="REBOOT_SYSTEM",
                     trigger_health="Unhealthy", trigger_reason="fallen off the bus",
                     decision=outcome, outcome=outcome, detail=f"d{i}",
                     ts=NOW - 3600 + 60 * i)
    w.close()
    db.close()


@pytest.fixture()
def frozen(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)


def run(cli, argv, capsys):
    rc = cli.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


ARGVS = [
    ["history", "--json"],
    ["history"],
    ["history", "--component", "cpu", "--json"],
    ["history", "--since-hours", "1.5", "--limit", "1", "--json"],
    ["remediation", "--json"],
    ["remediation"],
    ["remediation", "--outcome", "manual", "--json"],
    ["remediation", "--action", "set_healthy", "--limit", "1"],
    ["metadata"],
]


@pytest.mark.parametrize("writer", PKGS, ids=["ref-db", "port-db"])
@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a) for a in ARGVS])
def test_the_subcommand_prints_what_the_reference_prints(tmp_path, capsys, frozen, writer, argv):
    write_state(writer, tmp_path)
    full = argv + ["--data-dir", str(tmp_path)]
    ref = run(ref_cli, full, capsys)
    port = run(port_cli, full, capsys)
    assert port == ref
    assert ref[0] == 0 and ref[1]
    if "--json" in argv:
        json.loads(ref[1])


@pytest.mark.parametrize("writer", PKGS, ids=["ref-db", "port-db"])
def test_history_and_remediation_read_every_row(tmp_path, capsys, frozen, writer):
    write_state(writer, tmp_path)
    _, out, _ = run(port_cli, ["history", "--json", "--data-dir", str(tmp_path)], capsys)
    doc = json.loads(out)
    assert [(t["component"], t["from"], t["to"]) for t in doc["transitions"]] == [
        ("cpu", "Degraded", "Healthy"), ("accelerator-x", "Unhealthy", "Healthy"),
        ("cpu", "Healthy", "Degraded"), ("accelerator-x", "Healthy", "Unhealthy")]
    assert sorted(doc["availability"]) == ["accelerator-x", "cpu"]
    _, out, _ = run(port_cli, ["remediation", "--json", "--data-dir", str(tmp_path)], capsys)
    assert json.loads(out)["summary"] == {
        "attempts_total": 3, "by_outcome": {"dry_run": 1, "executed": 1, "manual": 1}}


@pytest.mark.parametrize("writer", PKGS, ids=["ref-db", "port-db"])
def test_compact_vacuums_as_the_reference(tmp_path, capsys, writer):
    write_state(writer, tmp_path)
    seconds = re.compile(r" in \d+\.\d\ds ")
    ref = run(ref_cli, ["compact", "--data-dir", str(tmp_path)], capsys)
    port = run(port_cli, ["compact", "--data-dir", str(tmp_path)], capsys)
    assert port[0] == ref[0] == 0
    # the same file and size; the seconds are the VACUUM's own wall time
    assert seconds.sub(" in Xs ", port[1]) == seconds.sub(" in Xs ", ref[1])
    assert str(tmp_path / "tpud.state") in port[1]


@pytest.mark.parametrize("argv", [["history"], ["remediation"], ["history", "--json"],
                                  ["metadata"], ["compact"]])
def test_a_data_dir_without_a_db_answers_as_the_reference(tmp_path, capsys, argv):
    ref = run(ref_cli, argv + ["--data-dir", str(tmp_path / "ref")], capsys)
    port = run(port_cli, argv + ["--data-dir", str(tmp_path / "port")], capsys)
    assert port[0] == ref[0]
    assert port[2].replace("/port/", "/ref/") == ref[2]
    if argv[0] in ("history", "remediation"):
        assert port[0] == 1 and "has the daemon ever run?" in port[2]
