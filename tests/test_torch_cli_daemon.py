"""The port's CLI against a running daemon and around it
(gpud_tpu_torch/cli.py: ``run``, ``inject-fault``, ``status``,
``set-healthy``, ``predict``, ``fabric``, ``session status``, ``chaos
list|run``, ``notify``, ``up``, ``down``; gpud_tpu_torch/manager/systemd.py) against gpud_tpu's.

The reference's own tests of these commands run on the port
(tests/torch_ref_tests.py, with tests/torch_live.py's replacements and
``live_server``): tests/test_cli_json_contracts.py, test_cli_matrix.py
(``up``'s login against the port's manager), test_subprocess_e2e.py
(``python -m gpud_tpu_torch run`` and ``manager serve`` as child processes,
driven by the SDK and by the CLI in other processes) and test_systemd_manager.py. Then the port's
own cases: the scan's ``--json`` schema with the port's ``repair_actions``,
and each query command's ``--json`` output and exit code equal to the
reference's against the two servers. Every daemon binds 127.0.0.1."""

import json
import sys

import pytest

from gpud_tpu.cli import main as ref_main

from gpud_tpu_torch.cli import build_parser, main

from torch_live import REF_TO_PORT, live_server, port_host  # noqa: F401
from torch_parity import COMPONENTS, nouns, stub_host_probes
from torch_ref_tests import port_tests

globals().update(port_tests("test_cli_json_contracts.py", replace=REF_TO_PORT + [
    # the port's fleet scan reads the NVLink store's rows and runs on the
    # CPU only when asked
    ("from gpud_tpu_torch.components.tpu.ici_store import ICIStore",
     "from gpud_tpu_torch.components.gpu.nvlink_store import NVLinkStore as ICIStore"),
    ("from gpud_tpu_torch.tpu.instance import ICILinkSnapshot, LinkState",
     "from gpud_tpu_torch.gpu.instance import NVLinkSnapshot as ICILinkSnapshot, LinkState"),
    ('["fleet-scan", "--json", *paths]', '["fleet-scan", "--json", "--device", "cpu", *paths]'),
    ('"accelerator-tpu-ici"', '"accelerator-gpu-nvlink"'),
], exclude=[
    # the port's scan rows carry ``repair_actions`` too
    # (tests/test_torch_scan.py): held below with that key
    "test_scan_json_schema",
]))
globals().update(port_tests("test_cli_matrix.py", replace=REF_TO_PORT))
globals().update(port_tests("test_subprocess_e2e.py", replace=REF_TO_PORT))
globals().update(port_tests("test_systemd_manager.py"))


@pytest.fixture(autouse=True)
def _argv0(monkeypatch):
    # argparse names the program from sys.argv[0] in its messages
    monkeypatch.setattr(sys, "argv", ["tpud"])


def test_scan_json_schema_with_repair_actions(capsys, tmp_path, monkeypatch):
    kmsg = tmp_path / "kmsg"
    kmsg.write_text("")
    monkeypatch.setenv("TPUD_KMSG_FILE_PATH", str(kmsg))
    assert main(["scan", "--json", "--kmsg-path", str(kmsg)]) == 0
    doc = json.loads(capsys.readouterr().out)
    names = [r["component"] for r in doc]
    assert "cpu" in names and "accelerator-gpu-nvlink" in names
    for r in doc:
        assert set(r) == {"component", "health", "reason", "extra_info", "repair_actions"}
        assert r["health"] in ("Healthy", "Degraded", "Unhealthy")
        assert isinstance(r["extra_info"], dict) and isinstance(r["repair_actions"], list)


def test_scan_json_carries_the_ledger_s_availability(capsys, tmp_path, monkeypatch):
    from gpud_tpu_torch.config import default_config
    from gpud_tpu_torch.health_history import HealthLedger
    from gpud_tpu_torch.sqlite import DB

    kmsg = tmp_path / "kmsg"
    kmsg.write_text("")
    monkeypatch.setenv("TPUD_KMSG_FILE_PATH", str(kmsg))
    db = DB(default_config(data_dir=str(tmp_path / "d")).state_file())
    ledger = HealthLedger(db)
    ledger.observe("cpu", "Healthy", "ok")
    ledger.close()
    db.close()
    assert main(["scan", "--json", "--data-dir", str(tmp_path / "d")]) == 0
    rows = {r["component"]: r for r in json.loads(capsys.readouterr().out)}
    assert "availability" in rows["cpu"] and "availability" not in rows["os"]


def test_run_help_names_the_reference_s_flags(capsys):
    with pytest.raises(SystemExit) as ei:
        main(["run", "--help"])
    assert ei.value.code == 0
    out = capsys.readouterr().out
    for flag in ("--data-dir", "--kmsg-path", "--port", "--db-in-memory", "--no-tls",
                 "--accelerator-type", "--expected-gpu-count", "--plugin-specs", "--endpoint",
                 "--token", "--disable-components", "--pprof"):
        assert flag in out, flag


@pytest.mark.parametrize("argv", [
    ["status"], ["set-healthy", "--component", "cpu"], ["predict"], ["fabric"],
    ["session", "status"], ["inject-fault"], ["notify", "startup"], ["up"], ["down"],
    ["run"], ["chaos", "run"], ["chaos", "list"],
])
def test_the_commands_take_the_reference_s_flags(argv):
    import argparse

    from gpud_tpu.cli import build_parser as ref_build_parser

    def flags(parser, argv):
        sub = parser._subparsers._group_actions[0].choices[argv[0]]
        if argv[0] in ("session", "chaos"):
            sub = sub._subparsers._group_actions[0].choices[argv[1]]
        return sorted(a.option_strings[0] for a in sub._actions
                      if a.option_strings and not isinstance(a, argparse._HelpAction))

    ref = [{"--chip-id": "--gpu-id", "--expected-chip-count": "--expected-gpu-count"}.get(f, f)
           for f in flags(ref_build_parser(), argv)]
    assert flags(build_parser(), argv) == sorted(ref)


# -- the query commands, both CLIs against both servers -------------------------------


@pytest.fixture(scope="module")
def ref_server(tmp_path_factory):
    from gpud_tpu.config import default_config as ref_default_config
    from gpud_tpu.server.server import Server as RefServer

    mp = pytest.MonkeyPatch()
    stub_host_probes(mp)
    tmp = tmp_path_factory.mktemp("ref-cli-server")
    (tmp / "k").write_text("")
    s = RefServer(config=ref_default_config(
        data_dir=str(tmp / "d"), port=0, tls=False, kmsg_path=str(tmp / "k"),
        components_disabled=["network-latency"], endpoint="", token=""))
    s.start()
    yield s
    s.stop()
    mp.undo()


def _both(capsys, ref_server, live_server, argv):
    out = {}
    for name, fn, srv in (("ref", ref_main, ref_server), ("port", main, live_server)):
        rc = fn(argv + ["--no-tls", "--port", str(srv.port)])
        cap = capsys.readouterr()
        out[name] = (rc, cap.out, cap.err)
    return out


def test_session_status_is_the_reference_s(capsys, ref_server, live_server):
    got = _both(capsys, ref_server, live_server, ["session", "status"])
    assert got["port"] == got["ref"] == (
        0, "session: not configured (no control-plane endpoint/token)\n", "")
    got = _both(capsys, ref_server, live_server, ["session", "status", "--json"])
    ref, port = (json.loads(got[k][1]) for k in ("ref", "port"))
    assert set(port) == set(ref) and port["configured"] is ref["configured"] is False
    assert port["circuit"].keys() == ref["circuit"].keys()
    assert port["outbox"].keys() == ref["outbox"].keys()


def test_predict_calibration_is_the_reference_s(capsys, ref_server, live_server):
    # a re-fit on both first: each engine's own first fit waits one scan
    # interval after its boot, and the two servers booted apart
    got = _both(capsys, ref_server, live_server, ["predict", "--calibration", "--refit"])
    ref, port = (json.loads(got[k][1]) for k in ("ref", "port"))
    assert got["port"][0] == got["ref"][0] == 0
    assert ref.pop("last_calibrate") > 0 and port.pop("last_calibrate") > 0
    assert json.loads(nouns(json.dumps(ref))) == port


def test_status_json_is_the_reference_s_on_the_components_both_run(
        capsys, ref_server, live_server):
    got = _both(capsys, ref_server, live_server, ["status", "--json"])
    ref, port = (json.loads(got[k][1]) for k in ("ref", "port"))
    assert set(port) == set(ref) == {"version", "unhealthy", "components"}
    assert port["version"] == ref["version"]
    assert (got["port"][0] == 1) == (port["unhealthy"] > 0)
    ref_names = {COMPONENTS.get(c["component"], c["component"]) for c in ref["components"]}
    port_names = {c["component"] for c in port["components"]}
    assert port_names == ref_names


@pytest.mark.parametrize("argv", [["status"], ["set-healthy", "--component", "cpu"],
                                  ["predict"], ["fabric"], ["session", "status"]])
def test_an_unreachable_daemon_is_exit_1_as_in_the_reference(capsys, argv):
    got = {}
    for name, fn in (("ref", ref_main), ("port", main)):
        got[name] = fn(argv + ["--no-tls", "--port", "1"])
        err = capsys.readouterr().err
        assert err.startswith(("tpud unreachable on port 1: ", "error: ")), err
    assert got["port"] == got["ref"] == 1


# -- chaos list / run, both CLIs against both daemons ---------------------------------

CHAOS_RUN = "ici-link-degrade"  # needs no control plane; about 1.5 s on each


def _idle(*servers, timeout=60.0):
    import time

    deadline = time.monotonic() + timeout
    while any(s.chaos.campaigns()["running"] for s in servers):
        assert time.monotonic() < deadline, "a chaos campaign still running"
        time.sleep(0.05)


def _shape(text):
    """A campaign printout with its figures, ids and details out: the
    phase and expectation marks, kinds and verdict lines."""
    import re

    out = []
    for line in text.splitlines():
        line = re.sub(r"\] .*", "]", line)  # an expectation's detail
        line = re.sub(r"\(id \d+\)", "(id N)", line)
        out.append(re.sub(r"\d+(\.\d+)?s\)", "Ns)", line))
    return out


def test_chaos_list_is_the_reference_s(capsys, ref_server, live_server):
    _idle(ref_server, live_server)
    got = _both(capsys, ref_server, live_server, ["chaos", "list", "--json"])
    ref, port = (json.loads(got[k][1]) for k in ("ref", "port"))
    assert got["port"][0] == got["ref"][0] == 0
    assert set(port) == set(ref) == {"running", "campaigns", "count", "scenarios"}
    assert port["scenarios"] == ref["scenarios"] and len(port["scenarios"]) == 13
    got = _both(capsys, ref_server, live_server, ["chaos", "list", "--limit", "0"])
    assert got["port"][0] == got["ref"][0] == 0
    scenarios = ["scenarios:"] + [f"  {n}" for n in ref["scenarios"]]
    for rc, out, err in got.values():
        assert out.splitlines()[:14] == scenarios and err == ""


def test_chaos_run_is_the_reference_s(capsys, ref_server, live_server):
    _idle(ref_server, live_server)
    got = _both(capsys, ref_server, live_server, ["chaos", "run", CHAOS_RUN])
    assert got["port"][0] == got["ref"][0] == 0, got
    assert _shape(got["port"][1]) == _shape(got["ref"][1])
    assert got["port"][1].splitlines()[-1].startswith(f"PASS: {CHAOS_RUN} (")
    assert got["port"][2] == got["ref"][2] == ""
    got = _both(capsys, ref_server, live_server, ["chaos", "run", CHAOS_RUN, "--json"])
    ref, port = (json.loads(got[k][1]) for k in ("ref", "port"))
    assert got["port"][0] == got["ref"][0] == 0
    assert set(port) == set(ref) and port["passed"] is ref["passed"] is True
    assert [(p["name"], [e["kind"] for e in p["expectations"]]) for p in port["phases"]] == \
        [(p["name"], [e["kind"] for e in p["expectations"]]) for p in ref["phases"]]


def test_chaos_run_no_wait_is_the_reference_s(capsys, ref_server, live_server):
    _idle(ref_server, live_server)
    got = _both(capsys, ref_server, live_server, ["chaos", "run", CHAOS_RUN, "--no-wait"])
    try:
        assert got["port"][0] == got["ref"][0] == 0
        assert _shape(got["port"][1]) == _shape(got["ref"][1]) == \
            [f"campaign {CHAOS_RUN} launched (id N)"]
    finally:
        _idle(ref_server, live_server)
    for s in (ref_server, live_server):
        assert s.chaos.campaigns()["campaigns"][0]["passed"] is True


def test_chaos_run_of_an_unknown_campaign_is_the_reference_s(capsys, ref_server, live_server):
    got = _both(capsys, ref_server, live_server, ["chaos", "run", "no-such-campaign"])
    assert got["port"] == got["ref"]
    rc, out, err = got["port"]
    assert rc == 1 and out == "" and err.startswith("error: ") and "not found" in err
