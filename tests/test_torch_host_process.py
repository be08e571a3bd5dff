"""The port's host, process and inotify modules (gpud_tpu_torch/host.py,
process.py, inotify.py) against the reference's (gpud_tpu/host.py,
process.py, inotify.py)."""

import dataclasses
import sys

import pytest

import gpud_tpu.host as ref_host
from gpud_tpu.eventstore import EventStore as RefEventStore
from gpud_tpu.inotify import InotifyWatch as RefInotifyWatch
from gpud_tpu.process import run_command as ref_run_command
from gpud_tpu.sqlite import DB as RefDB

import gpud_tpu_torch.host as host
from gpud_tpu_torch.eventstore import EventStore
from gpud_tpu_torch.inotify import InotifyWatch
from gpud_tpu_torch.process import DEFAULT_TIMEOUT, RunResult, run_command
from gpud_tpu_torch.sqlite import DB


@pytest.mark.parametrize("argv", [
    ["echo", "hi"],
    ["bash", "-c", "echo out; echo err 1>&2; exit 3"],
    ["definitely-not-a-binary-xyz"],
    [sys.executable, "-c", "import sys; sys.stdout.buffer.write(b'\\xff ok')"],
], ids=["ok", "combined-output", "missing-binary", "undecodable"])
def test_run_command_matches_the_reference(argv):
    got, want = run_command(argv), ref_run_command(argv)
    strip = lambda r: {**dataclasses.asdict(r), "duration_seconds": 0.0, "ok": r.ok}  # noqa: E731
    assert strip(got) == strip(want)


def test_run_command_timeout():
    r = run_command(["bash", "-c", "sleep 5"], timeout=0.2)
    assert r.timed_out and r.exit_code == -1 and "timed out after 0.2s" in r.error
    assert not r.ok and isinstance(r, RunResult) and DEFAULT_TIMEOUT == 60.0


def test_run_command_env_is_added_to_the_environment():
    r = run_command(["bash", "-c", "echo $TPUD_TEST_X"], env={"TPUD_TEST_X": "42"})
    assert r.ok and r.output.strip() == "42"


def test_host_identity_matches_the_reference():
    assert host.machine_id() == ref_host.machine_id() != ""
    assert host.boot_id() == ref_host.boot_id()
    assert abs(host.uptime_seconds() - ref_host.uptime_seconds()) < 5.0
    assert abs(host.boot_time() - ref_host.boot_time()) < 1.0
    assert (host.REBOOT_COMPONENT, host.EVENT_NAME_REBOOT) == (
        ref_host.REBOOT_COMPONENT, ref_host.EVENT_NAME_REBOOT)


def test_uptime_of_an_unreadable_file_is_zero(monkeypatch):
    monkeypatch.setattr(host, "_read_first_line", lambda p: "")
    assert host.uptime_seconds() == 0.0 and host.boot_id() == ""


@pytest.mark.parametrize("boots", [[1000.4], [1000.4, 1000.6], [1000.0, 1100.0],
                                   [1000.0, 1200.0, 5000.0]],
                         ids=["one", "same-boot", "within-120s", "three"])
def test_reboot_event_store_matches_the_reference(tmp_path, monkeypatch, boots):
    ref_db, db = RefDB(str(tmp_path / "ref.db")), DB(str(tmp_path / "port.db"))
    try:
        ref, port = ref_host.RebootEventStore(RefEventStore(ref_db)), \
            host.RebootEventStore(EventStore(db))
        monkeypatch.setattr(ref_host, "boot_id", lambda: "b-1")
        monkeypatch.setattr(host, "boot_id", lambda: "b-1")
        for bt in boots:
            monkeypatch.setattr(ref_host, "boot_time", lambda bt=bt: bt)
            monkeypatch.setattr(host, "boot_time", lambda bt=bt: bt)
            ref.record_reboot()
            port.record_reboot()
        for since in (0.0, 1100.0):
            assert [dataclasses.asdict(e) for e in port.get_reboot_events(since)] == \
                [dataclasses.asdict(e) for e in ref.get_reboot_events(since)]
    finally:
        ref_db.close()
        db.close()


def test_inotify_wakes_on_a_write_like_the_reference(tmp_path):
    p = tmp_path / "f"
    p.write_text("")
    watches = [InotifyWatch.create(str(p)), RefInotifyWatch.create(str(p))]
    try:
        if watches[1] is None:  # no inotify here: the port must say so too
            assert watches[0] is None
            return
        assert [w.wait(0) for w in watches] == [False, False]
        with open(p, "a") as f:
            f.write("x")
        assert [w.wait(1000) for w in watches] == [True, True]
        assert [w.wait(0) for w in watches] == [False, False]  # drained
    finally:
        for w in watches:
            if w is not None:
                w.close()
    watches[0].close()  # twice is fine
    assert InotifyWatch.create(str(tmp_path / "missing")) is None
    assert InotifyWatch.IN_MODIFY == RefInotifyWatch.IN_MODIFY
