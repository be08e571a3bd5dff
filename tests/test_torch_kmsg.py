"""The port's kmsg pipeline (gpud_tpu_torch/kmsg/: watcher, deduper, syncer,
writer) held exactly to the reference's (gpud_tpu/kmsg/) on the reference's
lines, among them tests/fixtures/kmsg/v5p_boot_with_faults.log (read, not
changed). Fake clocks, no sleeps: the watcher is driven in the test's own
thread and stops from its callback."""

import dataclasses
from pathlib import Path

import pytest

import gpud_tpu.kmsg.watcher as ref_watcher
from gpud_tpu.eventstore import EventStore as RefEventStore
from gpud_tpu.kmsg.deduper import Deduper as RefDeduper
from gpud_tpu.kmsg.syncer import Syncer as RefSyncer
from gpud_tpu.kmsg.writer import KmsgWriter as RefWriter
from gpud_tpu.sqlite import DB as RefDB

import gpud_tpu_torch.kmsg.watcher as watcher
from gpud_tpu_torch.api.v1.types import EventType
from gpud_tpu_torch.eventstore import EventStore
from gpud_tpu_torch.kmsg.deduper import Deduper
from gpud_tpu_torch.kmsg.syncer import SharedWatcher, Syncer
from gpud_tpu_torch.kmsg.writer import MAX_PRINTK_RECORD, KmsgWriter
from gpud_tpu_torch.sqlite import DB

FIXTURE = Path(__file__).parent / "fixtures" / "kmsg" / "v5p_boot_with_faults.log"
BOOT = 1_700_000_000.0

LINES = [
    "6,1234,5678901,-;hello world",
    "26,1,10,-;msg;with;semis",
    " SUBSYSTEM=pci",
    "no-separator",
    "a,b,c;x",
    "",
    "6,18446744073709551615,0,-;huge seq survives",
    "6,1,18446744073709551615,-;huge usec survives",
    b"2,5,1000,-;bad \xff\xfe bytes".decode("utf-8", "replace"),
    "6,7,1000,-;line one\\x0aline two",
    "6,100,2000,c;msg with flags",
    "7,3,40,-;",
    "0,3,40,-;emerg",
    "3,9,12,extra,fields;NVRM: Xid (PCI:0000:18:00): 79, pid=1, GPU has fallen off the bus.\n",
] + FIXTURE.read_text().splitlines()


def _fields(m):
    return None if m is None else dataclasses.astuple(m) + (m.priority_name,)


# the reference's native parser clamps these at 2^63 - 1; its Python parser,
# which it keeps as the oracle and which the port copies, does not
OVERFLOW = {6, 7}
NATIVE_PARSE = ref_watcher._native_parse


@pytest.fixture(autouse=True)
def fixed_boot(monkeypatch):
    monkeypatch.setattr(ref_watcher, "boot_time", lambda: BOOT)
    monkeypatch.setattr(watcher, "boot_time", lambda: BOOT)
    # both Python parsers: the parity oracles of the native one
    # (tests/test_torch_native.py holds the port's native parser to them)
    monkeypatch.setattr(ref_watcher, "_native_parse", None)
    monkeypatch.setattr(watcher, "_native_parse", None)


@pytest.mark.parametrize("i", range(len(LINES)))
def test_parse_line_matches_the_reference(i, monkeypatch):
    assert _fields(watcher.parse_line(LINES[i], BOOT)) == \
        _fields(ref_watcher.parse_line(LINES[i], BOOT))
    if i not in OVERFLOW:
        monkeypatch.setattr(ref_watcher, "_native_parse", NATIVE_PARSE)
        assert _fields(watcher.parse_line(LINES[i], BOOT)) == \
            _fields(ref_watcher.parse_line(LINES[i], BOOT))


def test_settings_are_the_references():
    assert (watcher.ENV_KMSG_PATH, watcher.DEFAULT_KMSG_PATH) == (
        ref_watcher.ENV_KMSG_PATH, ref_watcher.DEFAULT_KMSG_PATH) == (
        "TPUD_KMSG_FILE_PATH", "/dev/kmsg")
    assert watcher.kmsg_path("/x") == "/x"


@pytest.mark.parametrize("limit", [0, 3])
def test_read_all_of_the_fixture_matches_the_reference(limit):
    got = [_fields(m) for m in watcher.read_all(str(FIXTURE), limit=limit)]
    assert got == [_fields(m) for m in ref_watcher.read_all(str(FIXTURE), limit=limit)]
    assert len(got) == (limit or 25)


def test_read_all_follows_the_env_setting(tmp_path, monkeypatch):
    p = tmp_path / "kmsg"
    p.write_text("4,9,50,-;via env\n")
    monkeypatch.setenv("TPUD_KMSG_FILE_PATH", str(p))
    assert [m.message for m in watcher.read_all()] == ["via env"]
    assert watcher.read_all(str(tmp_path / "missing")) == []


def test_boot_time_reads_the_hosts_uptime(monkeypatch):
    monkeypatch.undo()
    from gpud_tpu_torch import host

    monkeypatch.setattr(host, "uptime_seconds", lambda: 100.0)
    monkeypatch.setattr(watcher.time, "time", lambda: 1000.0)
    assert watcher.boot_time() == 900.0
    monkeypatch.setattr(host, "uptime_seconds", lambda: 0.0)
    assert watcher.boot_time() == 0.0


def _follow(path, from_now, count, append=None):
    """Run the watcher's follow loop in this thread until ``count``
    messages arrived; ``append`` is written once the loop has opened the
    file (from its first delivery, or at once when nothing is due)."""
    got = []
    w = watcher.Watcher(None, path=str(path), from_now=from_now, poll_timeout_ms=1)

    def deliver(m):
        got.append(m)
        if len(got) >= count:
            w._stop.set()

    w.callback = deliver
    if append is not None:
        with open(path, "a") as f:
            f.write(append)
    w._follow_once()
    return got


def test_watcher_replays_a_file_from_the_start(tmp_path):
    p = tmp_path / "kmsg"
    p.write_text(FIXTURE.read_text())
    got = _follow(p, from_now=False, count=25)
    assert [_fields(m) for m in got] == \
        [_fields(m) for m in ref_watcher.read_all(str(FIXTURE))]


class _AppendOnWait:
    """Stands in for the file's inotify watch: the first wait appends a
    record, as a writer would while the watcher sleeps."""

    def __init__(self, path, record):
        self.path, self.record = path, record

    def wait(self, _timeout_ms):
        if self.record:
            with open(self.path, "a") as f:
                f.write(self.record)
            self.record = ""
        return True

    def close(self):
        pass


def test_watcher_from_now_skips_what_is_there(tmp_path, monkeypatch):
    p = tmp_path / "kmsg"
    p.write_text("6,1,100,-;old line\n")
    monkeypatch.setattr(watcher._InotifyWatch, "create",
                        lambda path, *a: _AppendOnWait(path, "3,2,200,-;new line\n"))
    got = []
    w = watcher.Watcher(None, path=str(p), from_now=True)
    assert w.boot_unix == BOOT
    w.callback = lambda m: (got.append(m.message), w._stop.set())
    w._follow_once()
    assert got == ["new line"]


def test_deduper_matches_the_reference():
    now = [1000.0]
    port = Deduper(ttl_seconds=10.0, max_entries=4, time_now_fn=lambda: now[0])
    ref = RefDeduper(ttl_seconds=10.0, max_entries=4, time_now_fn=lambda: now[0])
    steps = [("msg", 5.0), ("msg", 5.0), ("msg", 6.0), ("a", 1.0), ("b", 1.0), ("c", 1.0),
             ("msg", 5.0), ("tick", 0), ("msg", 5.0), ("a", 1.0), ("a", 1.9), ("a", 2.0)]
    for message, ts in steps:
        if message == "tick":
            now[0] += 20.0
            continue
        assert port.seen_before(message, ts) == ref.seen_before(message, ts), (message, ts)
        assert len(port) == len(ref)


def test_deduper_bounds_its_entries():
    d = Deduper(ttl_seconds=1e9, max_entries=10)
    for i in range(50):
        d.seen_before(f"m{i}", float(i))
    assert len(d) == 10


def _match(line):
    if "TPU" in line or "GPU" in line:
        return ("err", EventType.CRITICAL, line, {"gpu": "3"} if "3" in line else None)
    return None


def test_syncer_matches_the_reference(tmp_path):
    ref_db, db = RefDB(str(tmp_path / "ref.db")), DB(str(tmp_path / "port.db"))
    try:
        now = [100.0]
        ref_seen, port_seen = [], []
        ref = RefSyncer(_match, RefEventStore(ref_db).bucket("c"),
                        deduper=RefDeduper(time_now_fn=lambda: now[0]),
                        on_event=ref_seen.append)
        port = Syncer(_match, EventStore(db).bucket("c"),
                      deduper=Deduper(time_now_fn=lambda: now[0]), on_event=port_seen.append)
        msgs = [(3, "GPU fault on gpu 3", 10.0), (6, "irrelevant", 11.0),
                (3, "GPU fault on gpu 3", 10.0), (2, "GPU lost", 12.0),
                (3, "GPU fault on gpu 3", 10.9)]
        for prio, text, t in msgs:
            r = ref.process(ref_watcher.Message(priority=prio, message=text, time=t))
            p = port.process(watcher.Message(priority=prio, message=text, time=t))
            assert (p is None) == (r is None)
            if p is not None:
                assert dataclasses.asdict(p) == dataclasses.asdict(r)
        assert [dataclasses.asdict(e) for e in port.bucket.get(0)] == \
            [dataclasses.asdict(e) for e in ref.bucket.get(0)]
        assert len(port_seen) == len(ref_seen) == 2
        assert port_seen[0].extra_info == {"gpu": "3", "kmsg": "GPU fault on gpu 3",
                                           "priority": "err", "error_class": "err"}
    finally:
        ref_db.close()
        db.close()


def test_syncer_event_dedupe_against_the_store(tmp_path):
    db = DB(str(tmp_path / "s.db"))
    try:
        bucket = EventStore(db).bucket("c")
        msg = watcher.Message(message="GPU lost", time=50.0, priority=2)
        Syncer(_match, bucket, deduper=Deduper()).process(msg)
        # a restarted daemon (fresh cache) re-reads the same record
        Syncer(_match, bucket, deduper=Deduper()).process(msg)
        assert len(bucket.get(0)) == 1
    finally:
        db.close()


def test_shared_watcher_fans_out_to_every_syncer(tmp_path):
    db = DB(str(tmp_path / "s.db"))
    try:
        es = EventStore(db)
        sw = SharedWatcher(path=str(tmp_path / "kmsg"), from_now=False)
        hits = []
        for name in ("c1", "c2"):
            sw.register(Syncer(_match, es.bucket(name), on_event=hits.append))
        sw._dispatch(watcher.Message(message="GPU gone", time=5.0))
        sw._dispatch(watcher.Message(message="nothing", time=6.0))
        assert [e.component for e in hits] == ["c1", "c2"]
        assert [e.name for e in es.bucket("c2").get(0)] == ["err"]
    finally:
        db.close()


@pytest.mark.parametrize("message, priority", [
    ("hello", 3), ("hello\nworld", 1), ("x" * 2000, 2), ("NVRM: Xid (PCI:0000:18:00): 79, x", 4)])
def test_writer_matches_the_reference(tmp_path, message, priority):
    ref_path, port_path = tmp_path / "ref", tmp_path / "port"
    assert RefWriter(str(ref_path)).write(message, priority) is None
    assert KmsgWriter(str(port_path)).write(message, priority) is None
    ref = ref_watcher.read_all(str(ref_path))
    got = watcher.read_all(str(port_path))
    assert [(m.priority, m.sequence, m.message) for m in got] == \
        [(m.priority, m.sequence, m.message) for m in ref]
    assert len(got[0].message) <= MAX_PRINTK_RECORD and "\n" not in got[0].message


def test_writer_numbers_its_records_and_reports_errors(tmp_path):
    w = KmsgWriter(str(tmp_path / "k"))
    for i in range(3):
        w.write(f"line {i}")
    assert [m.sequence for m in watcher.read_all(str(tmp_path / "k"))] == [1, 2, 3]
    assert KmsgWriter(str(tmp_path / "no" / "such" / "dir")).write("x") is not None


def test_writer_follows_the_env_setting(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUD_KMSG_FILE_PATH", str(tmp_path / "env"))
    assert KmsgWriter().path == str(tmp_path / "env")


class _GatedOs:
    """The ``os`` a watcher module sees, whose ``open`` on the reader thread
    waits for ``gate``: a reader thread the OS has not run yet."""

    def __init__(self, gate):
        self.gate = gate

    def __getattr__(self, name):
        import os
        return getattr(os, name)

    def open(self, *a, **k):
        import os
        import threading
        if threading.current_thread().name == "tpud-kmsg-watcher":
            assert self.gate.wait(30.0)
        return os.open(*a, **k)


@pytest.mark.parametrize("mod", [ref_watcher, watcher], ids=["ref", "port"])
def test_a_line_written_once_start_returns_is_delivered(mod, tmp_path, monkeypatch):
    # ROADMAP C6: the reference opens and seeks on the reader thread, so a
    # line written after start() but before that thread seeks is skipped;
    # the port opens and seeks in start(). The second line, written once
    # the reader follows the file (it asks for its inotify watch after the
    # seek), bounds the wait.
    import threading
    p = tmp_path / "kmsg"
    p.write_text("6,1,100,-;old line\n")
    gate, following, done = threading.Event(), threading.Event(), threading.Event()
    got = []
    monkeypatch.setattr(mod, "os", _GatedOs(gate))
    create = mod._InotifyWatch.create
    monkeypatch.setattr(mod._InotifyWatch, "create",
                        lambda path, *a: (following.set(), create(path, *a))[1])
    w = mod.Watcher(lambda m: (got.append(m.message), m.message == "second" and done.set()),
                    path=str(p), from_now=True)
    w.start()
    try:
        with open(p, "a") as f:
            f.write("3,2,200,-;first\n")
        gate.set()
        assert following.wait(30.0)
        with open(p, "a") as f:
            f.write("3,3,300,-;second\n")
        assert done.wait(30.0)
    finally:
        w.close()
    assert got == (["second"] if mod is ref_watcher else ["first", "second"])
