"""The spans and counters that a sweep of the port's fleet scan
(gpud_tpu_torch/fleet_scan.py) records in the trace ring: the tree of
``fleet_scan.*`` spans, the loader's row counts against counts taken
straight from the DBs, the bytes copied, the reader's blocks at the edges
of their first size against the reference's classes, the same spans as
profiler annotations on the trace's clock, and the CLI's ``--spans``."""

import json
import os
import sqlite3
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gpud_tpu import fleet_scan as jax_fs

from gpud_tpu_torch import cli as torch_cli
from gpud_tpu_torch import fleet_scan as torch_fs
from gpud_tpu_torch import snapshot_reader
from gpud_tpu_torch.components.gpu.nvlink_store import NVLinkStore
from gpud_tpu_torch.sqlite import DB
from gpud_tpu_torch.tracing import DEFAULT_TRACER

NOW = 1_700_000_000.0
WINDOW = 3600.0

SWEEP_TREE = [  # (name, parent's name), in start order, on one device
    ("fleet_scan.sweep", None),
    ("fleet_scan.load", "fleet_scan.sweep"),
    ("fleet_scan.pack", "fleet_scan.load"),
    ("fleet_scan.split", "fleet_scan.sweep"),
    ("fleet_scan.h2d", "fleet_scan.split"),
    ("fleet_scan.scan", "fleet_scan.split"),
    ("fleet_scan.classify", "fleet_scan.split"),
    ("fleet_scan.gather", "fleet_scan.split"),
    ("fleet_scan.assemble", "fleet_scan.sweep"),
]


def _host_db(path, links, samples, t0, step=60.0, seed=0):
    """``links`` links of ``samples`` snapshots each (or ``samples[k]`` for
    link k), ``step`` seconds apart from ``t0``; states up or down and
    rising CRC counters from ``seed``."""
    rng = np.random.default_rng(seed)
    db = DB(str(path))
    NVLinkStore(db)
    rows = []
    for k in range(links):
        n = samples[k] if isinstance(samples, list) else samples
        down = rng.random(n) < 0.1
        crc = np.cumsum(rng.integers(0, 40, n))
        rows += [(t0 + i * step, f"gpu{k // 18}/nvlink{k % 18}", int(not down[i]), int(crc[i]))
                 for i in range(n)]
    db.executemany(f"INSERT INTO {torch_fs.TABLE} (ts, link, state, crc_errors) "
                   "VALUES (?, ?, ?, ?)", rows)
    return db


def _tombstoned_fleet(tmp_path):
    """Three hosts, 90 minutes each (half before the window): a ``*``
    tombstone mid-window on one, a per-link one on another, none on the
    third."""
    paths = []
    for i, tomb in enumerate((("*", NOW - 1200), ("gpu0/nvlink3", NOW - 600), None)):
        path = tmp_path / f"host{i}.db"
        db = _host_db(path, links=20, samples=90, t0=NOW - 90 * 60 + 1, seed=i)
        if tomb:
            NVLinkStore(db).set_tombstone(*tomb)
        db.close()
        paths.append(str(path))
    return paths


def _counts_from_dbs(paths, start):
    """Rows in the window, and those a tombstone drops, by SQL alone."""
    fetched = dropped = 0
    for path in paths:
        conn = sqlite3.connect(path)
        try:
            q = f"FROM {torch_fs.TABLE} s WHERE s.ts >= ?"
            fetched += conn.execute(f"SELECT COUNT(*) {q}", (start,)).fetchone()[0]
            dropped += conn.execute(
                f"SELECT COUNT(*) {q} AND s.ts < MAX("
                f"COALESCE((SELECT ts FROM {torch_fs.TOMBSTONE_TABLE} WHERE link = '*'), 0),"
                f"COALESCE((SELECT ts FROM {torch_fs.TOMBSTONE_TABLE} t WHERE t.link = s.link), 0))",
                (start,)).fetchone()[0]
        finally:
            conn.close()
    return fetched, dropped


def _sweep(paths, monkeypatch=None, n_devices=1, **kw):
    """One sweep on the CPU; its spans, oldest first."""
    if n_devices > 1:
        monkeypatch.setattr(torch_fs, "_scan_devices",
                            lambda _d: [torch.device("cpu")] * n_devices)
    DEFAULT_TRACER.clear()
    res = torch_fs.fleet_scan(paths, window_seconds=WINDOW, now=NOW,
                              device=None if n_devices > 1 else "cpu", **kw)
    return res, _oldest_first()


def _oldest_first():
    # the ring holds spans as they close; ids are handed out as they open
    return sorted(DEFAULT_TRACER.snapshot(component=torch_fs.COMPONENT),
                  key=lambda s: s["span_id"])


def _attrs(spans, name):
    return next(s for s in spans if s["name"] == name).get("attrs", {})


LOAD_ATTRS = {"dbs", "rows_fetched", "rows_tombstoned", "rows_kept", "open_s", "fetch_s",
              "slowest_db", "slowest_db_s", "workers", "wait_s", "read_cpu_s",
              "opens_on_workers"}


def test_one_sweep_records_the_tree(tmp_path):
    paths = _tombstoned_fleet(tmp_path)
    res, spans = _sweep(paths)
    by_id = {s["span_id"]: s["name"] for s in spans}
    assert [(s["name"], by_id.get(s.get("parent_id"))) for s in spans] == SWEEP_TREE
    root = spans[0]
    assert "parent_id" not in root
    assert all(s["status"] == "ok" and s["component"] == "fleet_scan" for s in spans)
    assert _attrs(spans, "fleet_scan.sweep")["dbs"] == "3"
    assert _attrs(spans, "fleet_scan.sweep")["links"] == str(len(res["links"])) == "60"
    assert _attrs(spans, "fleet_scan.sweep")["devices"] == "1"
    assert float(_attrs(spans, "fleet_scan.sweep")["cpu_s"]) > 0
    # every child lies inside its parent on the wall clock
    by_span = {s["span_id"]: s for s in spans}
    for s in spans[1:]:
        p = by_span[s["parent_id"]]
        assert p["start_unix"] <= s["start_unix"]
        assert s["start_unix"] + s["duration_seconds"] <= (
            p["start_unix"] + p["duration_seconds"] + 1e-3)


def _cores(monkeypatch, n):
    """The loader sees ``n`` usable cores: as many workers, at most."""
    monkeypatch.setattr(os, "sched_getaffinity", lambda _pid: set(range(n)))


def test_loader_counters_equal_counts_from_the_dbs(tmp_path, monkeypatch):
    # one core: the DBs are read inline, one after another, so each part of
    # the loader lies inside its span (test_open_and_fetch_are_sums_over_the_dbs
    # holds them side by side)
    paths = _tombstoned_fleet(tmp_path)
    _cores(monkeypatch, 1)
    _res, spans = _sweep(paths)
    fetched, dropped = _counts_from_dbs(paths, NOW - WINDOW)
    load = _attrs(spans, "fleet_scan.load")
    assert dropped > 0 and fetched == 3 * 20 * 60
    assert int(load["rows_fetched"]) == fetched
    assert int(load["rows_tombstoned"]) == dropped
    assert int(load["rows_kept"]) == fetched - dropped
    assert load["dbs"] == "3"
    assert load["slowest_db"] in {"host0", "host1", "host2"}
    load_s = next(s for s in spans if s["name"] == "fleet_scan.load")["duration_seconds"]
    parts = [float(load[k]) for k in ("open_s", "fetch_s", "slowest_db_s")]
    assert all(0 < x < load_s for x in parts)
    assert float(load["open_s"]) + float(load["fetch_s"]) < load_s
    assert load["workers"] == "0" and load["opens_on_workers"] == "0"
    assert float(load["wait_s"]) == 0 and 0 < float(load["read_cpu_s"])
    assert set(load) == LOAD_ATTRS and len(load) == 12
    pack = _attrs(spans, "fleet_scan.pack")
    assert (pack["links"], pack["t_max"], pack["truncated"]) == ("60", "60", "0")


def _shared_host_fleet(tmp_path):
    """The tombstoned fleet, and host0 once more: a DB in another directory
    named host0.db (host ``host0-2``) and one named host0-2.db, which joins
    it. The last two are one host over two DBs."""
    paths = _tombstoned_fleet(tmp_path)
    for sub, name in (("b", "host0.db"), ("c", "host0-2.db")):
        (tmp_path / sub).mkdir()
        _host_db(tmp_path / sub / name, links=20, samples=90, t0=NOW - 90 * 60 + 1,
                 seed=len(paths)).close()
        paths.append(str(tmp_path / sub / name))
    return paths


@pytest.mark.parametrize("cores", [1, 2, 8])
def test_worker_counters_equal_counts_from_the_dbs(tmp_path, monkeypatch, cores):
    # workers: min(cores, DBs), 0 inline; the host over two DBs continues
    # one block over both; rows as the DBs count them
    paths = _shared_host_fleet(tmp_path)
    _cores(monkeypatch, cores)
    _res, spans = _sweep(paths)
    load = _attrs(spans, "fleet_scan.load")
    workers = min(cores, len(paths))
    assert load["workers"] == str(workers if workers > 1 else 0)
    assert load["opens_on_workers"] == ("5" if workers > 1 else "0")
    assert set(load) == LOAD_ATTRS
    assert load["dbs"] == "5"
    fetched, dropped = _counts_from_dbs(paths, NOW - WINDOW)
    assert (int(load["rows_fetched"]), int(load["rows_tombstoned"])) == (fetched, dropped)
    load_s = next(s for s in spans if s["name"] == "fleet_scan.load")["duration_seconds"]
    assert 0 <= float(load["wait_s"]) <= load_s
    assert (float(load["wait_s"]) == 0) == (workers < 2)
    assert float(load["read_cpu_s"]) > 0


def test_open_and_fetch_are_sums_over_the_dbs(tmp_path, monkeypatch):
    # four DBs of 86,400 rows each on four workers: the counters add each
    # DB's own seconds, so together they pass the load span, in which the
    # four reads overlap
    paths = []
    for i in range(4):
        _host_db(tmp_path / f"host{i}.db", links=144, samples=600, t0=NOW - 600 * 5,
                 step=5.0, seed=i).close()
        paths.append(str(tmp_path / f"host{i}.db"))
    _cores(monkeypatch, 4)
    _res, spans = _sweep(paths)
    load = _attrs(spans, "fleet_scan.load")
    load_s = next(s for s in spans if s["name"] == "fleet_scan.load")["duration_seconds"]
    opens, fetch = float(load["open_s"]), float(load["fetch_s"])
    assert (load["workers"], load["rows_fetched"]) == ("4", str(4 * 144 * 600))
    assert load_s < opens + fetch
    assert 0 < float(load["wait_s"]) <= load_s


def _load_wait_ms(n_sweeps=1):
    from fleetbench.metrics import load_wait_ms

    return load_wait_ms.read(SimpleNamespace(sweeps=n_sweeps))


@pytest.mark.parametrize("cores", [1, 4])
def test_load_wait_ms_reads_the_loader_s_wait(tmp_path, monkeypatch, cores):
    # the benchmark's reader: each sweep's wait_s in ms, averaged over the
    # window's sweeps, 0 where the DBs are read inline
    paths = _tombstoned_fleet(tmp_path)
    _cores(monkeypatch, cores)
    DEFAULT_TRACER.clear()
    for _ in range(2):
        torch_fs.fleet_scan(paths, window_seconds=WINDOW, now=NOW, device="cpu")
    loads = [s for s in _oldest_first() if s["name"] == "fleet_scan.load"]
    waits = [float(s["attrs"]["wait_s"]) for s in loads]
    assert len(waits) == 2 and all(0 <= w <= s["duration_seconds"] for w, s in zip(waits, loads))
    assert _load_wait_ms(2) == pytest.approx(sum(waits) / 2 * 1e3, rel=1e-9)
    assert _load_wait_ms(1) == pytest.approx(waits[-1] * 1e3, rel=1e-9)
    assert (_load_wait_ms(2) == 0) == (cores == 1)


def test_load_wait_ms_is_silent_without_the_counter(tmp_path, monkeypatch):
    # a program whose load span lacks wait_s, or that records no span,
    # leaves the metric out of the benchmark's line
    _sweep(_tombstoned_fleet(tmp_path))
    spans = DEFAULT_TRACER.snapshot(component=torch_fs.COMPONENT)
    for s in spans:
        s.get("attrs", {}).pop("wait_s", None)
    monkeypatch.setattr(DEFAULT_TRACER, "snapshot", lambda component=None: spans)
    assert _load_wait_ms() is None
    monkeypatch.setattr(DEFAULT_TRACER, "snapshot", lambda component=None: [])
    assert _load_wait_ms() is None


PAUSE_S = 0.05


def _slow(monkeypatch, name):
    """The reader's ``name`` call, each ``PAUSE_S`` slower."""
    real = getattr(snapshot_reader.SnapshotDB, name)

    def slow(*args, **kwargs):
        time.sleep(PAUSE_S)
        return real(*args, **kwargs)

    monkeypatch.setattr(snapshot_reader.SnapshotDB, name, slow)


def _slow_opens(monkeypatch, paths):
    # a tombstone whose name is not ASCII: the native read leaves the
    # tombstones to Python, which reads them on the sweeping thread
    for path in paths:
        db = DB(path)
        NVLinkStore(db).set_tombstone("gpu9/nvlink\u00e9", NOW - 60)
        db.close()
    _slow(monkeypatch, "tombstones")


def _slow_fetches(monkeypatch, paths):
    # a state stored as TEXT: the walk hands it to Python to convert and
    # goes on on the sweeping thread
    for path in paths:
        conn = sqlite3.connect(path)
        conn.execute(f"UPDATE {torch_fs.TABLE} SET state=CAST(state AS TEXT) "
                     f"WHERE rowid=(SELECT MAX(rowid) FROM {torch_fs.TABLE})")
        conn.commit()
        conn.close()
    _slow(monkeypatch, "finish")


def _slow_blocks(monkeypatch, paths):
    # the sweeping thread's own work a host: placing its block in the fleet
    real = torch_fs._place_block

    def place(*args):
        time.sleep(PAUSE_S)
        return real(*args)

    monkeypatch.setattr(torch_fs, "_place_block", place)


def _parts(spans):
    """The loader's four parts in seconds: opens, SQLite's calls (each
    summed over the DBs), the remainder (the sweeping thread's work a host,
    less the overlap of the DBs' reads) and the fleet's pack."""
    load = next(s for s in spans if s["name"] == "fleet_scan.load")
    pack = next(s for s in spans if s["name"] == "fleet_scan.pack")["duration_seconds"]
    opens, fetch = (float(load["attrs"][k]) for k in ("open_s", "fetch_s"))
    return {"open": opens, "fetch": fetch,
            "arrays": load["duration_seconds"] - opens - fetch - pack, "pack": pack}


@pytest.mark.parametrize("part, slow, pauses", [
    ("open", _slow_opens, 3),          # one tombstone read a DB
    ("fetch", _slow_fetches, 3),       # one walk's rest a DB
    ("arrays", _slow_blocks, 3),       # one block a host
])
def test_each_counter_times_its_own_part(tmp_path, monkeypatch, part, slow, pauses):
    # a pause planted in one part of the loader shows in that part alone;
    # read inline, one DB after another, so that the parts do not overlap
    paths = _tombstoned_fleet(tmp_path)
    _cores(monkeypatch, 1)
    slow(monkeypatch, paths)
    _res, spans = _sweep(paths)
    got = _parts(spans)
    assert got[part] >= pauses * PAUSE_S
    assert all(v < PAUSE_S for k, v in got.items() if k != part), got


def test_pack_span_counts_the_fleet_it_packs(tmp_path):
    # one host's links past the bound: the pack lists them and cuts T to it
    paths = _tombstoned_fleet(tmp_path)
    DEFAULT_TRACER.clear()
    names, states, _c, _v, truncated = torch_fs.load_fleet_history(
        paths, window_seconds=WINDOW, now=NOW, max_samples=45)
    spans = _oldest_first()
    # host0's '*' tombstone leaves 20 samples a link and host1's tombstone
    # 10 of gpu0/nvlink3; the other 39 links keep 60
    assert len(truncated) == 39 and states.shape == (60, 45)
    assert _attrs(spans, "fleet_scan.pack") == {"links": "60", "t_max": "45",
                                                "truncated": "39"}
    load = _attrs(spans, "fleet_scan.load")
    assert int(load["rows_kept"]) == 20 * 20 + 10 + 39 * 60


@pytest.mark.parametrize("n_devices", [1, 3])
def test_h2d_bytes_are_the_padded_layout(tmp_path, monkeypatch, n_devices):
    paths = _tombstoned_fleet(tmp_path)[:2]  # 40 links: 42 padded over 3
    _res, spans = _sweep(paths, monkeypatch, n_devices)
    L = 40 + (-40) % n_devices
    split = _attrs(spans, "fleet_scan.split")
    assert split == {"devices": str(n_devices), "h2d_bytes": str(L * 60 * 6)}
    h2d = [s for s in spans if s["name"] == "fleet_scan.h2d"]
    assert [int(s["attrs"]["bytes"]) for s in h2d] == [L // n_devices * 60 * 6] * n_devices
    scans = [s["attrs"] for s in spans if s["name"] == "fleet_scan.scan"]
    assert scans == [{"L": str(L // n_devices), "T": "60"}] * n_devices
    assert sum(s["name"] == "fleet_scan.classify" for s in spans) == n_devices
    assert sum(s["name"] == "fleet_scan.gather" for s in spans) == 1


# a block is first sized for 256 links of 64 samples
FIRST_LINKS, FIRST_T = 256, 64


@pytest.mark.parametrize("links, samples", [(16, [FIRST_T] * 15 + [FIRST_T + 1]),
                                            (FIRST_LINKS + 1, [3] * (FIRST_LINKS + 1))],
                         ids=["samples", "links"])
def test_batch_edges_give_the_reference_classes(tmp_path, links, samples):
    # all in the window, read in ts order into a block at its first size: it
    # grows for the newest sweep's one sample past its first samples, or for
    # the one link past its first rows
    rows = sum(samples)
    step = WINDOW / 2 / max(samples)
    _host_db(tmp_path / "h.db", links, samples, t0=NOW - max(samples) * step, step=step).close()
    paths = [str(tmp_path / "h.db")]
    ref = jax_fs.fleet_scan(paths, window_seconds=WINDOW, now=NOW)
    got, spans = _sweep(paths)
    for key in ("links", "summary", "truncated_links"):
        assert got[key] == ref[key], key
    assert set(got["summary"].values()) != {0} and len(got["links"]) == links
    assert _attrs(spans, "fleet_scan.load")["rows_fetched"] == str(rows)


def test_spans_are_profiler_annotations_on_the_trace_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    paths = _tombstoned_fleet(tmp_path)
    DEFAULT_TRACER.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch_fs.fleet_scan(paths, window_seconds=WINDOW, now=NOW, device="cpu")
    spans = _oldest_first()
    trace = tmp_path / "trace.json"
    prof.export_chrome_trace(str(trace))
    doc = json.loads(trace.read_text())
    base_us = doc["baseTimeNanoseconds"] / 1e3
    notes = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in doc["traceEvents"]
             if e.get("cat") == "user_annotation" and e["name"].startswith("fleet_scan.")}
    assert set(notes) == {name for name, _p in SWEEP_TREE}
    by_id = {s["span_id"]: s["name"] for s in spans}
    for s in spans:
        a0, a1 = notes[s["name"]]
        assert abs((base_us + a0) / 1e6 - s["start_unix"]) < 0.1, s["name"]
        parent = by_id.get(s.get("parent_id"))
        if parent:  # nested as the spans are
            p0, p1 = notes[parent]
            assert p0 <= a0 and a1 <= p1, s["name"]


def test_no_annotation_without_a_profiler(tmp_path, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    real, entered = torch.profiler.record_function, []

    def counting(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    paths = _tombstoned_fleet(tmp_path)
    torch_fs.fleet_scan(paths, window_seconds=WINDOW, now=NOW, device="cpu")
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        torch_fs.fleet_scan(paths, window_seconds=WINDOW, now=NOW, device="cpu")
    assert entered == [name for name, _p in SWEEP_TREE]


def test_cli_spans_prints_the_sweep_on_stderr(tmp_path, capsys):
    paths = _tombstoned_fleet(tmp_path)
    argv = ["fleet-scan", "--device", "cpu", "--window", "1e9", *paths]
    rc_plain = torch_cli.main(argv)
    plain = capsys.readouterr()
    rc = torch_cli.main([*argv, "--spans"])
    got = capsys.readouterr()
    assert (rc, got.out) == (rc_plain, plain.out)
    assert plain.err == ""
    lines = got.err.strip().splitlines()
    assert len(lines) == 1
    spans = json.loads(lines[0])
    assert [s["name"] for s in spans] == [name for name, _p in SWEEP_TREE]
    assert [s["start_unix"] for s in spans] == sorted(s["start_unix"] for s in spans)
    assert spans[1]["attrs"]["rows_fetched"] == str(3 * 20 * 90)
