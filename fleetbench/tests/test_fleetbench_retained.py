"""Host DBs at the store's retained depth, and the reference's margin read.

A configuration without ``store_retention_seconds`` is written as before;
one with it gets the aged template beneath each host's generated rows, and
the port sweeps those DBs as the reference does. At 4 hosts on the CPU, the
store cut to one day with its purge scaled to it."""

import os
import sqlite3

import numpy as np
import pytest

from conftest import cpu_run, small_cell

from fleetbench import control, harness, retained
from fleetbench.reference import fleet as reference
from fleetbench.store import TABLE, TOMBSTONE_TABLE, write_host_db

SEED = 2**31 + 29
DAY = {"store_retention_seconds": 86400, "store_purge_interval_seconds": 17280,
       "store_last_purge_age_seconds": 8640}


def retained_cell(hosts=4):
    cell = small_cell("su-hour-retained", hosts)
    cell.config = dict(cell.config, **DAY)
    return cell


def fleet_of(cell, seed=SEED):
    return cell.generator.generate(cell.config, cell.traffic, seed, harness.NOW)


def rows(path, where=""):
    conn = sqlite3.connect(path)
    try:
        return (conn.execute(f"SELECT rowid, * FROM {TABLE} {where} ORDER BY rowid").fetchall(),
                conn.execute(f"SELECT * FROM {TOMBSTONE_TABLE} ORDER BY link").fetchall())
    finally:
        conn.close()


def test_without_the_key_the_dbs_are_written_as_before(tmp_path):
    cell = small_cell("su-hour", hosts=4)
    assert "store_retention_seconds" not in cell.config
    fleet = fleet_of(cell)
    (tmp_path / "new").mkdir()
    (tmp_path / "old").mkdir()
    paths, store = harness.write_fleet(fleet, str(tmp_path / "new"), cell.config)
    assert store == {"rows_stored": fleet.rows_stored,
                     "db_bytes": sum(os.path.getsize(p) for p in paths)}
    for host, path in zip(fleet.hosts, paths):
        old = str(tmp_path / "old" / f"{host.name}.db")
        write_host_db(old, host.links, host.ts, host.states, host.crc, host.tombstones)
        assert rows(path) == rows(old)
        with open(path, "rb") as a, open(old, "rb") as b:
            assert a.read() == b.read()


def test_the_published_depth():
    """14 days at retention, a purge each 2.8 days, the last at half of it:
    every DB holds at least the 14 days' 2,903,040 rows."""
    cell = small_cell("su-hour-retained", hosts=None)
    fleet = fleet_of(cell)
    plan = retained.schedule(cell.config, max(h.ts[0] for h in fleet.hosts), harness.NOW)
    assert cell.config["store_purge_interval_seconds"] * 5 == cell.config["store_retention_seconds"]
    assert plan["kept"] * 144 == 3_176_208 and plan["written"] * 144 == 3_756_816
    assert plan["kept"] * 144 + 120 * 144 >= 14 * 1440 * 144
    days = (harness.NOW - plan["oldest"]) / 86400
    assert 14.0 <= days < 16.8


def test_the_template_is_the_daemon_s_history(tmp_path):
    cell = retained_cell()
    fleet = fleet_of(cell)
    first_slot = max(h.ts[0] for h in fleet.hosts)
    plan = retained.schedule(cell.config, first_slot, harness.NOW)
    links = fleet.hosts[0].links
    path = str(tmp_path / "template.db")
    retained.write_template(path, links, plan)
    got, tombs = rows(path)
    assert tombs == []
    rowid, ts, link = (np.array([r[i] for r in got]) for i in (0, 1, 2))
    # the purge deleted the rows before its cutoff; later rows took new rowids
    deleted = (plan["written"] - plan["kept"]) * len(links)
    assert len(got) == plan["kept"] * len(links) and rowid[0] == deleted + 1
    assert np.array_equal(rowid, np.arange(deleted + 1, deleted + 1 + len(got)))
    # snapshot by snapshot, each in the host's link order, a sweep interval apart
    n = len(links)
    assert (link.reshape(-1, n) == np.array(links)).all()
    assert (ts.reshape(-1, n) == ts[::n, None]).all()
    assert np.array_equal(np.diff(ts[::n]), np.full(plan["kept"] - 1, 60.0))
    assert ts[0] == plan["oldest"] >= plan["cutoff"] and ts[-1] == first_slot - 60
    assert all(r[3:] == (1, 0, 0, 0, 0, 0, 0) for r in got)  # up, every counter 0
    # the store holds from its retention to its retention plus a purge interval
    held = harness.NOW - ts[0]
    assert DAY["store_retention_seconds"] <= held < (DAY["store_retention_seconds"]
                                                     + DAY["store_purge_interval_seconds"])
    conn = sqlite3.connect(path)
    try:  # the rest of the freed pages wait on the free list
        assert conn.execute("PRAGMA freelist_count").fetchone()[0] > 0
    finally:
        conn.close()


def test_an_append_s_page_cache_changes_no_byte(tmp_path):
    cell = retained_cell()
    fleet = fleet_of(cell)
    plan = retained.schedule(cell.config, max(h.ts[0] for h in fleet.hosts), harness.NOW)
    retained.write_template(str(tmp_path / "template.db"), fleet.hosts[0].links, plan)
    got = []
    for cache_kib in (None, retained.APPEND_CACHE_KIB):
        path = tmp_path / f"host-{cache_kib}.db"
        path.write_bytes((tmp_path / "template.db").read_bytes())
        h = fleet.hosts[1]
        write_host_db(str(path), h.links, h.ts, h.states, h.crc, h.tombstones, cache_kib)
        got.append(path.read_bytes())
    assert got[0] == got[1]


def test_a_purge_on_the_generated_rows_is_refused():
    cell = retained_cell()
    fleet = fleet_of(cell)
    with pytest.raises(ValueError, match="store_last_purge_age_seconds"):
        retained.schedule(dict(cell.config, store_last_purge_age_seconds=7200),
                          max(h.ts[0] for h in fleet.hosts), harness.NOW)


def test_each_db_is_the_template_then_the_host_s_rows(tmp_path):
    cell = retained_cell()
    fleet = fleet_of(cell)
    (tmp_path / "deep").mkdir()
    (tmp_path / "flat").mkdir()
    marks = {}
    paths, store = harness.write_fleet(fleet, str(tmp_path / "deep"), cell.config, marks)
    assert list(marks) == ["template", "copied", "written"]
    assert sorted(os.listdir(tmp_path / "deep")) == sorted(f"{h.name}.db" for h in fleet.hosts)
    assert store["db_bytes"] == sum(os.path.getsize(p) for p in paths)
    assert store["rows_stored"] == fleet.rows_stored + 4 * store["template_rows"]
    for host, path in zip(fleet.hosts, paths):
        flat = str(tmp_path / "flat" / f"{host.name}.db")
        write_host_db(flat, host.links, host.ts, host.states, host.crc, host.tombstones)
        since = f"WHERE ts >= {float(host.ts[0])!r}"
        (deep, deep_tombs), (gen, gen_tombs) = rows(path, since), rows(flat)
        # the host's rows, in the same order, after the template's
        assert [r[1:] for r in deep] == [r[1:] for r in gen] and deep_tombs == gen_tombs
        assert deep[0][0] == store["template_rows_written"] + 1
        older, _ = rows(path, f"WHERE ts < {float(host.ts[0])!r}")
        assert len(older) == store["template_rows"]
        assert len(older) + len(deep) >= store["rows_per_db_min"]


def test_the_port_sweeps_a_retained_store_as_the_reference(cpu_program, tmp_path):
    cell = retained_cell()
    out = cpu_run(cell, tmp_path, seed=SEED + 1)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert all(c["value"] == 0 == c["limit"] for c in out["checks"].values())
    info = out["run"].info
    assert info["dbs"] == 4 and info["template_rows"] == 1465 * 144
    assert info["rows_stored"] == out["run"].fleet.rows_stored + 4 * info["template_rows"]
    assert {"template", "copied", "written"} <= set(info["setup_marks_s"])


@pytest.mark.parametrize("name", control.VARIANTS)
def test_every_fault_fails_on_a_retained_store(cpu_program, name):
    (row,) = control.run_variants(retained_cell(), [2**32 + 11], 0.2, [name])
    assert not row["correct"] and row["failed"] == row["attempted"] >= 1
    assert row["checks"]["wrong_links"] > 0


NOW = 1_000_000.0


def _edge_db(path):
    """Twenty samples a minute apart, the newest 0 s old: one lies exactly on
    the window's start, and is down."""
    ts = NOW - 60.0 * np.arange(19, -1, -1)
    states = np.ones(20, dtype=np.int8)
    states[10] = 0
    write_host_db(path, ["gpu0/nvlink0"], ts, states[None, :],
                  np.full((1, 20), 1000, dtype=np.int64), {})
    return ts


@pytest.mark.parametrize("margin", [0.0, 60.0, 3600.0])
def test_the_margin_read_keeps_the_sample_on_the_window_s_start(tmp_path, margin):
    path = str(tmp_path / "host.db")
    ts = _edge_db(path)
    assert ts[10] == NOW - 540.0  # the window's start, at 540 s
    full = reference.sweep([path], 540.0, NOW)
    assert full["links"] == {"host/gpu0/nvlink0": "degraded"}
    assert reference.sweep([path], 540.0, NOW, margin_seconds=margin) == full
    got, _tombs = reference._read_host(path, NOW - 540.0 - margin)
    assert sorted(r[1] for r in got) == [t for t in ts.tolist() if t >= NOW - 540.0 - margin]


@pytest.mark.parametrize("workload", ["su-hour", "su-shift"])
def test_the_margin_read_gives_the_full_read_s_answer(tmp_path, workload):
    cell = small_cell(workload, hosts=4)
    fleet = fleet_of(cell)
    paths, _store = harness.write_fleet(fleet, str(tmp_path), cell.config)
    window = float(cell.traffic["window_seconds"])
    margin = cell.config["history_before_window_seconds"]
    # the margin keeps every stored row of these cells
    assert min(h.ts[0] for h in fleet.hosts) >= harness.NOW - window - margin
    full = reference.sweep(paths, window, harness.NOW)
    assert reference.sweep(paths, window, harness.NOW, margin_seconds=margin) == full
    assert sum(full["summary"].values()) == fleet.links_total
