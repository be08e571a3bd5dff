"""The port's fleet-scan loader (gpud_tpu_torch/fleet_scan.py
``load_fleet_history``) on the store's own schema: its query walks the
window on the ``(ts)`` index whatever depth the DB holds, and it holds no
Python object per row (its arrays equal the reference's in
tests/test_torch_fleet_scan.py)."""

import sqlite3
import tracemalloc

import numpy as np
import pytest

from gpud_tpu_torch import fleet_scan as torch_fs
from gpud_tpu_torch.components.gpu.nvlink_store import NVLinkStore
from gpud_tpu_torch.sqlite import DB

NOW = 1_700_000_000.0
TABLE = torch_fs.TABLE


def _host_db(path, links, minutes, seed=0):
    """``links`` NVLink links of an 8-GPU host, one snapshot a minute for
    ``minutes`` up to NOW, written sweep by sweep as the daemon writes."""
    rng = np.random.default_rng(seed)
    db = DB(str(path))
    NVLinkStore(db)
    names = [f"gpu{k // 18}/nvlink{k % 18}" for k in range(links)]
    ts = NOW - 60 * np.arange(minutes, 0, -1) + 1
    crc = np.cumsum(rng.integers(0, 40, (minutes, links)), axis=0)
    up = (rng.random((minutes, links)) > 0.01).astype(int)
    db.executemany(f"INSERT INTO {TABLE} (ts, link, state, crc_errors) VALUES (?, ?, ?, ?)",
                   zip(np.repeat(ts, links).tolist(), names * minutes,
                       up.ravel().tolist(), crc.ravel().tolist()))
    db.close()
    return str(path)


@pytest.mark.parametrize("analyzed", [False, True], ids=["no_stats", "analyzed"])
def test_query_walks_only_the_window_on_the_ts_index(tmp_path, analyzed):
    # a day stored, an hour asked for: the plan must search the (ts) index
    # from the window's start and sort nothing
    path = _host_db(tmp_path / "h.db", links=36, minutes=24 * 60)
    conn = sqlite3.connect(path)
    try:
        if analyzed:
            conn.execute("ANALYZE")
        plan = [row[-1] for row in conn.execute("EXPLAIN QUERY PLAN " + torch_fs.QUERY,
                                                (NOW - 3600,))]
    finally:
        conn.close()
    assert any(f"USING INDEX idx_{TABLE}_ts (ts>?)" in step and step.startswith("SEARCH")
               for step in plan), plan
    assert not any("TEMP B-TREE" in step for step in plan), plan


# bytes the loader may hold per row fetched, besides its output arrays and
# one batch's row tuples; a loader that keeps a Python object per row holds
# some 95 B a row
BYTES_PER_ROW = 32
BATCH_ROW_BYTES = 600


def test_loader_holds_no_python_object_per_row(tmp_path):
    hosts, links, minutes = 4, 144, 240
    paths = [_host_db(tmp_path / f"host{h}.db", links, minutes, seed=h) for h in range(hosts)]
    tracemalloc.start()
    try:
        names, *arrays, truncated = torch_fs.load_fleet_history(
            paths, window_seconds=minutes * 60, now=NOW)
        _now, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    rows = hosts * links * minutes
    assert len(names) == hosts * links and arrays[0].shape == (hosts * links, minutes)
    assert int(arrays[2].sum()) == rows and truncated == []
    out = sum(a.nbytes for a in arrays)
    assert peak <= out + BYTES_PER_ROW * rows + BATCH_ROW_BYTES * torch_fs.FETCH_ROWS, (
        peak, out, rows)
