"""The link store's on-disk schema and a bulk writer for generated hosts.

The DDL is a frozen copy of the NVLink store's (the daemon's
``tpud_ici_snapshots_v0_1`` with its ``(link, ts)`` and ``(ts)`` indexes, and
``tpud_ici_tombstones_v0_1``), so the files written here are what a host's
daemon leaves on disk. Rows go in sweep by sweep, every link of one snapshot
under one timestamp, into a table whose indexes already exist, as the
daemon inserts them: the indexes grow one row at a time, with the page
layout that gives. ``write_host_file`` writes the same file from memory.
"""

from __future__ import annotations

import sqlite3
from typing import Dict, Optional

import numpy as np

TABLE = "tpud_ici_snapshots_v0_1"
TOMBSTONE_TABLE = "tpud_ici_tombstones_v0_1"

DDL = (
    f"""CREATE TABLE IF NOT EXISTS {TABLE} (
        ts REAL NOT NULL,
        link TEXT NOT NULL,
        state INTEGER NOT NULL,
        tx_bytes INTEGER NOT NULL DEFAULT 0,
        rx_bytes INTEGER NOT NULL DEFAULT 0,
        tx_errors INTEGER NOT NULL DEFAULT 0,
        rx_errors INTEGER NOT NULL DEFAULT 0,
        crc_errors INTEGER NOT NULL DEFAULT 0,
        replays INTEGER NOT NULL DEFAULT 0
    )""",
    f"CREATE TABLE IF NOT EXISTS {TOMBSTONE_TABLE} "
    "(link TEXT PRIMARY KEY, ts REAL NOT NULL)",
    f"CREATE INDEX IF NOT EXISTS idx_{TABLE}_link_ts ON {TABLE} (link, ts)",
    f"CREATE INDEX IF NOT EXISTS idx_{TABLE}_ts ON {TABLE} (ts)",
)


def _fill(conn, links: list, ts: np.ndarray, states: np.ndarray, crc: np.ndarray,
          tombstones: Dict[str, float], cache_kib: Optional[int] = None) -> int:
    n_links, n_sweeps = states.shape
    conn.execute("PRAGMA journal_mode=OFF")
    conn.execute("PRAGMA synchronous=OFF")
    if cache_kib:
        conn.execute(f"PRAGMA cache_size=-{int(cache_kib)}")
    for ddl in DDL:
        conn.execute(ddl)
    # sweep-major: row r is link r % n_links of sweep r // n_links
    conn.executemany(
        f"INSERT INTO {TABLE} (ts, link, state, crc_errors) VALUES (?,?,?,?)",
        zip(np.repeat(ts, n_links).tolist(), links * n_sweeps,
            states.T.ravel().tolist(), crc.T.ravel().tolist()),
    )
    conn.executemany(
        f"INSERT INTO {TOMBSTONE_TABLE} (link, ts) VALUES (?, ?)",
        sorted(tombstones.items()),
    )
    conn.commit()
    return n_links * n_sweeps


def write_host_db(path: str, links: list, ts: np.ndarray, states: np.ndarray,
                  crc: np.ndarray, tombstones: Dict[str, float],
                  cache_kib: Optional[int] = None) -> int:
    """Write one host's DB, or append to the DB at ``path``: ``states`` and
    ``crc`` are [links, sweeps] and ``ts`` the sweeps' times. A page cache
    of ``cache_kib`` changes how often pages are written, not what is
    written. Returns the number of snapshot rows."""
    conn = sqlite3.connect(path)
    try:
        return _fill(conn, links, ts, states, crc, tombstones, cache_kib)
    finally:
        conn.close()


def write_host_file(path: str, links: list, ts: np.ndarray, states: np.ndarray,
                    crc: np.ndarray, tombstones: Dict[str, float]) -> int:
    """The new file ``write_host_db`` would write at ``path``, byte for byte:
    the same statements into a DB held in memory by SQLite's ``memdb``
    file system, which the pager treats as a file, then its bytes written
    to ``path`` at once: one write in place of one a page, where each write
    is a round trip to the file system (as on a 9p mount). Returns the
    number of snapshot rows."""
    conn = sqlite3.connect("file:host?vfs=memdb", uri=True)  # private to the connection
    try:
        rows = _fill(conn, links, ts, states, crc, tombstones)
        data = conn.serialize()
    finally:
        conn.close()
    with open(path, "xb") as f:
        f.write(data)
    return rows
