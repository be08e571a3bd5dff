"""Durable per-link fabric matrix history (SQLite via the shared writer); the
port of ``gpud_tpu/fabric/store.py``.

One row per (sweep, link): the ``(src_chip, dst_chip, axis, latency,
state)`` tuple, plus the EWMA deviation the sweep computed against that
link's baseline; on a GPU host ``src_chip`` is the GPU, ``dst_chip`` -1
(the NVSwitch side) and ``axis`` ``nvlink`` (fabric/mesh.py). The table
and its indexes are the reference's, column for column. The latest sweep
is served from the plane's in-memory matrix; this table answers history
questions ("when did gpu1/nvlink4 last degrade") and survives restarts. Retention is
time-based via ``purge`` wired into the server's retention job.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

TABLE = "tpud_fabric_matrix_v0_1"

_INSERT_SQL = (
    f"INSERT INTO {TABLE} "
    "(ts, link, src_chip, dst_chip, axis, state, latency_seconds, deviation) "
    "VALUES (?, ?, ?, ?, ?, ?, ?, ?)"
)


class FabricMatrixStore:
    """Append-only sweep matrix rows + time-retained history reads.

    Writes route through the shared ``BatchWriter`` (group commit with
    the event/health stores) when one is wired; the sync ``executemany``
    fallback keeps the store usable standalone (tests, tools). SQLite
    serializes access, so no lock is held here.
    """

    def __init__(self, db, writer=None, time_now_fn=None) -> None:
        self.db = db
        self.writer = writer
        self.time_now_fn = time_now_fn or time.time
        self.db.execute(
            f"""CREATE TABLE IF NOT EXISTS {TABLE} (
                ts              REAL NOT NULL,
                link            TEXT NOT NULL,
                src_chip        INTEGER NOT NULL,
                dst_chip        INTEGER NOT NULL,
                axis            TEXT NOT NULL,
                state           TEXT NOT NULL,
                latency_seconds REAL NOT NULL DEFAULT 0,
                deviation       REAL NOT NULL DEFAULT 0
            )"""
        )
        self.db.execute(
            f"CREATE INDEX IF NOT EXISTS idx_fabric_link_ts "
            f"ON {TABLE} (link, ts)"
        )
        self.db.execute(
            f"CREATE INDEX IF NOT EXISTS idx_fabric_ts ON {TABLE} (ts)"
        )

    def insert_sweep(self, rows: List[Dict], ts: Optional[float] = None) -> int:
        """Record one sweep's matrix rows (dicts in the matrix() shape)."""
        if not rows:
            return 0
        when = self.time_now_fn() if ts is None else ts
        params = [
            (
                float(r.get("ts", when) or when),
                str(r["link"]),
                int(r.get("src_chip", -1)),
                int(r.get("dst_chip", -1)),
                str(r.get("axis", "")),
                str(r.get("state", "")),
                float(r.get("latency_seconds", 0.0) or 0.0),
                float(r.get("deviation", 0.0) or 0.0),
            )
            for r in rows
        ]
        if self.writer is not None:
            self.writer.submit_many("fabric", _INSERT_SQL, params)
        else:
            self.db.executemany(_INSERT_SQL, params)
        return len(params)

    def _barrier(self) -> None:
        """Read-after-write: a history question right after a sweep must
        see that sweep's rows (no-pending fast path is one lock)."""
        if self.writer is not None:
            self.writer.flush()

    def history(
        self, link: str = "", since: float = 0.0, limit: int = 256
    ) -> List[Dict]:
        """Matrix rows newest-first, optionally one link / since a ts."""
        self._barrier()
        limit = max(1, min(10_000, int(limit)))
        where = ["ts >= ?"]
        args: list = [float(since)]
        if link:
            where.append("link = ?")
            args.append(str(link))
        args.append(limit)
        rows = self.db.query(
            f"SELECT ts, link, src_chip, dst_chip, axis, state, "
            f"latency_seconds, deviation FROM {TABLE} "
            f"WHERE {' AND '.join(where)} ORDER BY ts DESC LIMIT ?",
            tuple(args),
        )
        return [
            {
                "ts": ts,
                "link": lnk,
                "src_chip": src,
                "dst_chip": dst,
                "axis": axis,
                "state": state,
                "latency_seconds": lat,
                "deviation": dev,
            }
            for ts, lnk, src, dst, axis, state, lat, dev in rows
        ]

    def row_count(self) -> int:
        self._barrier()
        row = self.db.query_one(f"SELECT COUNT(*) FROM {TABLE}")
        return int(row[0]) if row else 0

    def purge(self, before: Optional[float] = None) -> int:
        """Drop rows older than ``before`` (retention job hook)."""
        self._barrier()
        cutoff = self.time_now_fn() if before is None else float(before)
        return self.db.execute(
            f"DELETE FROM {TABLE} WHERE ts < ?", (cutoff,)
        ).rowcount
