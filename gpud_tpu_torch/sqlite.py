"""SQLite helpers.

Reference: pkg/sqlite/sqlite.go:70-130 — read-write/read-only connection
pair, WAL-ish pragmas, Compact (VACUUM), DB-size reader. The reference uses
cgo go-sqlite3; here we use CPython's built-in ``sqlite3`` (the same C
SQLite library underneath — the equivalent native component, per SURVEY §2.7).

Connections are per-thread via a small pool keyed on thread id, since the
daemon checks run on many poller threads.
"""

from __future__ import annotations

import os
import sqlite3
import threading
import time
from typing import Any, Iterable, Optional, Tuple

from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.metrics.registry import histogram
from gpud_tpu_torch.tracing import DEFAULT_TRACER

logger = get_logger(__name__)


class _NullLock:
    """No-op context manager for the file-backed (per-thread conn) path."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_LOCK = _NullLock()

# self-observability counters (reference: pkg/metrics/recorder/gpud_metrics.go:14-60)
_stats_mu = threading.Lock()
_stats = {
    "select_total": 0,
    "select_seconds": 0.0,
    "insert_update_delete_total": 0,
    "insert_update_delete_seconds": 0.0,
    "vacuum_total": 0,
    "vacuum_seconds": 0.0,
}

# per-query latency distribution — the totals above say how much time sqlite
# ate overall; the histogram says whether it was many fast queries or a few
# stalls (WAL contention, checkpointing, a cold VACUUM)
_h_query = histogram(
    "tpud_sqlite_query_duration_seconds",
    "SQLite query latency by operation kind (select|insert_update_delete|vacuum)",
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
             0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0),
)


def stats() -> dict:
    with _stats_mu:
        return dict(_stats)


def _record(kind: str, seconds: float) -> None:
    with _stats_mu:
        _stats[f"{kind}_total"] += 1
        _stats[f"{kind}_seconds"] += seconds
    _h_query.observe(seconds, {"op": kind})
    # trace only as a child: standalone queries at scrape cadence would
    # flood the ring, but inside a slow check/dispatch span the sqlite leaf
    # is exactly the breakdown the debugger wants
    DEFAULT_TRACER.record(
        f"sqlite.{kind}",
        seconds,
        component="sqlite",
        parent_required=True,
    )


class DB:
    """Thread-safe SQLite handle with per-thread connections.

    ``read_only=True`` opens with mode=ro the way the reference keeps an RO
    connection alongside the RW one (reference: pkg/server/server.go:132-154).
    """

    def __init__(self, path: str, read_only: bool = False) -> None:
        self.path = path
        self.read_only = read_only
        self._local = threading.local()
        self._in_memory = path == ":memory:"
        self._mem_conn: Optional[sqlite3.Connection] = None
        self._mem_lock = threading.Lock()
        if not self._in_memory:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)

    def _connect(self) -> sqlite3.Connection:
        if self._in_memory:
            # a single shared in-memory connection (with a lock) so all
            # threads see the same data (--db-in-memory mode,
            # reference: server.go:132-154)
            with self._mem_lock:
                if self._mem_conn is None:
                    self._mem_conn = sqlite3.connect(
                        ":memory:", check_same_thread=False
                    )
                    self._apply_pragmas(self._mem_conn)
                return self._mem_conn
        conn = getattr(self._local, "conn", None)
        if conn is None:
            if self.read_only:
                uri = f"file:{self.path}?mode=ro"
                conn = sqlite3.connect(uri, uri=True, timeout=10.0)
            else:
                conn = sqlite3.connect(self.path, timeout=10.0)
                self._apply_pragmas(conn)
            self._local.conn = conn
        return conn

    @staticmethod
    def _apply_pragmas(conn: sqlite3.Connection) -> None:
        # WAL + normal sync: the low-footprint write path
        # (reference: pkg/sqlite/sqlite.go:70 connection-string options)
        try:
            conn.execute("PRAGMA journal_mode=WAL")
        except sqlite3.OperationalError:
            pass
        conn.execute("PRAGMA synchronous=NORMAL")
        conn.execute("PRAGMA busy_timeout=10000")

    # -- query API ---------------------------------------------------------
    def execute(self, sql: str, params: Iterable[Any] = ()) -> sqlite3.Cursor:
        conn = self._connect()
        t0 = time.monotonic()
        if self._in_memory:
            with self._mem_lock:
                cur = conn.execute(sql, tuple(params))
                conn.commit()
        else:
            cur = conn.execute(sql, tuple(params))
            conn.commit()
        _record("insert_update_delete", time.monotonic() - t0)
        return cur

    def executemany(self, sql: str, seq) -> None:
        conn = self._connect()
        t0 = time.monotonic()
        if self._in_memory:
            with self._mem_lock:
                conn.executemany(sql, seq)
                conn.commit()
        else:
            conn.executemany(sql, seq)
            conn.commit()
        _record("insert_update_delete", time.monotonic() - t0)

    def run_batch(
        self,
        groups: Iterable[Tuple[str, list]],
        fsync: bool = False,
    ) -> int:
        """Group commit: every (sql, params_list) group in ONE transaction.

        This is the write-behind layer's drain path — the whole flush
        window becomes a single WAL append instead of one commit per row.
        ``fsync=True`` upgrades just this commit to ``synchronous=FULL``
        (one fsync per batch: group-commit durability without paying a
        per-row fsync anywhere else). Atomic: on error the transaction
        rolls back and no group is applied. Returns rows written.
        """
        conn = self._connect()
        t0 = time.monotonic()
        n = 0
        lock = self._mem_lock if self._in_memory else _NULL_LOCK
        with lock:
            if fsync and not self._in_memory:
                conn.execute("PRAGMA synchronous=FULL")
            try:
                for sql, params_list in groups:
                    if not params_list:
                        continue
                    conn.executemany(sql, params_list)
                    n += len(params_list)
                conn.commit()
            except Exception:
                conn.rollback()
                raise
            finally:
                if fsync and not self._in_memory:
                    conn.execute("PRAGMA synchronous=NORMAL")
        _record("insert_update_delete", time.monotonic() - t0)
        return n

    def query(self, sql: str, params: Iterable[Any] = ()) -> list:
        conn = self._connect()
        t0 = time.monotonic()
        if self._in_memory:
            with self._mem_lock:
                rows = conn.execute(sql, tuple(params)).fetchall()
        else:
            rows = conn.execute(sql, tuple(params)).fetchall()
        _record("select", time.monotonic() - t0)
        return rows

    def query_one(self, sql: str, params: Iterable[Any] = ()) -> Optional[Tuple]:
        rows = self.query(sql, params)
        return rows[0] if rows else None

    # -- maintenance -------------------------------------------------------
    def compact(self) -> float:
        """VACUUM (reference: pkg/sqlite/sqlite.go:100 Compact). Returns seconds."""
        conn = self._connect()
        t0 = time.monotonic()
        if self._in_memory:
            with self._mem_lock:
                conn.execute("VACUUM")
        else:
            conn.execute("VACUUM")
        dt = time.monotonic() - t0
        _record("vacuum", dt)
        return dt

    def size_bytes(self) -> int:
        """Reference: pkg/sqlite/sqlite.go:123 DB-size reader."""
        row = self.query_one(
            "SELECT page_count * page_size FROM pragma_page_count(), pragma_page_size()"
        )
        return int(row[0]) if row else 0

    def wal_size_bytes(self) -> int:
        """Size of the sidecar ``-wal`` file (0 when absent / in-memory)."""
        if self._in_memory:
            return 0
        try:
            return os.stat(self.path + "-wal").st_size
        except OSError:
            return 0

    def wal_checkpoint(self, mode: str = "TRUNCATE") -> Tuple[int, int, int]:
        """Run ``PRAGMA wal_checkpoint(mode)``; returns (busy, log_pages,
        checkpointed_pages) — SQLite's own result row. No-op (0, -1, -1)
        for in-memory databases, which have no WAL."""
        if mode not in ("PASSIVE", "FULL", "RESTART", "TRUNCATE"):
            raise ValueError(f"bad wal_checkpoint mode: {mode!r}")
        if self._in_memory:
            return (0, -1, -1)
        conn = self._connect()
        t0 = time.monotonic()
        row = conn.execute(f"PRAGMA wal_checkpoint({mode})").fetchone()
        _record("vacuum", time.monotonic() - t0)
        return (int(row[0]), int(row[1]), int(row[2])) if row else (0, -1, -1)

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None
        if self._mem_conn is not None and self._in_memory:
            # keep in-memory conn alive until explicit close of the DB object
            with self._mem_lock:
                self._mem_conn.close()
                self._mem_conn = None


def open_rw_ro(path: str) -> Tuple[DB, DB]:
    """Open the RW+RO pair (reference: pkg/server/server.go:132-154).
    For in-memory mode both handles are the same shared connection."""
    rw = DB(path, read_only=False)
    if path == ":memory:":
        return rw, rw
    # make sure the file exists before an RO open
    rw.execute("SELECT 1")
    ro = DB(path, read_only=True)
    return rw, ro
