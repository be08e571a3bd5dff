"""Metrics SQLite time-series store + scraper + syncer + recorder; the port
of ``gpud_tpu/metrics/store.py``.

Reference: pkg/metrics/{scraper,store,syncer,recorder} — the three-stage
pipeline (SURVEY §5.5): components set gauges in the registry → the syncer
scrapes once a minute into SQLite with retention purge → /v1/metrics and
the session serve history from the store. The anomaly component reads its
telemetry windows from here.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional

from gpud_tpu_torch.api.v1.types import Metric
from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.metrics.registry import Registry
from gpud_tpu_torch.sqlite import DB
from gpud_tpu_torch import sqlite as sqlite_mod

logger = get_logger(__name__)

TABLE = "tpud_metrics_v0_1"

DEFAULT_RETENTION = 3 * 3600  # 3h (reference: pkg/config/default.go:26)
SCRAPE_INTERVAL = 60.0        # 1m  (reference: pkg/server/server.go:231-239)
RECORDER_INTERVAL = 15 * 60.0 # 15m (reference: pkg/server/server.go:241)

# metric-name prefix → component attribution for /v1/metrics grouping
COMPONENT_LABEL = "component"

# write-behind contract (tools/storage_lint.py): these methods must route
# through the BatchWriter, never commit per-row via db.execute directly
HOT_WRITE_METHODS = ("record",)


class MetricsStore:
    """SQLite time-series table with Record/Read/Purge
    (reference: pkg/metrics/store/sqlite.go:64).

    With a ``writer`` (the write-behind BatchWriter), ``record`` buffers
    rows for the next group commit — same-(timestamp, name, labels)
    samples coalesce last-write-wins — and every read/purge runs the
    flush barrier first so history queries always see completed scrapes.
    Without one (tests, CLI tools) writes stay synchronous.
    """

    def __init__(
        self,
        db: DB,
        retention_seconds: int = DEFAULT_RETENTION,
        writer=None,
    ) -> None:
        self.db = db
        self.writer = writer
        self.retention_seconds = retention_seconds
        db.execute(
            f"""CREATE TABLE IF NOT EXISTS {TABLE} (
                unix_seconds INTEGER NOT NULL,
                name TEXT NOT NULL,
                labels TEXT NOT NULL DEFAULT '',
                value REAL NOT NULL
            )"""
        )
        db.execute(
            f"CREATE INDEX IF NOT EXISTS idx_{TABLE}_ts ON {TABLE} (unix_seconds)"
        )
        db.execute(
            f"CREATE INDEX IF NOT EXISTS idx_{TABLE}_name_ts ON {TABLE} (name, unix_seconds)"
        )

    def record(self, rows: List[tuple]) -> None:
        """rows: (unix_seconds, name, labels_dict, value) — batched insert
        (footprint discipline: one transaction per scrape). ``labels`` may
        also be a pre-encoded JSON string (the firehose fast path skips
        re-serializing identical labelsets per sample)."""
        if not rows:
            return
        sql = f"INSERT INTO {TABLE} (unix_seconds, name, labels, value) VALUES (?, ?, ?, ?)"
        encoded = [
            (
                ts,
                name,
                labels if isinstance(labels, str)
                else (json.dumps(labels, sort_keys=True) if labels else ""),
                value,
            )
            for ts, name, labels, value in rows
        ]
        if self.writer is not None:
            # gauge samples for the same (second, series) coalesce
            # last-write-wins: an ingest storm re-sampling a gauge within
            # one flush window commits one row, not thousands
            self.writer.submit_many(
                "metrics", sql, encoded,
                keys=[("m", ts, name, labels) for ts, name, labels, _v in encoded],
            )
        else:
            self.db.executemany(sql, encoded)

    def flush(self) -> None:
        """Read-after-write barrier (no-op without a writer)."""
        if self.writer is not None:
            self.writer.flush()

    def read(
        self,
        since: float,
        name: str = "",
        components: Optional[List[str]] = None,
    ) -> List[Metric]:
        self.flush()
        sql = f"SELECT unix_seconds, name, labels, value FROM {TABLE} WHERE unix_seconds>=?"
        params: list = [int(since)]
        if name:
            sql += " AND name=?"
            params.append(name)
        sql += " ORDER BY unix_seconds ASC"
        out: List[Metric] = []
        comp_filter = set(components) if components else None
        for ts, nm, labels_json, value in self.db.query(sql, params):
            labels = json.loads(labels_json) if labels_json else {}
            if comp_filter is not None and labels.get(COMPONENT_LABEL) not in comp_filter:
                continue
            out.append(Metric(unix_seconds=ts, name=nm, labels=labels, value=value))
        return out

    def purge(self, before: float) -> int:
        # barrier first: a purge racing buffered rows would let a sample
        # older than the cutoff commit right after the DELETE
        self.flush()
        return self.db.execute(
            f"DELETE FROM {TABLE} WHERE unix_seconds<?", (int(before),)
        ).rowcount


class Syncer:
    """Every minute: scrape registry → store, purge older than retention
    (reference: pkg/metrics/syncer/syncer.go:22-50, wired at
    pkg/server/server.go:231-239)."""

    def __init__(
        self,
        registry: Registry,
        store: MetricsStore,
        interval_seconds: float = SCRAPE_INTERVAL,
    ) -> None:
        self.registry = registry
        self.store = store
        self.interval = interval_seconds
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._job = None
        self.time_now_fn = time.time

    def sync_once(self) -> int:
        rows = self.registry.gather(self.time_now_fn())
        self.store.record(rows)
        self.store.purge(self.time_now_fn() - self.store.retention_seconds)
        return len(rows)

    def start(self, scheduler=None) -> None:
        """On the unified scheduler when given (the daemon path; zero
        threads), else the legacy dedicated thread."""
        if scheduler is not None:
            if self._job is None:
                self._job = scheduler.add_job(
                    "metrics-syncer",
                    self.sync_once,
                    interval=self.interval,
                    initial_delay=self.interval,  # scrape-at-boot is noise
                )
            return
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="tpud-metrics-syncer", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.sync_once()
            except Exception:  # noqa: BLE001
                logger.exception("metrics sync failed")

    def close(self) -> None:
        if self._job is not None:
            self._job.cancel()
            self._job = None
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


class SelfMetricsRecorder:
    """tpud self-metrics: fd usage, DB size, sqlite op timings, vacuum
    seconds, every 15m (reference: pkg/metrics/recorder/gpud_metrics.go:14-60)."""

    def __init__(
        self,
        registry: Registry,
        db: DB,
        interval_seconds: float = RECORDER_INTERVAL,
    ) -> None:
        self.db = db
        self.interval = interval_seconds
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._job = None
        self.g_db_size = registry.gauge(
            "tpud_sqlite_db_size_bytes", "state DB size in bytes"
        )
        self.g_fds = registry.gauge("tpud_file_descriptors", "open fd count of tpud")
        self.g_select_secs = registry.gauge(
            "tpud_sqlite_select_seconds_total", "cumulative sqlite select seconds"
        )
        self.g_write_secs = registry.gauge(
            "tpud_sqlite_insert_update_delete_seconds_total",
            "cumulative sqlite write seconds",
        )
        self.g_vacuum_secs = registry.gauge(
            "tpud_sqlite_vacuum_seconds_total", "cumulative sqlite vacuum seconds"
        )

    def record_once(self) -> None:
        try:
            self.g_db_size.set(self.db.size_bytes())
        except Exception:  # noqa: BLE001
            pass
        self.g_fds.set(_open_fd_count())
        s = sqlite_mod.stats()
        self.g_select_secs.set(s["select_seconds"])
        self.g_write_secs.set(s["insert_update_delete_seconds"])
        self.g_vacuum_secs.set(s["vacuum_seconds"])

    def start(self, scheduler=None) -> None:
        if scheduler is not None:
            if self._job is None:
                # first record runs on the pool (part of startup
                # readiness), then every 15m
                self._job = scheduler.add_job(
                    "self-metrics-recorder", self.record_once,
                    interval=self.interval,
                )
            return
        if self._thread is not None:
            return
        self.record_once()
        self._thread = threading.Thread(
            target=self._loop, name="tpud-self-metrics", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.record_once()
            except Exception:  # noqa: BLE001
                logger.exception("self-metrics record failed")

    def close(self) -> None:
        if self._job is not None:
            self._job.cancel()
            self._job = None
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


def _open_fd_count() -> int:
    try:
        import os

        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return -1
