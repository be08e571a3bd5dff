"""Metrics SQLite time-series store: the store of ``gpud_tpu/metrics/store.py``.

Reference: pkg/metrics/store — the middle stage of the three-stage
pipeline (SURVEY §5.5): components set gauges in the registry → the syncer
scrapes once a minute into SQLite with retention purge → /v1/metrics and
the session serve history from the store. The anomaly component reads its
telemetry windows from here. The syncer, the self-metrics recorder and the
write-behind BatchWriter come with the device-free daemon, so the port
writes synchronously unless a caller passes a ``writer``.
"""

from __future__ import annotations

import json
from typing import List, Optional

from gpud_tpu_torch.api.v1.types import Metric
from gpud_tpu_torch.sqlite import DB

TABLE = "tpud_metrics_v0_1"

DEFAULT_RETENTION = 3 * 3600  # 3h (reference: pkg/config/default.go:26)

# metric-name prefix → component attribution for /v1/metrics grouping
COMPONENT_LABEL = "component"


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
