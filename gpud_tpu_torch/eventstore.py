"""Event store: per-component event buckets in one SQLite DB.

Reference: pkg/eventstore/database.go:18-90, pkg/eventstore/types.go:55-70.
Schema columns timestamp/name/type/message/extra_info; retention purge runs
at retention/5 intervals per bucket; buckets expose
insert/find/get/latest/purge.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional

from gpud_tpu_torch.api.v1.types import Event
from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.metrics.registry import counter
from gpud_tpu_torch.retention import RetentionPurger
from gpud_tpu_torch.sqlite import DB

logger = get_logger(__name__)

_c_purged = counter(
    "tpud_eventstore_purged_total",
    "events deleted by the retention purger, by component",
)


def _row_to_event(component: str, row) -> Event:
    """row = (timestamp, name, type, message, extra_info)."""
    extra = {}
    if len(row) > 4 and row[4]:
        try:
            extra = json.loads(row[4])
        except ValueError:
            extra = {}
    return Event(
        component=component, time=row[0], name=row[1], type=row[2],
        message=row[3], extra_info=extra,
    )


TABLE = "tpud_events_v0_1"  # schema version in table name (reference: database.go:18)

DEFAULT_RETENTION = 14 * 86400  # 14d (reference: pkg/config/default.go:28)

# write-behind contract (tools/storage_lint.py): these methods must route
# through the BatchWriter, never commit per-row via db.execute directly
HOT_WRITE_METHODS = ("_insert",)


class Bucket:
    """Per-component view over the shared events table
    (reference: pkg/eventstore/types.go:59-70)."""

    def __init__(self, store: "EventStore", component: str) -> None:
        self._store = store
        self.component = component

    def name(self) -> str:
        return self.component

    def insert(self, ev: Event) -> None:
        self._store._insert(self.component, ev)

    def find(self, ev: Event) -> Optional[Event]:
        """Find an identical event (same time/name/type/message) — used for
        dedupe before insert (reference: xid/component.go:545-570)."""
        return self._store._find(self.component, ev)

    def get(self, since: float, barrier: bool = True) -> List[Event]:
        """All events at/after ``since``, newest first. ``barrier=False``
        skips the writer flush — for callers that already flushed once
        and fan out over many components (health-timeline correlation)."""
        return self._store._get(self.component, since, barrier=barrier)

    def latest(self) -> Optional[Event]:
        evs = self._store._get(self.component, 0.0, limit=1)
        return evs[0] if evs else None

    def purge(self, before: float) -> int:
        return self._store._purge(self.component, before)

    def close(self) -> None:
        pass


class EventStore:
    """Reference: pkg/eventstore/database.go:71 New().

    One store per daemon; buckets share the table keyed by component name.
    A background purger per bucket runs at retention/5 cadence
    (reference: database.go:85-90) — implemented as one shared
    ``RetentionPurger`` thread (the pattern the health ledger shares) to
    keep thread count flat, stoppable via ``close()``.

    With a ``writer`` (write-behind BatchWriter), inserts append into the
    shared group-commit buffer and every read runs the flush barrier first
    — ``find`` is the kmsg watcher's dedupe-before-insert check, so it must
    see events inserted a moment ago or every fault would double-record.
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
        # optional post-insert observer (the server wires the session
        # outbox here so every event is journaled for delivery); must
        # never fail the insert path
        self.on_insert = None
        self._buckets: Dict[str, Bucket] = {}
        self._mu = threading.Lock()
        self._purger = RetentionPurger(
            "tpud-eventstore-purger", retention_seconds / 5.0, self._purge_tick
        )
        self.time_now_fn = time.time
        db.execute(
            f"""CREATE TABLE IF NOT EXISTS {TABLE} (
                component TEXT NOT NULL,
                timestamp REAL NOT NULL,
                name TEXT NOT NULL,
                type TEXT NOT NULL,
                message TEXT,
                extra_info TEXT
            )"""
        )
        db.execute(
            f"CREATE INDEX IF NOT EXISTS idx_{TABLE}_comp_ts ON {TABLE} (component, timestamp)"
        )
        # covering index for the cross-component since-scan
        # (latest_events / the bench's 2ms detect loop): without it the
        # (component, timestamp) index is useless for a bare
        # ``timestamp>=?`` predicate and the query table-scans — a cost
        # that grows with retention (14d of events)
        db.execute(
            f"CREATE INDEX IF NOT EXISTS idx_{TABLE}_ts ON {TABLE} (timestamp)"
        )

    def bucket(self, component: str) -> Bucket:
        with self._mu:
            b = self._buckets.get(component)
            if b is None:
                b = Bucket(self, component)
                self._buckets[component] = b
            return b

    def flush(self) -> None:
        """Read-after-write barrier (no-op without a writer)."""
        if self.writer is not None:
            self.writer.flush()

    # -- internal ops ------------------------------------------------------
    def _insert(self, component: str, ev: Event) -> None:
        extra = json.dumps(ev.extra_info, sort_keys=True) if ev.extra_info else ""
        sql = (
            f"INSERT INTO {TABLE} (component, timestamp, name, type, message, extra_info) "
            "VALUES (?, ?, ?, ?, ?, ?)"
        )
        params = (component, ev.time, ev.name, ev.type, ev.message, extra)
        if self.writer is not None:
            self.writer.submit("events", sql, params)
        else:
            self.db.execute(sql, params)
        hook = self.on_insert
        if hook is not None:
            try:
                hook(component, ev)
            except Exception:  # noqa: BLE001
                logger.exception("event on_insert hook failed")

    def _find(self, component: str, ev: Event) -> Optional[Event]:
        self.flush()
        row = self.db.query_one(
            f"SELECT timestamp, name, type, message, extra_info FROM {TABLE} "
            "WHERE component=? AND timestamp=? AND name=? AND type=? AND message=? LIMIT 1",
            (component, ev.time, ev.name, ev.type, ev.message),
        )
        if row is None:
            return None
        return _row_to_event(component, row)

    def _get(self, component: str, since: float, limit: int = 0,
             barrier: bool = True) -> List[Event]:
        if barrier:
            self.flush()
        sql = (
            f"SELECT timestamp, name, type, message, extra_info FROM {TABLE} "
            "WHERE component=? AND timestamp>=? ORDER BY timestamp DESC"
        )
        params: list = [component, since]
        if limit:
            sql += " LIMIT ?"
            params.append(limit)
        rows = self.db.query(sql, params)
        return [_row_to_event(component, r) for r in rows]

    def _purge(self, component: str, before: float,
               barrier: bool = True) -> int:
        if barrier:
            self.flush()
        cur = self.db.execute(
            f"DELETE FROM {TABLE} WHERE component=? AND timestamp<?",
            (component, before),
        )
        return cur.rowcount

    def latest_events(self, since: float) -> Dict[str, List[Event]]:
        self.flush()
        rows = self.db.query(
            f"SELECT component, timestamp, name, type, message, extra_info FROM {TABLE} "
            "WHERE timestamp>=? ORDER BY timestamp DESC",
            (since,),
        )
        out: Dict[str, List[Event]] = {}
        for r in rows:
            out.setdefault(r[0], []).append(_row_to_event(r[0], r[1:]))
        return out

    # -- retention ---------------------------------------------------------
    def start_purger(self, scheduler=None) -> None:
        self._purger.start(scheduler)

    def purge_once(self) -> None:
        """One retention pass now — the daemon's consolidated
        ``retention-purge`` scheduler job calls this instead of running a
        dedicated purger (docs/scheduler.md)."""
        self._purge_tick()

    def _purge_tick(self) -> None:
        """One purge pass, per component so the purge counter attributes
        deletions (reference cadence: database.go:85-90)."""
        self.flush()  # never let a buffered row dodge the purge cutoff
        cutoff = self.time_now_fn() - self.retention_seconds
        comps = [
            r[0]
            for r in self.db.query(
                f"SELECT DISTINCT component FROM {TABLE} WHERE timestamp<?",
                (cutoff,),
            )
        ]
        total = 0
        for comp in comps:
            # barrier=False: the single flush above already fenced every
            # buffered row behind the cutoff — N per-component re-flushes
            # bought nothing (flow_lint flush-audit)
            n = self._purge(comp, cutoff, barrier=False)
            if n:
                _c_purged.inc(n, {"component": comp})
                total += n
        if total:
            logger.info("eventstore purged %d events", total)

    def close(self) -> None:
        self._purger.close()
