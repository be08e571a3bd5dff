"""Remediation audit ledger: every repair attempt, persisted (the port of
``gpud_tpu/remediation/audit.py``).

Auto-repair is only operable when every decision leaves a durable trail:
what the trigger was, what the policy decided, what actually ran, and how
it went. One append-only SQLite table (schema versioned like the
eventstore/health-ledger tables), purged past retention by the shared
``RetentionPurger``; the CLI opens a second store over the same state file
(daemon running or not, WAL mode) for the offline ``tpud remediation``
view.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.metrics.registry import counter
from gpud_tpu_torch.retention import RetentionPurger
from gpud_tpu_torch.sqlite import DB

logger = get_logger(__name__)

TABLE = "tpud_remediation_audit_v0_1"

DEFAULT_RETENTION = 14 * 86400  # matches the eventstore window

_c_purged = counter(
    "tpud_remediation_audit_purged_total",
    "remediation audit rows deleted by the retention purger",
)

# write-behind contract (tools/storage_lint.py): these methods must route
# through the BatchWriter, never commit per-row via db.execute directly
HOT_WRITE_METHODS = ("record",)


class AuditStore:
    """Append-only remediation attempt ledger over the shared state DB.

    With a ``writer`` (write-behind BatchWriter), ``record`` appends into
    the shared group-commit buffer and every read runs the flush barrier
    first — mandatory here, because reads are decision inputs: the
    cooldown anchor (``last_attempt_time``) and the rate/escalation
    counters must see the attempt recorded microseconds ago or the engine
    would double-fire.
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
        self.time_now_fn = time.time
        # optional post-record observer (the server wires the session
        # outbox here); must never fail the record path
        self.on_record = None
        db.execute(
            f"""CREATE TABLE IF NOT EXISTS {TABLE} (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                timestamp REAL NOT NULL,
                component TEXT NOT NULL,
                action TEXT NOT NULL,
                suggested TEXT NOT NULL,
                trigger_health TEXT NOT NULL,
                trigger_reason TEXT,
                decision TEXT NOT NULL,
                outcome TEXT NOT NULL,
                detail TEXT,
                duration_seconds REAL NOT NULL DEFAULT 0
            )"""
        )
        db.execute(
            f"CREATE INDEX IF NOT EXISTS idx_{TABLE}_comp_ts "
            f"ON {TABLE} (component, timestamp)"
        )
        self._purger = RetentionPurger(
            "tpud-remediation-audit-purger",
            retention_seconds / 5.0,
            self._purge_tick,
        )

    # -- write path --------------------------------------------------------
    def record(
        self,
        component: str,
        action: str,
        suggested: str,
        trigger_health: str,
        trigger_reason: str,
        decision: str,
        outcome: str,
        detail: str = "",
        duration_seconds: float = 0.0,
        ts: Optional[float] = None,
    ) -> None:
        sql = (
            f"INSERT INTO {TABLE} (timestamp, component, action, suggested, "
            "trigger_health, trigger_reason, decision, outcome, detail, "
            "duration_seconds) VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)"
        )
        params = (
            self.time_now_fn() if ts is None else ts,
            component,
            action,
            suggested,
            trigger_health,
            trigger_reason or "",
            decision,
            outcome,
            detail or "",
            duration_seconds,
        )
        if self.writer is not None:
            self.writer.submit("audit", sql, params)
        else:
            self.db.execute(sql, params)
        hook = self.on_record
        if hook is not None:
            try:
                hook(
                    {
                        "ts": params[0],
                        "component": component,
                        "action": action,
                        "suggested": suggested,
                        "trigger_health": trigger_health,
                        "trigger_reason": trigger_reason or "",
                        "decision": decision,
                        "outcome": outcome,
                        "detail": detail or "",
                        "duration_seconds": duration_seconds,
                    }
                )
            except Exception:  # noqa: BLE001
                logger.exception("audit on_record hook failed")

    def flush(self) -> None:
        """Read-after-write barrier (no-op without a writer)."""
        if self.writer is not None:
            self.writer.flush()

    # -- read path ---------------------------------------------------------
    def read(
        self,
        component: Optional[str] = None,
        action: Optional[str] = None,
        outcome: Optional[str] = None,
        since: float = 0.0,
        limit: int = 0,
    ) -> List[Dict]:
        """Attempt rows, newest first."""
        self.flush()
        sql = (
            f"SELECT timestamp, component, action, suggested, trigger_health, "
            f"trigger_reason, decision, outcome, detail, duration_seconds "
            f"FROM {TABLE} WHERE timestamp>=?"
        )
        params: list = [since]
        for col, val in (
            ("component", component), ("action", action), ("outcome", outcome)
        ):
            if val:
                sql += f" AND {col}=?"
                params.append(val)
        sql += " ORDER BY timestamp DESC, id DESC"
        if limit:
            sql += " LIMIT ?"
            params.append(limit)
        return [
            {
                "time": r[0],
                "component": r[1],
                "action": r[2],
                "suggested": r[3],
                "trigger_health": r[4],
                "trigger_reason": r[5] or "",
                "decision": r[6],
                "outcome": r[7],
                "detail": r[8] or "",
                "duration_seconds": r[9],
            }
            for r in self.db.query(sql, params)
        ]

    def last_attempt_time(
        self, component: str, action: Optional[str] = None,
        exclude_action: Optional[str] = None,
    ) -> Optional[float]:
        """Newest audit row for the component — the cooldown anchor.

        ``action`` narrows to one action's lane (the predict engine
        anchors its warning cooldown on its own rows); ``exclude_action``
        carves a lane out (the reactive engine excludes predicted rows so
        an early warning never defers the repair it predicted)."""
        self.flush()
        sql = f"SELECT MAX(timestamp) FROM {TABLE} WHERE component=?"
        params: list = [component]
        if action:
            sql += " AND action=?"
            params.append(action)
        if exclude_action:
            sql += " AND action<>?"
            params.append(exclude_action)
        row = self.db.query_one(sql, params)
        return row[0] if row and row[0] is not None else None

    def count(
        self,
        component: Optional[str] = None,
        action: Optional[str] = None,
        outcomes: Optional[List[str]] = None,
        since: float = 0.0,
    ) -> int:
        self.flush()
        sql = f"SELECT COUNT(*) FROM {TABLE} WHERE timestamp>=?"
        params: list = [since]
        if component:
            sql += " AND component=?"
            params.append(component)
        if action:
            sql += " AND action=?"
            params.append(action)
        if outcomes:
            sql += f" AND outcome IN ({','.join('?' * len(outcomes))})"
            params.extend(outcomes)
        row = self.db.query_one(sql, params)
        return int(row[0]) if row else 0

    def summary(self) -> Dict:
        """Rollup for status views: total rows + per-outcome counts."""
        self.flush()
        rows = self.db.query(
            f"SELECT outcome, COUNT(*) FROM {TABLE} GROUP BY outcome"
        )
        by_outcome = {r[0]: int(r[1]) for r in rows}
        return {
            "attempts_total": sum(by_outcome.values()),
            "by_outcome": by_outcome,
        }

    # -- retention ---------------------------------------------------------
    def start_purger(self, scheduler=None) -> None:
        self._purger.start(scheduler)

    def purge_once(self) -> None:
        """One retention pass now (consolidated scheduler job hook)."""
        self._purge_tick()

    def _purge_tick(self) -> None:
        self.flush()  # never let a buffered row dodge (or outlive) the purge
        cutoff = self.time_now_fn() - self.retention_seconds
        n = self.db.execute(
            f"DELETE FROM {TABLE} WHERE timestamp<?", (cutoff,)
        ).rowcount
        if n:
            _c_purged.inc(n)
            logger.info("remediation audit purged %d rows", n)

    def close(self) -> None:
        self._purger.close()
