"""Health-transition ledger: persistent per-component state timeline; the
port of ``gpud_tpu/health_history.py``.

``/v1/states`` is a point-in-time snapshot — a component that was Unhealthy
for 40 minutes overnight and recovered looks identical to one that never
failed. This module records every health-state *transition* (component,
from, to, reason, unix ts) observed in ``Component.check()`` into SQLite,
surviving daemon restarts, and derives the operator-facing accounting on
top: current-state enum gauge, transition counters, cumulative
seconds-in-state, rolling-window availability, MTTR/MTBF, and flap
detection (the early-warning signal transition patterns carry per arxiv
2509.19575 / 2510.16946).

Two tables, bucket/retention modeled on ``eventstore.py``:

- ``tpud_health_transitions_v0_1`` — append-only transition rows, purged
  past retention by a shared ``RetentionPurger``;
- ``tpud_health_last_state_v0_1`` — one row per component: current state,
  episode start, first-seen, last observation. On startup the first fresh
  check reconciles against this row, so a restart into the same state
  continues the episode instead of minting a phantom transition.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

from gpud_tpu_torch.api.v1.types import Event, EventType, HealthStateType
from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.metrics.registry import counter, gauge
from gpud_tpu_torch.retention import RetentionPurger
from gpud_tpu_torch.sqlite import DB

logger = get_logger(__name__)

TABLE = "tpud_health_transitions_v0_1"
LAST_TABLE = "tpud_health_last_state_v0_1"

DEFAULT_RETENTION = 14 * 86400  # matches the eventstore window
DEFAULT_FLAP_THRESHOLD = 5      # >= N transitions within the window => flapping
DEFAULT_FLAP_WINDOW = 600.0
DEFAULT_FLAP_EVENT_COOLDOWN = 600.0  # one Warning per component per cooldown
DEFAULT_AVAILABILITY_WINDOW = 3600.0
DEFAULT_CORRELATION_WINDOW = 60.0    # +/- event correlation for timelines

# enum gauge encoding (documented in docs/observability.md; alert on >= 2)
STATE_CODES = {
    HealthStateType.INITIALIZING: 0,
    HealthStateType.HEALTHY: 1,
    HealthStateType.DEGRADED: 2,
    HealthStateType.UNHEALTHY: 3,
}

_g_state = gauge(
    "tpud_component_health_state",
    "current health state as an enum gauge "
    "(0=Initializing 1=Healthy 2=Degraded 3=Unhealthy), by component",
)
_c_transitions = counter(
    "tpud_component_health_transitions_total",
    "health-state transitions by component and from/to state",
)
_c_state_seconds = counter(
    "tpud_component_state_seconds_total",
    "cumulative observed seconds spent in each health state, by component",
)
_g_availability = gauge(
    "tpud_component_availability_ratio",
    "fraction of the rolling availability window spent Healthy, by component",
)
_g_mttr = gauge(
    "tpud_component_mttr_seconds",
    "mean seconds from entering Unhealthy to leaving it, by component",
)
_g_mtbf = gauge(
    "tpud_component_mtbf_seconds",
    "mean seconds between successive entries into Unhealthy, by component",
)
_g_flapping = gauge(
    "tpud_component_flapping",
    "1 while the component is flap-detected "
    "(>= threshold transitions inside the flap window), else 0",
)
_c_purged = counter(
    "tpud_health_transitions_purged_total",
    "transition rows deleted by the retention purger, by component",
)

# write-behind contract (tools/storage_lint.py): these methods must route
# through the BatchWriter, never commit per-row via db.execute directly
HOT_WRITE_METHODS = ("_record_transition", "_persist_last")


class HealthLedger:
    """One ledger per daemon, shared by every component's check wrapper.

    ``observe()`` is the single write path; everything else is read-only
    derivation, so the CLI can open a second ledger over the same state
    file (daemon running or not) and get identical timelines.

    With a ``writer`` (write-behind BatchWriter) the per-observe upsert of
    the last-state row coalesces by component (one committed row per
    component per flush window instead of one per check), transitions
    append into the shared buffer, and public reads run the flush barrier.
    ``observe()`` itself never takes the barrier: flap counting runs
    against an in-memory per-component transition window (seeded from the
    DB at reconcile), and the derived gauges tolerate flush-window
    staleness — otherwise every check would force a commit and defeat the
    batching.
    """

    GUARDED_BY = {
        "_last": "_mu",
        "_last_flap_event": "_mu",
        "_tx_recent": "_mu",
        "_annotations": "_mu",
    }
    # internal helpers reached only from observe()/is_flapping(), which
    # take _mu; not renamed *_locked because HOT_WRITE_METHODS (storage
    # lint) pins two of the names
    _LOCK_FREE = {
        "_reconcile_boot": "caller observe() holds _mu for the whole "
                           "first-observation reconcile",
        "_record_transition": "callers observe()/_reconcile_boot hold _mu",
        "_flap_check": "caller observe() holds _mu around the flap scan",
        "_transitions_in_window": "callers observe() (via _flap_check) and "
                                  "is_flapping() hold _mu",
    }

    def __init__(
        self,
        db: DB,
        event_store=None,
        retention_seconds: int = DEFAULT_RETENTION,
        flap_threshold: int = DEFAULT_FLAP_THRESHOLD,
        flap_window_seconds: float = DEFAULT_FLAP_WINDOW,
        flap_event_cooldown: float = DEFAULT_FLAP_EVENT_COOLDOWN,
        availability_window_seconds: float = DEFAULT_AVAILABILITY_WINDOW,
        correlation_window_seconds: float = DEFAULT_CORRELATION_WINDOW,
        writer=None,
    ) -> None:
        self.db = db
        self.writer = writer
        self.event_store = event_store
        self.retention_seconds = retention_seconds
        self.flap_threshold = flap_threshold
        self.flap_window = flap_window_seconds
        self.flap_event_cooldown = flap_event_cooldown
        self.availability_window = availability_window_seconds
        self.correlation_window = correlation_window_seconds
        self._mu = threading.Lock()
        # optional post-transition observer (the server wires the session
        # outbox here); must never fail the observe path
        self.on_transition = None
        # component -> [state, episode_since, last_seen, first_seen]
        self._last: Dict[str, list] = {}
        self._last_flap_event: Dict[str, float] = {}
        # component -> recent (ts, from, to, reason) tuples (flap-window
        # cache): lets observe() count flaps — and the predict scorer pull
        # cadence features — without a read, and therefore without a flush
        # barrier, on the hot path
        self._tx_recent: Dict[str, deque] = {}
        # component -> externally-owned annotation dict (e.g. the predict
        # engine's {"predicted": "true"}), merged into observe()'s
        # returned annotations alongside the flap marker
        self._annotations: Dict[str, Dict[str, str]] = {}
        import time as _time

        self.time_now_fn = _time.time
        db.execute(
            f"""CREATE TABLE IF NOT EXISTS {TABLE} (
                component TEXT NOT NULL,
                timestamp REAL NOT NULL,
                from_state TEXT NOT NULL,
                to_state TEXT NOT NULL,
                reason TEXT
            )"""
        )
        db.execute(
            f"CREATE INDEX IF NOT EXISTS idx_{TABLE}_comp_ts "
            f"ON {TABLE} (component, timestamp)"
        )
        # /v1/states/history with no component filter is a bare
        # ``timestamp>=? ORDER BY timestamp DESC`` — this index serves
        # both the predicate and the sort, so the endpoint stays flat as
        # the transition table grows toward its 14d retention
        db.execute(
            f"CREATE INDEX IF NOT EXISTS idx_{TABLE}_ts ON {TABLE} (timestamp)"
        )
        db.execute(
            f"""CREATE TABLE IF NOT EXISTS {LAST_TABLE} (
                component TEXT PRIMARY KEY,
                state TEXT NOT NULL,
                since REAL NOT NULL,
                first_seen REAL NOT NULL,
                updated REAL NOT NULL
            )"""
        )
        self._purger = RetentionPurger(
            "tpud-health-ledger-purger",
            retention_seconds / 5.0,
            self._purge_tick,
        )

    # -- write path --------------------------------------------------------
    def observe(
        self, component: str, health: str, reason: str = "",
        now: Optional[float] = None,
    ) -> Dict[str, str]:
        """Record one check outcome; returns state annotations (currently
        the ``flapping`` marker) for the caller to attach to the result."""
        state = health or HealthStateType.HEALTHY
        ts = self.time_now_fn() if now is None else now
        with self._mu:
            ep = self._last.get(component)
            if ep is None:
                ep = self._reconcile_boot(component, state, ts, reason)
            else:
                elapsed = ts - ep[2]
                if elapsed > 0:
                    _c_state_seconds.inc(
                        elapsed, {"component": component, "state": ep[0]}
                    )
                if ep[0] != state:
                    self._record_transition(component, ep[0], state, ts, reason)
                    ep[0] = state
                    ep[1] = ts
                ep[2] = ts
                self._persist_last(component, ep)
            _g_state.set(
                STATE_CODES.get(state, -1.0), {"component": component}
            )
            ann = self._flap_check(component, ts)
            ext = self._annotations.get(component)
            if ext:
                ann = {**ext, **ann}
            self._refresh_derived(component, ts)
        return ann

    def flush(self) -> None:
        """Read-after-write barrier (no-op without a writer)."""
        if self.writer is not None:
            self.writer.flush()

    def _reconcile_boot(
        self, component: str, state: str, ts: float, reason: str
    ) -> list:
        """First observation since process start: continue the persisted
        episode when the state matches, mint exactly one transition when it
        doesn't, and start fresh for a never-seen component."""
        self.flush()  # once per component per process — not a hot path
        row = self.db.query_one(
            f"SELECT state, since, first_seen FROM {LAST_TABLE} WHERE component=?",
            (component,),
        )
        # seed the in-memory flap window from persisted history so a
        # restart mid-flap still detects it (full tuples: the predict
        # scorer reads cadence shape, not just counts)
        self._tx_recent[component] = deque(
            (r[0], r[1], r[2], r[3] or "")
            for r in self.db.query(
                f"SELECT timestamp, from_state, to_state, reason FROM {TABLE} "
                "WHERE component=? AND timestamp>? ORDER BY timestamp ASC",
                (component, ts - self.flap_window),
            )
        )
        if row is None:
            ep = [state, ts, ts, ts]
        else:
            prev_state, prev_since, first_seen = row
            if prev_state == state:
                ep = [state, prev_since, ts, first_seen]
            else:
                self._record_transition(component, prev_state, state, ts, reason)
                ep = [state, ts, ts, first_seen]
        self._last[component] = ep
        self._persist_last(component, ep)
        return ep

    def _persist_last(self, component: str, ep: list) -> None:
        sql = (
            f"""INSERT INTO {LAST_TABLE} (component, state, since, first_seen, updated)
                VALUES (?, ?, ?, ?, ?)
                ON CONFLICT(component) DO UPDATE SET
                    state=excluded.state, since=excluded.since,
                    first_seen=excluded.first_seen, updated=excluded.updated"""
        )
        params = (component, ep[0], ep[1], ep[3], ep[2])
        if self.writer is not None:
            # coalesce by component: only the newest upsert in a flush
            # window commits — the table holds one row per component anyway
            self.writer.submit("ledger", sql, params, key=("hl", component))
        else:
            self.db.execute(sql, params)

    def _record_transition(
        self, component: str, from_state: str, to_state: str,
        ts: float, reason: str,
    ) -> None:
        sql = (
            f"INSERT INTO {TABLE} (component, timestamp, from_state, to_state, reason) "
            "VALUES (?, ?, ?, ?, ?)"
        )
        params = (component, ts, from_state, to_state, reason or "")
        if self.writer is not None:
            self.writer.submit("ledger", sql, params)
        else:
            self.db.execute(sql, params)
        recent = self._tx_recent.setdefault(component, deque())
        recent.append((ts, from_state, to_state, reason or ""))
        _c_transitions.inc(
            labels={"component": component, "from": from_state, "to": to_state}
        )
        hook = self.on_transition
        if hook is not None:
            try:
                hook(component, from_state, to_state, ts, reason or "")
            except Exception:  # noqa: BLE001
                logger.exception("health on_transition hook failed")

    def _flap_check(self, component: str, now: float) -> Dict[str, str]:
        n = self._transitions_in_window(component, now)
        flapping = n >= self.flap_threshold
        _g_flapping.set(1.0 if flapping else 0.0, {"component": component})
        if not flapping:
            return {}
        ann = {"flapping": "true", "transitions_in_window": str(n)}
        es = self.event_store
        # None (never emitted) always fires: seeding with 0.0 would
        # suppress the first warning on clocks near the epoch (tests)
        last = self._last_flap_event.get(component)
        if es is not None and (
            last is None or now - last >= self.flap_event_cooldown
        ):
            self._last_flap_event[component] = now
            try:
                es.bucket(component).insert(
                    Event(
                        component=component,
                        time=now,
                        name="health_flapping",
                        type=EventType.WARNING,
                        message=(
                            f"{n} health transitions in the last "
                            f"{self.flap_window:g}s (threshold "
                            f"{self.flap_threshold})"
                        ),
                        extra_info={
                            "transitions_in_window": str(n),
                            "flap_window_seconds": f"{self.flap_window:g}",
                            "flap_threshold": str(self.flap_threshold),
                        },
                    )
                )
            except Exception:  # noqa: BLE001 — accounting must not kill checks
                logger.exception("flap event emit failed for %s", component)
        return ann

    def _transitions_in_window(self, component: str, now: float) -> int:
        cutoff = now - self.flap_window
        recent = self._tx_recent.get(component)
        if recent is not None:
            # in-memory window (seeded at reconcile, appended on every
            # transition): the observe() hot path never reads the DB, so
            # it never needs the flush barrier
            try:
                while recent and recent[0][0] <= cutoff:
                    recent.popleft()
            except IndexError:  # concurrent prune emptied it under us
                pass
            return len(recent)
        # component never observed by this process (CLI over a shared
        # state file): fall back to the table, behind the barrier
        self.flush()
        row = self.db.query_one(
            f"SELECT COUNT(*) FROM {TABLE} WHERE component=? AND timestamp>?",
            (component, cutoff),
        )
        return int(row[0]) if row else 0

    def recent_transitions(self, component: str, limit: int = 0) -> List[Dict]:
        """Newest-first transitions from the in-memory flap-window cache.

        Bulk accessor for the predict scorer's hot tick: reads ONLY the
        per-component deque (bounded by the flap window), never the DB,
        and therefore never the BatchWriter flush barrier. Use
        :meth:`history` when the full persisted timeline matters.
        """
        with self._mu:
            recent = self._tx_recent.get(component)
            if not recent:
                return []
            rows = list(recent)
        if limit:
            rows = rows[-limit:]
        return [
            {"component": component, "time": r[0], "from": r[1],
             "to": r[2], "reason": r[3]}
            for r in reversed(rows)
        ]

    def last_state(self, component: str) -> Optional[Dict]:
        """Barrier-free current-episode view from the in-memory map:
        ``{"state", "since", "last_seen"}`` — None before the component's
        first observe() of this process."""
        with self._mu:
            ep = self._last.get(component)
            if ep is None:
                return None
            return {"state": ep[0], "since": ep[1], "last_seen": ep[2]}

    # -- external annotations (predict engine) ------------------------------
    def set_annotation(self, component: str, key: str, value: str) -> None:
        """Attach a marker that rides every subsequent observe() of the
        component (merged into the returned annotation dict, flap marker
        winning key collisions). Owned by external subsystems — the
        predict engine stamps ``predicted`` here."""
        with self._mu:
            self._annotations.setdefault(component, {})[key] = value

    def clear_annotation(self, component: str, key: str) -> None:
        with self._mu:
            ext = self._annotations.get(component)
            if ext is not None:
                ext.pop(key, None)
                if not ext:
                    self._annotations.pop(component, None)

    def _refresh_derived(self, component: str, now: float) -> None:
        # barrier=False: these run inside every observe(); forcing a
        # commit here would serialize the hot path on the writer. The
        # gauges may lag the newest (still-buffered) transition by at most
        # one flush window — acceptable for 15m-cadence derived series.
        av = self.availability(component, now=now, barrier=False)
        if av is not None:
            _g_availability.set(av["ratio"], {"component": component})
        mttr, mtbf = self.mttr_mtbf(component, barrier=False)
        if mttr is not None:
            _g_mttr.set(mttr, {"component": component})
        if mtbf is not None:
            _g_mtbf.set(mtbf, {"component": component})

    # -- read path ---------------------------------------------------------
    def history(
        self,
        component: Optional[str] = None,
        since: float = 0.0,
        limit: int = 0,
    ) -> List[Dict]:
        """Transition timeline, newest first."""
        self.flush()
        sql = (
            f"SELECT component, timestamp, from_state, to_state, reason "
            f"FROM {TABLE} WHERE timestamp>=?"
        )
        params: list = [since]
        if component:
            sql += " AND component=?"
            params.append(component)
        sql += " ORDER BY timestamp DESC"
        if limit:
            sql += " LIMIT ?"
            params.append(limit)
        return [
            {
                "component": r[0],
                "time": r[1],
                "from": r[2],
                "to": r[3],
                "reason": r[4] or "",
            }
            for r in self.db.query(sql, params)
        ]

    def annotate_with_events(
        self, transitions: List[Dict], window: Optional[float] = None
    ) -> List[Dict]:
        """Attach eventstore events within ±window of each transition — the
        'what else happened around that flip' context for timelines."""
        w = self.correlation_window if window is None else window
        es = self.event_store
        if es is not None and w >= 0 and transitions:
            # one event-store barrier for the whole timeline; the
            # per-transition gets below were each re-flushing the shared
            # writer (flow_lint flush-audit)
            es.flush()
        for t in transitions:
            events: List[Dict] = []
            if es is not None and w >= 0:
                try:
                    events = [
                        e.to_dict()
                        for e in es.bucket(t["component"]).get(
                            t["time"] - w, barrier=False
                        )
                        if e.time <= t["time"] + w
                    ]
                except Exception:  # noqa: BLE001
                    logger.exception("event correlation failed")
            t["events"] = events
        return transitions

    def availability(
        self,
        component: str,
        window_seconds: Optional[float] = None,
        now: Optional[float] = None,
        barrier: bool = True,
    ) -> Optional[Dict]:
        """Healthy-time ratio over the rolling window, reconstructed from
        the transition timeline plus the current episode. The window is
        clamped to the component's first-seen time so a freshly-registered
        component isn't billed for time before it existed. Returns None
        for unknown components or zero observed time."""
        if barrier:
            self.flush()
        w = self.availability_window if window_seconds is None else window_seconds
        ts_now = self.time_now_fn() if now is None else now
        row = self.db.query_one(
            f"SELECT state, since, first_seen FROM {LAST_TABLE} WHERE component=?",
            (component,),
        )
        if row is None:
            return None
        cur_state, _cur_since, first_seen = row
        start = max(ts_now - w, first_seen)
        observed = ts_now - start
        if observed <= 0:
            return None
        rows = self.db.query(
            f"SELECT timestamp, from_state, to_state FROM {TABLE} "
            "WHERE component=? AND timestamp>? ORDER BY timestamp ASC",
            (component, start),
        )
        state = rows[0][1] if rows else cur_state
        healthy = 0.0
        t = start
        for ts, _from_state, to_state in rows:
            ts = min(ts, ts_now)
            if state == HealthStateType.HEALTHY:
                healthy += ts - t
            t = ts
            state = to_state
        if state == HealthStateType.HEALTHY:
            healthy += ts_now - t
        return {
            "ratio": healthy / observed,
            "healthy_seconds": healthy,
            "observed_seconds": observed,
            "window_seconds": w,
            "state": cur_state,
        }

    def mttr_mtbf(self, component: str, barrier: bool = True):
        """(MTTR, MTBF) from the persisted timeline: MTTR is the mean
        duration of completed Unhealthy episodes; MTBF the mean gap between
        successive entries into Unhealthy. Either is None without enough
        history."""
        if barrier:
            self.flush()
        rows = self.db.query(
            f"SELECT timestamp, from_state, to_state FROM {TABLE} "
            "WHERE component=? ORDER BY timestamp ASC",
            (component,),
        )
        failure_starts: List[float] = []
        repairs: List[float] = []
        fail_at: Optional[float] = None
        for ts, from_state, to_state in rows:
            if to_state == HealthStateType.UNHEALTHY and from_state != HealthStateType.UNHEALTHY:
                failure_starts.append(ts)
                fail_at = ts
            elif from_state == HealthStateType.UNHEALTHY and to_state != HealthStateType.UNHEALTHY:
                if fail_at is not None:
                    repairs.append(ts - fail_at)
                    fail_at = None
        mttr = sum(repairs) / len(repairs) if repairs else None
        mtbf = (
            (failure_starts[-1] - failure_starts[0]) / (len(failure_starts) - 1)
            if len(failure_starts) >= 2
            else None
        )
        return mttr, mtbf

    def components(self, barrier: bool = True) -> List[str]:
        if barrier:
            self.flush()
        return [
            r[0]
            for r in self.db.query(
                f"SELECT component FROM {LAST_TABLE} ORDER BY component"
            )
        ]

    def is_flapping(self, component: str, now: Optional[float] = None) -> bool:
        ts = self.time_now_fn() if now is None else now
        # under _mu: _transitions_in_window prunes the per-component deque
        # in place, so the unlocked call raced observe()'s appends (the
        # old `except IndexError` there papered over exactly this)
        with self._mu:
            return (
                self._transitions_in_window(component, ts)
                >= self.flap_threshold
            )

    def flapping_components(self, now: Optional[float] = None) -> List[str]:
        ts = self.time_now_fn() if now is None else now
        return [c for c in self.components() if self.is_flapping(c, ts)]

    def availability_all(
        self,
        window_seconds: Optional[float] = None,
        now: Optional[float] = None,
    ) -> Dict[str, Dict]:
        # one barrier for the whole sweep: the per-component availability
        # reads see everything this flush committed, so the old N+1
        # re-flushes (one inside components() plus one per availability()
        # call) were pure barrier overhead (flow_lint flush-audit)
        self.flush()
        out = {}
        for c in self.components(barrier=False):
            av = self.availability(
                c, window_seconds=window_seconds, now=now, barrier=False
            )
            if av is not None:
                out[c] = av
        return out

    def summary(self, now: Optional[float] = None) -> Dict:
        """Rollup for /v1/info: totals + who is flapping right now."""
        self.flush()
        ts = self.time_now_fn() if now is None else now
        row = self.db.query_one(f"SELECT COUNT(*) FROM {TABLE}")
        comps = self.components(barrier=False)  # fenced by the flush above
        return {
            "transitions_total": int(row[0]) if row else 0,
            "components_tracked": len(comps),
            "flapping": [c for c in comps if self.is_flapping(c, ts)],
        }

    # -- retention ---------------------------------------------------------
    def start_purger(self, scheduler=None) -> None:
        self._purger.start(scheduler)

    def purge_once(self) -> None:
        """One retention pass now (consolidated scheduler job hook)."""
        self._purge_tick()

    def _purge_tick(self) -> None:
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
            n = self.db.execute(
                f"DELETE FROM {TABLE} WHERE component=? AND timestamp<?",
                (comp, cutoff),
            ).rowcount
            if n:
                _c_purged.inc(n, {"component": comp})
                total += n
        # drop last-state rows for components not observed in a whole
        # retention window (deregistered / renamed) so they age out too
        self.db.execute(f"DELETE FROM {LAST_TABLE} WHERE updated<?", (cutoff,))
        if total:
            logger.info("health ledger purged %d transitions", total)

    def close(self) -> None:
        self._purger.close()
