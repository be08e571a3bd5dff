"""Remediation engine: the detect → decide → repair → audit scan loop; the
port of ``gpud_tpu/remediation/engine.py``.

Every scan walks the component registry, collects pending
``SuggestedActions`` from the latest health states, and runs each through
the policy ladder:

  escalated?  → stop retrying (HARDWARE_INSPECTION marker already filed)
  cooldown    → one attempt per component per cooldown window (derived
                from the audit ledger, so it survives restarts)
  allowlist   → action not enforced ⇒ ``dry_run`` audit row, host untouched
  rate limit  → global token bucket across all enforced repairs
  reboot gate → completed reboots (reboot event store) + engine-executed
                reboots (audit ledger) inside the window cap hard repairs
  execute     → soft/hard executor; N failed soft repairs in the
                escalation window ⇒ escalate REBOOT_SYSTEM →
                HARDWARE_INSPECTION and stop

Every decision lands in the SQLite audit ledger and the
``tpud_remediation_attempts_total{action,outcome}`` counter; decision
latency is histogrammed. The loop mirrors ``PollingComponent`` (own daemon
thread, pokeable, injectable clock) and the whole subsystem is wired like
the health ledger: constructed in ``server.Server``, started in the
assembly block, closed on stop.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Set

from gpud_tpu_torch.api.v1.types import (
    Event,
    EventType,
    HealthStateType,
    RepairActionType,
)
from gpud_tpu_torch.log import audit as audit_log
from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.metrics.registry import counter, histogram
from gpud_tpu_torch.remediation.actions import Executors
from gpud_tpu_torch.remediation.audit import DEFAULT_RETENTION, AuditStore
from gpud_tpu_torch.remediation.policy import (
    ACTION_INSPECTION,
    ACTION_PREDICTED,
    ACTION_REBOOT,
    ACTION_RESTART_RUNTIME,
    DECISION_BLOCKED_RATE_LIMIT,
    DECISION_BLOCKED_REBOOT_WINDOW,
    DECISION_DRY_RUN,
    DECISION_ESCALATE,
    DECISION_EXECUTE,
    DECISION_MANUAL,
    OUTCOME_BLOCKED_RATE_LIMIT,
    OUTCOME_BLOCKED_REBOOT_WINDOW,
    OUTCOME_DRY_RUN,
    OUTCOME_ESCALATED,
    OUTCOME_EXECUTED,
    OUTCOME_FAILED,
    OUTCOME_MANUAL,
    Policy,
    TokenBucket,
    map_suggested_action,
)
from gpud_tpu_torch.sqlite import DB

logger = get_logger(__name__)

DEFAULT_INTERVAL = 30.0

# components whose REBOOT_SYSTEM suggestion has a cheaper soft repair the
# engine tries (and escalates from) before ever considering the host
# (components/gpu/runtime.py; the reference keys accelerator-tpu-runtime)
DEFAULT_SOFT_REPAIRS: Dict[str, str] = {
    "accelerator-gpu-runtime": ACTION_RESTART_RUNTIME,
}

_c_attempts = counter(
    "tpud_remediation_attempts_total",
    "remediation attempts by action and outcome "
    "(dry_run|executed|failed|blocked_*|escalated|manual)",
)
_h_decision = histogram(
    "tpud_remediation_decision_duration_seconds",
    "policy decision + execution latency per remediation attempt, by action",
)


class RemediationEngine:
    """One engine per daemon. ``scan_once`` is synchronous and injectable-
    clock deterministic; ``start`` runs it on its own cadence thread."""

    def __init__(
        self,
        registry,
        db: DB,
        policy: Optional[Policy] = None,
        event_store=None,
        reboot_event_store=None,
        interval_seconds: float = DEFAULT_INTERVAL,
        audit_retention_seconds: int = DEFAULT_RETENTION,
        soft_repairs: Optional[Dict[str, str]] = None,
        runtime_unit: str = "",
        run_command_fn=None,
        reboot_fn=None,
        writer=None,
    ) -> None:
        self.registry = registry
        self.policy = policy or Policy()
        self.event_store = event_store
        self.reboot_event_store = reboot_event_store
        self.interval = interval_seconds
        self.audit = AuditStore(
            db, retention_seconds=audit_retention_seconds, writer=writer
        )
        self.soft_repairs = (
            dict(DEFAULT_SOFT_REPAIRS) if soft_repairs is None else dict(soft_repairs)
        )
        self.executors = Executors(
            registry=registry,
            runtime_unit=runtime_unit,
            run_command_fn=run_command_fn,
            reboot_fn=reboot_fn,
        )
        self.time_now_fn = time.time
        self.bucket = TokenBucket(self.policy)
        # components escalated to HARDWARE_INSPECTION: no more retries
        # until the component is observed Healthy again
        self._escalated: Set[str] = set()
        self._mu = threading.Lock()
        self._last_scan: Optional[float] = None
        self._stop = threading.Event()
        self._poke = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._job = None  # scheduler Job when scheduler-driven

    # -- scan loop ---------------------------------------------------------
    def start(self, scheduler=None) -> None:
        """With a scheduler (the daemon path), the scan cadence is a heap
        job and the audit purger rides the server's consolidated
        ``retention-purge`` job — zero engine-owned threads. Without one,
        the legacy dedicated thread + per-store purger thread."""
        if scheduler is not None:
            if self._job is None and self._thread is None:
                # first scan waits out one interval like the legacy loop:
                # component first-checks must land before acting on states
                self._job = scheduler.add_job(
                    "remediation-scan",
                    self.scan_once,
                    interval=self.interval,
                    initial_delay=self.interval,
                )
            return
        if self._thread is not None:
            return
        self.audit.start_purger()
        self._thread = threading.Thread(
            target=self._loop, name="tpud-remediation", daemon=True
        )
        self._thread.start()

    def poke(self) -> None:
        if self._job is not None:
            self._job.poke()
            return
        self._poke.set()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._poke.wait(self.interval)
            self._poke.clear()
            if self._stop.is_set():
                return
            try:
                self.scan_once()
            except Exception:  # noqa: BLE001 — one bad scan must not end repair
                logger.exception("remediation scan failed")

    def close(self) -> None:
        if self._job is not None:
            self._job.cancel()
            self._job = None
        self._stop.set()
        self._poke.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self.audit.close()

    # -- one scan ----------------------------------------------------------
    def scan_once(self) -> List[Dict]:
        """Walk the registry once; returns the audit rows written (newest
        view of what this scan did — tests and the status view use it)."""
        now = self.time_now_fn()
        written: List[Dict] = []
        with self._mu:
            self._last_scan = now
            for comp in self.registry.all():
                # a component may be deregistered / mid-close while this
                # scan holds a reference to it (chaos campaigns, dynamic
                # registries): any failure is that component's problem,
                # recorded as a Warning event — the scan itself never dies
                name = ""
                try:
                    name = comp.name()
                    states = comp.last_health_states()
                    row = self._scan_component(name, states, now)
                except Exception as e:  # noqa: BLE001
                    name = name or comp.__class__.__name__
                    logger.exception("remediation scan of %s failed", name)
                    self._emit_scan_warning(name, e, now)
                    continue
                if row is not None:
                    written.append(row)
        return written

    def _emit_scan_warning(self, name: str, exc: Exception, now: float) -> None:
        es = self.event_store
        if es is None:
            return
        try:
            es.bucket(name).insert(
                Event(
                    component=name,
                    time=now,
                    name="remediation_scan_error",
                    type=EventType.WARNING,
                    message=(
                        f"component unavailable during remediation scan: "
                        f"{type(exc).__name__}: {exc}"
                    ),
                )
            )
        except Exception:  # noqa: BLE001 — accounting must not kill the scan
            logger.exception("scan-warning event emit failed for %s", name)

    def _scan_component(
        self, name: str, states, now: float
    ) -> Optional[Dict]:
        # a Healthy observation clears the stop-retrying latch: the fault
        # is gone (repaired out-of-band or self-cleared), so a future
        # diagnosis is a NEW episode that deserves fresh attempts
        if all(s.health == HealthStateType.HEALTHY for s in states):
            self._escalated.discard(name)
            return None
        for state in states:
            sa = state.suggested_actions
            if sa is None or state.health == HealthStateType.HEALTHY:
                continue
            for suggested in sa.repair_actions:
                action = map_suggested_action(
                    suggested, self.soft_repairs.get(name)
                )
                if action is None:
                    continue
                # one attempt per component per scan: the first actionable
                # suggestion wins (states arrive severity-ordered from the
                # component's own check)
                return self._attempt(name, state, suggested, action, now)
        return None

    def _attempt(
        self, name: str, state, suggested: str, action: str, now: float
    ) -> Optional[Dict]:
        if name in self._escalated:
            return None  # escalated: stop retrying until Healthy
        last = self.audit.last_attempt_time(
            name, exclude_action=ACTION_PREDICTED
        )
        if last is not None and now - last < self.policy.cooldown_seconds:
            return None  # in cooldown — not a new attempt, no audit noise
        t0 = time.monotonic()
        decision, outcome, detail, duration = self._decide_and_run(
            name, suggested, action, now
        )
        _h_decision.observe(time.monotonic() - t0, {"action": action})
        row = {
            "time": now,
            "component": name,
            "action": action,
            "suggested": suggested,
            "trigger_health": state.health,
            "trigger_reason": state.reason,
            "decision": decision,
            "outcome": outcome,
            "detail": detail,
            "duration_seconds": duration,
        }
        self.audit.record(
            component=name,
            action=action,
            suggested=suggested,
            trigger_health=state.health,
            trigger_reason=state.reason,
            decision=decision,
            outcome=outcome,
            detail=detail,
            duration_seconds=duration,
            ts=now,
        )
        _c_attempts.inc(labels={"action": action, "outcome": outcome})
        if outcome in (OUTCOME_EXECUTED, OUTCOME_FAILED, OUTCOME_ESCALATED):
            audit_log(
                "remediation_attempt",
                component=name,
                repair=action,
                outcome=outcome,
            )
            self._emit_event(name, action, outcome, detail, now)
        return row

    def _decide_and_run(self, name: str, suggested: str, action: str, now: float):
        """Returns (decision, outcome, detail, duration_seconds)."""
        if action == ACTION_INSPECTION:
            return (
                DECISION_MANUAL,
                OUTCOME_MANUAL,
                "hardware inspection required; no automated repair",
                0.0,
            )
        if not self.policy.is_enforced(action):
            return (
                DECISION_DRY_RUN,
                OUTCOME_DRY_RUN,
                f"{action} not in the enforce allowlist; no host mutation",
                0.0,
            )
        if not self.bucket.take(now):
            return (
                DECISION_BLOCKED_RATE_LIMIT,
                OUTCOME_BLOCKED_RATE_LIMIT,
                "global repair rate limit exhausted",
                0.0,
            )
        if action == ACTION_REBOOT:
            n = self.reboots_in_window(now)
            if n >= self.policy.max_reboots:
                return (
                    DECISION_BLOCKED_REBOOT_WINDOW,
                    OUTCOME_BLOCKED_REBOOT_WINDOW,
                    f"{n} reboot(s) already inside the "
                    f"{self.policy.reboot_window_seconds:g}s window "
                    f"(max {self.policy.max_reboots})",
                    0.0,
                )
        t0 = time.monotonic()
        ok, detail = self._execute(name, action)
        duration = time.monotonic() - t0
        if ok:
            return DECISION_EXECUTE, OUTCOME_EXECUTED, detail, duration
        # a soft repair standing in for REBOOT_SYSTEM that keeps failing
        # escalates to HARDWARE_INSPECTION instead of retrying forever
        if (
            suggested == RepairActionType.REBOOT_SYSTEM
            and action != ACTION_REBOOT
            and self._failed_attempts(name, now) + 1
            >= self.policy.escalation_threshold
        ):
            self._escalated.add(name)
            return (
                DECISION_ESCALATE,
                OUTCOME_ESCALATED,
                f"{self.policy.escalation_threshold} failed soft repairs "
                f"inside {self.policy.escalation_window_seconds:g}s; "
                f"escalating to hardware inspection (last: {detail})",
                duration,
            )
        return DECISION_EXECUTE, OUTCOME_FAILED, detail, duration

    def _execute(self, name: str, action: str):
        fn = getattr(self.executors, action, None)
        if fn is None:
            return False, f"no executor for action {action!r}"
        return fn(name)

    def _failed_attempts(self, name: str, now: float) -> int:
        return self.audit.count(
            component=name,
            outcomes=[OUTCOME_FAILED],
            since=now - self.policy.escalation_window_seconds,
        )

    def reboots_in_window(self, now: Optional[float] = None) -> int:
        """Completed reboots (event store) + engine-executed reboots
        (audit). Deliberately conservative: an executed reboot usually
        also produces a boot event next boot, and double-counting errs on
        the side of NOT reboot-cycling a node."""
        ts = self.time_now_fn() if now is None else now
        since = ts - self.policy.reboot_window_seconds
        n = 0
        if self.reboot_event_store is not None:
            try:
                n += len(self.reboot_event_store.get_reboot_events(since))
            except Exception:  # noqa: BLE001
                logger.exception("reboot event lookup failed")
        n += self.audit.count(
            action=ACTION_REBOOT, outcomes=[OUTCOME_EXECUTED], since=since
        )
        return n

    def _emit_event(
        self, name: str, action: str, outcome: str, detail: str, now: float
    ) -> None:
        es = self.event_store
        if es is None:
            return
        try:
            es.bucket(name).insert(
                Event(
                    component=name,
                    time=now,
                    name="remediation",
                    type=(
                        EventType.WARNING
                        if outcome != OUTCOME_EXECUTED
                        else EventType.INFO
                    ),
                    message=f"remediation {action}: {outcome} ({detail})",
                    extra_info={"action": action, "outcome": outcome},
                )
            )
        except Exception:  # noqa: BLE001 — accounting must not kill the scan
            logger.exception("remediation event emit failed for %s", name)

    # -- status ------------------------------------------------------------
    def status(self) -> Dict:
        """Policy + guard state rollup for HTTP/session/CLI views."""
        now = self.time_now_fn()
        return {
            "policy": self.policy.to_dict(),
            "escalated": sorted(self._escalated),
            "rate_tokens_available": round(self.bucket.available(now), 3),
            "reboots_in_window": self.reboots_in_window(now),
            "last_scan": self._last_scan,
            "interval_seconds": self.interval,
            "soft_repairs": dict(self.soft_repairs),
            "audit": self.audit.summary(),
        }
