"""Predict engine: online precursor scoring that warns before hard faults;
the port of ``gpud_tpu/predict/engine.py``.

One scheduler job (``predict-scan``) ticks every ``interval_seconds``,
pulls per-component features from traces the daemon already keeps —
check-latency drift from the ``tpud_component_check_duration_seconds``
histogram, transition cadence + state trajectory from the health ledger's
in-memory deques (:meth:`HealthLedger.recent_transitions`, barrier-free),
and kmsg error-class bigram novelty over a bounded eventstore window —
fuses them into a bounded [0, 1] precursor score, and runs the score
through per-component hysteresis:

  score >= threshold for ``arm_ticks`` consecutive ticks   → WARN
  score <= threshold - hysteresis for ``clear_ticks`` ticks → CLEAR

A warning emits, atomically from the operator's point of view:

- a ``predicted_degraded`` Warning event into the component's bucket;
- a ``predicted`` annotation the ledger merges into every subsequent
  check result (``Degraded(predicted)`` in /v1/states extra_info);
- a dry-run audit row (action ``predicted_warning``, suggested
  ``PREDICTED_DEGRADATION``) in the remediation ledger — predicted
  actions are NEVER auto-enforced: the suggestion maps to no executable
  action, the row pre-arms only the predict lane's own cooldown, and the
  reactive engine's cooldown anchor explicitly excludes it;
- an outbox publish (kind ``predict_score``) so the fleet plane can rank
  nodes most likely to fail next.

Lead time is measured per armed episode: the first reactive hard signal
after the warning (a ledger transition into Unhealthy, or the flap
window reaching the reactive flap threshold) closes the measurement and
lands in ``tpud_predict_lead_time_seconds``.

Deterministic by construction: injectable clock, no randomness, and
``tick_once`` is synchronous — tests and the chaos runner drive it
directly.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from gpud_tpu_torch.api.v1.types import (
    Event,
    EventType,
    HealthStateType,
    RepairActionType,
)
from gpud_tpu_torch.components.base import _h_check_duration
from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.metrics.registry import counter, gauge, histogram
from gpud_tpu_torch.predict.calibrate import (
    DEFAULT_CALIBRATE_INTERVAL,
    DEFAULT_HORIZON,
    DEFAULT_MARGIN,
    DEFAULT_MIN_HISTORY,
    DEFAULT_MIN_THRESHOLD,
    PREDICT_SCHEMA,
    ClassCalibration,
    ThresholdCalibrator,
    component_class,
)
from gpud_tpu_torch.predict.features import (
    FEATURE_WEIGHTS,
    LatencyDrift,
    NgramNovelty,
    cadence_score,
    fuse,
    peer_corroboration,
    trajectory_score,
)
from gpud_tpu_torch.remediation.policy import (
    ACTION_PREDICTED,
    DECISION_DRY_RUN,
    OUTCOME_DRY_RUN,
)

logger = get_logger(__name__)

DEFAULT_INTERVAL = 15.0
DEFAULT_THRESHOLD = 0.6
DEFAULT_HYSTERESIS = 0.15
DEFAULT_ARM_TICKS = 2
DEFAULT_CLEAR_TICKS = 3
DEFAULT_WINDOW = 600.0
DEFAULT_HISTORY_LIMIT = 256
DEFAULT_WARN_COOLDOWN = 300.0
DEFAULT_PUBLISH_INTERVAL = 60.0

EVENT_NAME_PREDICTED = "predicted_degraded"

_g_score = gauge(
    "tpud_predict_precursor_score",
    "fused precursor score in [0,1] (latency drift + transition cadence "
    "+ state trajectory + kmsg error-class novelty), by component",
)
_c_warnings = counter(
    "tpud_predict_warnings_total",
    "predictive Degraded(predicted) warnings emitted, by component",
)
_h_lead = histogram(
    "tpud_predict_lead_time_seconds",
    "seconds from a predictive warning to the first reactive hard signal "
    "(Unhealthy transition or flap-threshold trip), by component",
)
_h_tick = histogram(
    "tpud_predict_tick_duration_seconds",
    "wall time of one full predict scan over every component",
)
_g_threshold = gauge(
    "tpud_predict_threshold",
    "effective warning threshold (calibrated per component class, or "
    "the global default), by component",
)
_c_calibrations = counter(
    "tpud_predict_calibrations_total",
    "ledger-history calibration passes completed",
)


class _CompState:
    """Per-component scorer state: feature extractors, hysteresis
    counters, the armed-episode bookkeeping, and bounded score history."""

    __slots__ = (
        "latency", "ngram", "score", "features", "above", "below",
        "armed", "warned_at", "warn_score", "lead_seconds", "warnings",
        "history", "last_publish", "cleared_at",
    )

    def __init__(self, history_limit: int) -> None:
        self.latency = LatencyDrift()
        self.ngram = NgramNovelty()
        self.score = 0.0
        self.features: Dict[str, float] = {}
        self.above = 0
        self.below = 0
        self.armed = False
        self.warned_at: Optional[float] = None
        self.warn_score = 0.0
        self.lead_seconds: Optional[float] = None
        self.warnings = 0
        self.history: deque = deque(maxlen=max(1, history_limit))
        self.last_publish = 0.0
        self.cleared_at: Optional[float] = None


class PredictEngine:
    """One engine per daemon, wired like the remediation engine:
    constructed in ``daemon.Daemon``, ``start(scheduler)`` in the
    assembly block, ``close()`` on stop."""

    GUARDED_BY = {
        "_st": "_mu",
        "_ticks": "_mu",
        "_last_tick": "_mu",
        "_calib": "_mu",
        "_last_calibrate": "_mu",
    }
    _LOCK_FREE = {
        "_component_features": "caller tick_once() holds _mu across "
                               "the whole scoring pass",
        "_threshold_for": "callers hold _mu (tick pass / view methods)",
        "_weights_for": "callers hold _mu (tick pass / view methods)",
    }

    def __init__(
        self,
        registry=None,
        ledger=None,
        event_store=None,
        remediation=None,
        enabled: bool = True,
        interval_seconds: float = DEFAULT_INTERVAL,
        threshold: float = DEFAULT_THRESHOLD,
        hysteresis: float = DEFAULT_HYSTERESIS,
        arm_ticks: int = DEFAULT_ARM_TICKS,
        clear_ticks: int = DEFAULT_CLEAR_TICKS,
        window_seconds: float = DEFAULT_WINDOW,
        history_limit: int = DEFAULT_HISTORY_LIMIT,
        warn_cooldown_seconds: float = DEFAULT_WARN_COOLDOWN,
        publish_interval_seconds: float = DEFAULT_PUBLISH_INTERVAL,
        calibrate_enabled: bool = True,
        calibrate_interval_seconds: float = DEFAULT_CALIBRATE_INTERVAL,
        calibrate_min_history: int = DEFAULT_MIN_HISTORY,
        calibrate_min_threshold: float = DEFAULT_MIN_THRESHOLD,
        calibrate_margin: float = DEFAULT_MARGIN,
        calibrate_horizon_seconds: float = DEFAULT_HORIZON,
    ) -> None:
        self.registry = registry
        self.ledger = ledger
        self.event_store = event_store
        self.remediation = remediation
        self.enabled = enabled
        self.interval = interval_seconds
        self.threshold = threshold
        self.hysteresis = hysteresis
        self.arm_ticks = max(1, int(arm_ticks))
        self.clear_ticks = max(1, int(clear_ticks))
        self.window = window_seconds
        self.history_limit = history_limit
        self.warn_cooldown = warn_cooldown_seconds
        self.publish_interval = publish_interval_seconds
        self.calibrate_enabled = calibrate_enabled
        self.calibrate_interval = calibrate_interval_seconds
        self.calibrate_min_history = max(1, int(calibrate_min_history))
        self.calibrate_min_threshold = calibrate_min_threshold
        self.calibrate_margin = calibrate_margin
        self.calibrate_horizon = calibrate_horizon_seconds
        self.time_now_fn = time.time
        # optional score publisher (the server wires the session outbox
        # here); must never fail the tick
        self.on_publish = None
        # optional fabric plane (gpud_tpu_torch/fabric): when attached, the
        # NVLink component's feature set gains the neighbor co-occurrence signal
        self.fabric = None
        self._mu = threading.Lock()
        self._st: Dict[str, _CompState] = {}
        self._ticks = 0
        self._last_tick: Optional[float] = None
        self._calib: Dict[str, ClassCalibration] = {}
        self._last_calibrate: Optional[float] = None
        self._job = None  # scheduler Job when scheduler-driven
        self._calib_job = None

    # -- lifecycle ---------------------------------------------------------
    def start(self, scheduler=None) -> None:
        """Scheduler-driven only: the daemon always has one, and tests
        call :meth:`tick_once` directly. First tick waits out one
        interval so component first-checks land before scoring."""
        if not self.enabled or scheduler is None:
            return
        if self._job is None:
            self._job = scheduler.add_job(
                "predict-scan",
                self.tick_once,
                interval=self.interval,
                initial_delay=self.interval,
            )
        if self.calibrate_enabled and self._calib_job is None:
            # first fit runs one scan-interval after boot (the ledger's
            # persisted history is already there), then re-fits on the
            # calibrate cadence as new history accrues
            self._calib_job = scheduler.add_job(
                "predict-calibrate",
                self.calibrate_now,
                interval=self.calibrate_interval,
                initial_delay=self.interval,
            )

    def poke(self) -> None:
        """Scan now: poke the scheduler job, or tick synchronously when
        not scheduler-driven (tests, chaos expectation evaluation)."""
        if self._job is not None:
            self._job.poke()
        elif self.enabled:
            self.tick_once()

    def close(self) -> None:
        if self._job is not None:
            self._job.cancel()
            self._job = None
        if self._calib_job is not None:
            self._calib_job.cancel()
            self._calib_job = None

    def reset(self, component: str = "") -> None:
        """Drop the in-memory scorer state (one component, or all) and
        its ledger annotations. Chaos campaigns use this for isolation:
        a fresh drill must not inherit armed warnings or trained
        baselines from faults an earlier campaign injected."""
        with self._mu:
            names = (
                [component] if component else list(self._st.keys())
            )
            for name in names:
                self._st.pop(name, None)
        if self.ledger is not None:
            for name in names:
                self.ledger.clear_annotation(name, "predicted")
                self.ledger.clear_annotation(name, "predicted_score")

    # -- one tick ----------------------------------------------------------
    def tick_once(self) -> Dict[str, float]:
        """Score every registered component once; returns {name: score}."""
        if not self.enabled:
            return {}
        now = self.time_now_fn()
        t0 = time.monotonic()
        names: List[str] = []
        if self.registry is not None:
            try:
                names = list(self.registry.names())
            except Exception:  # noqa: BLE001
                logger.exception("predict: registry walk failed")
        out: Dict[str, float] = {}
        with self._mu:
            # pass 1: per-component base features + base score (no
            # co-occurrence yet — cooccur needs every peer's base)
            staged: List[tuple] = []
            bases: Dict[str, float] = {}
            for name in names:
                try:
                    st, features, transitions = self._component_features(
                        name, now
                    )
                except Exception:  # noqa: BLE001 — one component's
                    # featurizer bug must not end prediction for the rest
                    logger.exception("predict tick failed for %s", name)
                    continue
                bases[name] = fuse(features, self._weights_for(name))
                staged.append((name, st, features, transitions))
            # pass 2: cross-component co-occurrence, then fuse + hysteresis
            fab = self.fabric
            fabric_comp = (
                getattr(fab, "component_name", None)
                if fab is not None else None
            )
            for name, st, features, transitions in staged:
                try:
                    co = peer_corroboration(
                        name, bases,
                        self._cooccur_peers(name, bases, fabric_comp),
                    )
                    if co > 0.0:
                        features["cooccur"] = co
                    out[name] = self._score_component(
                        name, st, features, transitions, now, bases[name]
                    )
                except Exception:  # noqa: BLE001
                    logger.exception("predict tick failed for %s", name)
            self._ticks += 1
            self._last_tick = now
        _h_tick.observe(time.monotonic() - t0)
        return out

    @staticmethod
    def _cooccur_peers(
        name: str, bases: Dict[str, float], fabric_comp: Optional[str]
    ) -> List[str]:
        """Adjacency for cross-component co-occurrence: siblings of the
        same component class always corroborate each other; accelerator
        components and the NVLink fabric component corroborate both ways
        (they share the physical fabric the plane's link adjacency maps —
        a precursor on a GPU's NVLink port and a precursor on the GPU
        behind it are one story, not two)."""
        cls = component_class(name)
        peers = [
            p for p in bases
            if p != name and component_class(p) == cls
        ]
        accel = name.startswith("accelerator")
        if fabric_comp is not None and name != fabric_comp and accel:
            peers.append(fabric_comp)
        elif fabric_comp is not None and name == fabric_comp:
            peers.extend(
                p for p in bases
                if p != name and p.startswith("accelerator")
            )
        return peers

    def _threshold_for(self, name: str) -> float:
        cal = self._calib.get(component_class(name))
        if cal is not None and cal.source == "calibrated":
            return cal.threshold
        return self.threshold

    def _weights_for(self, name: str) -> Optional[Dict[str, float]]:
        cal = self._calib.get(component_class(name))
        if cal is not None and cal.source == "calibrated":
            return cal.weights
        return None

    def _component_features(self, name: str, now: float):
        """Base feature extraction for one component (no co-occurrence)."""
        st = self._st.get(name)
        if st is None:
            st = self._st[name] = _CompState(self.history_limit)
        labels = {"component": name}
        lat = st.latency.update(
            _h_check_duration.get_sum(labels),
            _h_check_duration.get_count(labels),
        )
        transitions: List[Dict] = []
        state_now: Optional[str] = None
        saturation = 5
        if self.ledger is not None:
            transitions = self.ledger.recent_transitions(name)
            ls = self.ledger.last_state(name)
            state_now = ls["state"] if ls else None
            saturation = max(2, int(self.ledger.flap_threshold))
        times = [t["time"] for t in transitions]
        cad = cadence_score(times, now, self.window, saturation=saturation)
        traj = trajectory_score(
            state_now,
            [(t["time"], t["from"], t["to"]) for t in transitions],
            now,
            self.window,
        )
        ng = st.ngram.update(self._error_classes(name, now))
        features = {
            "latency": lat, "cadence": cad, "trajectory": traj, "ngram": ng,
        }
        fab = self.fabric
        if fab is not None and name == getattr(fab, "component_name", None):
            try:
                features["fabric"] = fab.cooccurrence_score()
            except Exception:  # noqa: BLE001 — fabric must not fail the tick
                features["fabric"] = 0.0
        return st, features, transitions

    def _score_component(
        self, name: str, st: _CompState, features: Dict[str, float],
        transitions: List[Dict], now: float, base: float,
    ) -> float:
        # the base fusion already covered every feature unless pass 2
        # added co-occurrence evidence; only re-fuse when it did
        score = (
            fuse(features, self._weights_for(name))
            if "cooccur" in features else base
        )
        st.score = score
        st.features = features
        st.history.append((now, score))
        _g_score.set(score, {"component": name})
        thr = self._threshold_for(name)
        _g_threshold.set(thr, {"component": name})

        # hysteresis: the dead band between (threshold - hysteresis) and
        # threshold resets both streaks, so a score dithering inside it
        # can neither arm nor clear — the no-flap property
        if score >= thr:
            st.above += 1
            st.below = 0
        elif score <= thr - self.hysteresis:
            st.below += 1
            st.above = 0
        else:
            st.above = 0
            st.below = 0
        if not st.armed and st.above >= self.arm_ticks:
            self._warn(name, st, now, thr)
        elif st.armed and st.below >= self.clear_ticks:
            self._clear(name, st, now, thr)
        if st.armed:
            self._measure_lead(name, st, transitions)
            if self.ledger is not None:
                self.ledger.set_annotation(
                    name, "predicted_score", f"{score:.3f}"
                )
            if (
                self.publish_interval > 0
                and now - st.last_publish >= self.publish_interval
            ):
                self._publish(name, st, now, "snapshot")
        return score

    def _error_classes(self, name: str, now: float):
        """(ts, error_class) of kmsg-sourced events in the feature window,
        oldest first. Only rows carrying the raw ``kmsg`` line count as
        error events — that excludes the daemon's own accounting events
        (health_flapping, remediation, predicted_degraded) and makes the
        read backfill-safe: rows ingested before the ``error_class``
        stamp fall back to the event name."""
        if self.event_store is None:
            return []
        try:
            events = self.event_store.bucket(name).get(now - self.window)
        except Exception:  # noqa: BLE001
            logger.exception("predict: eventstore read failed for %s", name)
            return []
        out = []
        for ev in events:
            extra = ev.extra_info or {}
            if "kmsg" not in extra:
                continue
            out.append((ev.time, extra.get("error_class") or ev.name))
        out.sort(key=lambda p: p[0])
        return out

    # -- warning lifecycle -------------------------------------------------
    def _warn(
        self, name: str, st: _CompState, now: float, thr: float
    ) -> None:
        st.armed = True
        st.warned_at = now
        st.warn_score = st.score
        st.lead_seconds = None
        st.cleared_at = None
        st.warnings += 1
        _c_warnings.inc(labels={"component": name})
        detail = ", ".join(
            f"{k}={v:.3f}" for k, v in sorted(st.features.items())
        )
        logger.warning(
            "predict: %s precursor score %.3f >= %.2f (%s)",
            name, st.score, thr, detail,
        )
        if self.ledger is not None:
            self.ledger.set_annotation(name, "predicted", "true")
        self._emit_event(name, st, now, detail, thr)
        self._audit(name, st, now, detail, thr)
        self._publish(name, st, now, "warn")

    def _clear(
        self, name: str, st: _CompState, now: float, thr: float
    ) -> None:
        st.armed = False
        st.above = 0
        st.below = 0
        st.cleared_at = now
        if self.ledger is not None:
            self.ledger.clear_annotation(name, "predicted")
            self.ledger.clear_annotation(name, "predicted_score")
        logger.info(
            "predict: %s cleared (score %.3f <= %.3f)",
            name, st.score, thr - self.hysteresis,
        )
        self._publish(name, st, now, "clear")

    def _measure_lead(
        self, name: str, st: _CompState, transitions: List[Dict]
    ) -> None:
        """Close the armed episode's lead-time measurement on the first
        reactive hard signal at-or-after the warning: a transition into
        Unhealthy, or the in-window transition count reaching the
        reactive flap threshold."""
        if st.lead_seconds is not None or st.warned_at is None:
            return
        candidates: List[float] = []
        for t in transitions:
            if (
                t["to"] == HealthStateType.UNHEALTHY
                and t["time"] >= st.warned_at
            ):
                candidates.append(t["time"])
        if self.ledger is not None:
            thr = int(self.ledger.flap_threshold)
            asc = sorted(t["time"] for t in transitions)
            if len(asc) >= thr and asc[thr - 1] >= st.warned_at:
                candidates.append(asc[thr - 1])
        if not candidates:
            return
        st.lead_seconds = min(candidates) - st.warned_at
        _h_lead.observe(st.lead_seconds, {"component": name})
        logger.info(
            "predict: %s warning led the reactive detector by %.3fs",
            name, st.lead_seconds,
        )
        self._publish(name, st, self.time_now_fn(), "lead")

    def _emit_event(
        self, name: str, st: _CompState, now: float, detail: str,
        thr: float,
    ) -> None:
        if self.event_store is None:
            return
        try:
            self.event_store.bucket(name).insert(
                Event(
                    component=name,
                    time=now,
                    name=EVENT_NAME_PREDICTED,
                    type=EventType.WARNING,
                    message=(
                        f"precursor score {st.score:.3f} crossed "
                        f"{thr:g} ({detail})"
                    ),
                    extra_info={
                        "score": f"{st.score:.3f}",
                        "threshold": f"{thr:g}",
                        **{
                            k: f"{v:.3f}"
                            for k, v in sorted(st.features.items())
                        },
                    },
                )
            )
        except Exception:  # noqa: BLE001 — accounting must not kill ticks
            logger.exception("predict event emit failed for %s", name)

    def _audit(
        self, name: str, st: _CompState, now: float, detail: str,
        thr: float,
    ) -> None:
        """Dry-run audit row in the predict lane. Never consults the
        enforce allowlist and never executes anything: the suggestion is
        unmappable by design (policy.map_suggested_action returns None
        for PREDICTED_DEGRADATION). The row pre-arms the predict lane's
        own cooldown — anchored on the newest predicted row, surviving
        restarts via the ledger — so an oscillating score cannot spam
        audit rows; reactive cooldowns ignore this lane entirely."""
        rem = self.remediation
        if rem is None:
            return
        try:
            last = rem.audit.last_attempt_time(name, action=ACTION_PREDICTED)
            if last is not None and now - last < self.warn_cooldown:
                return
            rem.audit.record(
                component=name,
                action=ACTION_PREDICTED,
                suggested=RepairActionType.PREDICTED_DEGRADATION,
                trigger_health=HealthStateType.DEGRADED,
                trigger_reason=(
                    f"precursor score {st.score:.3f} >= {thr:g}"
                ),
                decision=DECISION_DRY_RUN,
                outcome=OUTCOME_DRY_RUN,
                detail=detail,
                ts=now,
            )
        except Exception:  # noqa: BLE001
            logger.exception("predict audit record failed for %s", name)

    def _publish(
        self, name: str, st: _CompState, now: float, kind: str
    ) -> None:
        hook = self.on_publish
        if hook is None:
            return
        st.last_publish = now
        try:
            hook({
                # versioned payload: the manager
                # ingests any schema <= PREDICT_SCHEMA and counts-but-
                # keeps newer ones, so a mixed-version fleet degrades to
                # accounting, never silent drops
                "schema": PREDICT_SCHEMA,
                "component": name,
                "component_class": component_class(name),
                "event": kind,
                "ts": now,
                "score": round(st.score, 4),
                "threshold": round(self._threshold_for(name), 4),
                "features": {
                    k: round(v, 4) for k, v in sorted(st.features.items())
                },
                "armed": st.armed,
                "warned_at": st.warned_at,
                "lead_seconds": st.lead_seconds,
            })
        except Exception:  # noqa: BLE001
            logger.exception("predict publish hook failed")

    # -- calibration -------------------------------------------------------
    def calibrate_now(self) -> Dict:
        """Fit per-class thresholds/weights by replaying the ledger's
        persisted transition history (docs/predict.md). The DB read runs
        outside ``_mu``; the fitted map swaps in atomically. Returns a
        {classes, calibrated} summary (scheduler job + tests + bench)."""
        if self.ledger is None:
            return {"classes": 0, "calibrated": 0}
        now = self.time_now_fn()
        calibrator = ThresholdCalibrator(
            ledger=self.ledger,
            default_threshold=self.threshold,
            window_seconds=self.window,
            min_history=self.calibrate_min_history,
            min_threshold=self.calibrate_min_threshold,
            margin=self.calibrate_margin,
            horizon_seconds=self.calibrate_horizon,
        )
        try:
            fitted = calibrator.calibrate(now)
        except Exception:  # noqa: BLE001 — calibration must never take
            # down the scan job; stale thresholds beat no thresholds
            logger.exception("predict calibration failed")
            return {"classes": 0, "calibrated": 0}
        with self._mu:
            self._calib = fitted
            self._last_calibrate = now
        _c_calibrations.inc()
        calibrated = sum(
            1 for c in fitted.values() if c.source == "calibrated"
        )
        if calibrated:
            logger.info(
                "predict: calibrated %d/%d component classes from "
                "ledger history", calibrated, len(fitted),
            )
        return {"classes": len(fitted), "calibrated": calibrated}

    def calibration(self) -> Dict:
        """Per-class fitted thresholds/weights + knobs + provenance —
        the one view behind /v1/predict/calibration, the session verb,
        SDK, and CLI."""
        with self._mu:
            classes = {
                cls: cal.as_dict()
                for cls, cal in sorted(self._calib.items())
            }
            last = self._last_calibrate
        return {
            "enabled": self.calibrate_enabled,
            "schema": PREDICT_SCHEMA,
            "default_threshold": self.threshold,
            "interval_seconds": self.calibrate_interval,
            "min_history": self.calibrate_min_history,
            "min_threshold": self.calibrate_min_threshold,
            "margin": self.calibrate_margin,
            "horizon_seconds": self.calibrate_horizon,
            "last_calibrate": last,
            "classes": classes,
        }

    # -- views -------------------------------------------------------------
    def scores(
        self, component: str = "", history_limit: int = 0
    ) -> Dict:
        """Per-component score snapshot (+ bounded per-component score
        history when ``history_limit`` > 0). The HTTP/session/SDK/CLI
        surfaces all serve this one view."""
        with self._mu:
            items = (
                {component: self._st[component]}
                if component and component in self._st
                else ({} if component else dict(self._st))
            )
            comps = {}
            for name, st in sorted(items.items()):
                d = {
                    "score": round(st.score, 4),
                    "component_class": component_class(name),
                    "threshold": round(self._threshold_for(name), 4),
                    "features": {
                        k: round(v, 4)
                        for k, v in sorted(st.features.items())
                    },
                    "armed": st.armed,
                    "warned_at": st.warned_at,
                    "cleared_at": st.cleared_at,
                    "warn_score": round(st.warn_score, 4),
                    "lead_seconds": st.lead_seconds,
                    "warnings": st.warnings,
                }
                if history_limit:
                    d["history"] = [
                        {"time": ts, "score": round(s, 4)}
                        for ts, s in list(st.history)[-history_limit:]
                    ]
                comps[name] = d
        return {
            "enabled": self.enabled,
            "threshold": self.threshold,
            "hysteresis": self.hysteresis,
            "components": comps,
        }

    def status(self) -> Dict:
        """Config + run-state rollup for status views."""
        with self._mu:
            armed = sorted(n for n, st in self._st.items() if st.armed)
            warnings_total = sum(st.warnings for st in self._st.values())
            tracked = len(self._st)
            ticks = self._ticks
            last_tick = self._last_tick
            calibrated = sum(
                1 for c in self._calib.values() if c.source == "calibrated"
            )
            last_calibrate = self._last_calibrate
        return {
            "enabled": self.enabled,
            "interval_seconds": self.interval,
            "threshold": self.threshold,
            "hysteresis": self.hysteresis,
            "arm_ticks": self.arm_ticks,
            "clear_ticks": self.clear_ticks,
            "window_seconds": self.window,
            "warn_cooldown_seconds": self.warn_cooldown,
            "feature_weights": dict(FEATURE_WEIGHTS),
            "schema": PREDICT_SCHEMA,
            "calibrate_enabled": self.calibrate_enabled,
            "classes_calibrated": calibrated,
            "last_calibrate": last_calibrate,
            "ticks": ticks,
            "last_tick": last_tick,
            "components_tracked": tracked,
            "armed": armed,
            "warnings_total": warnings_total,
        }
