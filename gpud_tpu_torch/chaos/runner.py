"""Chaos campaign runner: execute a scenario against the live daemon; the
port of ``gpud_tpu/chaos/runner.py``.

The runner expands each phase's timeline (scenario.py), fires every step
as a one-shot job on the unified scheduler pool (so chaos work is
watchdogged and accounted like any other daemon work), then evaluates the
phase's expectation block (expectations.py). Every mutation a fault makes
is undone through the campaign context's cleanup stack — a campaign
always leaves the daemon as it found it, pass or fail.

``ChaosManager`` is the daemon-side owner wired like every subsystem:
constructed by ``daemon.Daemon``, closed on stop, and surfaced through
``POST /v1/chaos/run`` + ``GET /v1/chaos/campaigns``, the
``chaosRun``/``chaosStatus`` session methods, the SDK, and ``tpud chaos``.
One campaign runs at a time; results land in a bounded in-memory history.

Self-metrics (docs/observability.md):
  tpud_chaos_steps_injected_total{scenario,action}
  tpud_chaos_expectations_total{scenario,outcome}
  tpud_chaos_detection_latency_seconds{scenario}
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from gpud_tpu_torch.chaos.expectations import counter_total, evaluate_phase
from gpud_tpu_torch.chaos.faults import ACTIONS
from gpud_tpu_torch.chaos.scenario import (
    Scenario,
    ScenarioError,
    expand_steps,
    load_scenario,
    shipped_scenarios,
)
from gpud_tpu_torch.log import audit as audit_log
from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.metrics.registry import counter, histogram

logger = get_logger(__name__)

# actions that *start* a fault: the phase's detection-latency clock is
# anchored at the first of these to fire
FAULT_ACTIONS = ("inject", "metric_ramp", "runtime_crash", "clock_skew",
                 "plane_disconnect", "plane_refuse",
                 "fabric_latency_ramp", "fabric_link_down")

STEP_WAIT_SECONDS = 60.0  # per-step completion ceiling on the pool

_c_steps = counter(
    "tpud_chaos_steps_injected_total",
    "chaos campaign steps executed, by scenario and action",
)
_c_expect = counter(
    "tpud_chaos_expectations_total",
    "chaos expectation evaluations, by scenario and outcome (passed|failed)",
)
_h_detect = histogram(
    "tpud_chaos_detection_latency_seconds",
    "fault-to-detection latency measured by chaos campaigns, by scenario",
)


class CampaignAborted(RuntimeError):
    """The daemon is shutting down mid-campaign."""


class _Context:
    """Mutable campaign state shared by faults and expectations."""

    def __init__(self, time_fn, sleep_fn, plane, detect_timeout: float) -> None:
        self.time_fn = time_fn
        self.sleep_fn = sleep_fn
        self.plane = plane
        self.detect_timeout = detect_timeout
        self.cleanups: List = []
        self.baseline: Dict[str, float] = {}
        self.campaign_start = 0.0
        self.phase_start = 0.0
        self.fault_t0: Optional[float] = None


class CampaignRunner:
    """Executes ONE scenario synchronously. ``time_fn``/``sleep_fn`` are
    injectable so the timeline logic is fake-clock testable."""

    def __init__(
        self,
        server,
        scenario: Scenario,
        plane=None,
        time_fn=None,
        sleep_fn=None,
        stop_event: Optional[threading.Event] = None,
    ) -> None:
        self.server = server
        self.scenario = scenario
        self.plane = plane
        self.time_fn = time_fn or time.time
        self._raw_sleep = sleep_fn or time.sleep
        self.stop_event = stop_event or threading.Event()

    def _sleep(self, seconds: float) -> None:
        """Chunked sleep that aborts promptly on daemon shutdown."""
        deadline = self.time_fn() + seconds
        while True:
            if self.stop_event.is_set():
                raise CampaignAborted("daemon stopping")
            remaining = deadline - self.time_fn()
            if remaining <= 0:
                return
            self._raw_sleep(min(0.05, remaining))

    def run(self) -> Dict:
        sc = self.scenario
        ctx = _Context(self.time_fn, self._sleep, self.plane, sc.detect_timeout)
        reg = self.server.metrics_registry
        ctx.baseline = {
            "failures": counter_total(reg, "tpud_scheduler_job_failures_total"),
            "watchdog": counter_total(reg, "tpud_scheduler_watchdog_fires_total"),
        }
        if self.plane is not None:
            # connect-attempt baseline: max_total_connects ceilings are
            # per-campaign deltas, not absolutes — a `--chaos all` run
            # accumulates plane counters across scenarios
            ctx.baseline["plane_attempts"] = (
                float(getattr(self.plane, "connects", 0))
                + float(getattr(self.plane, "refused", 0))
            )
        started = self.time_fn()
        ctx.campaign_start = started
        audit_log("chaos_campaign", scenario=sc.name)
        result: Dict = {
            "scenario": sc.name,
            "description": sc.description,
            "started": started,
            "phases": [],
            "passed": False,
            "error": "",
        }
        try:
            for phase in sc.phases:
                result["phases"].append(self._run_phase(phase, ctx))
        except CampaignAborted as e:
            result["error"] = str(e)
        except ScenarioError as e:
            result["error"] = str(e)
        finally:
            # undo every fault mutation, newest first, even on abort
            for undo in reversed(ctx.cleanups):
                try:
                    undo()
                except Exception:  # noqa: BLE001 — one undo must not skip the rest
                    logger.exception("chaos cleanup failed (%s)", sc.name)
            ctx.cleanups.clear()
        result["finished"] = self.time_fn()
        result["duration_seconds"] = round(result["finished"] - started, 3)
        result["passed"] = (
            not result["error"]
            and bool(result["phases"])
            and all(p["passed"] for p in result["phases"])
        )
        logger.info(
            "chaos campaign %s: %s (%d phase(s), %.1fs)",
            sc.name,
            "PASS" if result["passed"] else "FAIL",
            len(result["phases"]),
            result["duration_seconds"],
        )
        return result

    def _run_phase(self, phase, ctx: _Context) -> Dict:
        occurrences = expand_steps(
            phase.steps, key_prefix=f"{self.scenario.name}:{phase.name}"
        )
        ctx.phase_start = self.time_fn()
        ctx.fault_t0 = None
        step_errors: List[str] = []
        for occ in occurrences:
            due = ctx.phase_start + occ.offset
            now = self.time_fn()
            if due > now:
                self._sleep(due - now)
            if ctx.fault_t0 is None and occ.action in FAULT_ACTIONS:
                ctx.fault_t0 = self.time_fn()
            err = self._execute_step(occ, ctx)
            _c_steps.inc(
                labels={"scenario": self.scenario.name, "action": occ.action}
            )
            if err:
                step_errors.append(
                    f"step {occ.step_index}.{occ.occurrence} "
                    f"({occ.action}): {err}"
                )
        if phase.settle_seconds > 0:
            self._sleep(phase.settle_seconds)
        results = evaluate_phase(self.server, phase.expect, ctx)
        for r in results:
            _c_expect.inc(labels={
                "scenario": self.scenario.name,
                "outcome": "passed" if r.ok else "failed",
            })
            if r.kind == "detect" and r.latency_seconds is not None:
                _h_detect.observe(
                    r.latency_seconds, {"scenario": self.scenario.name}
                )
        passed = not step_errors and all(r.ok for r in results)
        return {
            "name": phase.name,
            "steps_executed": len(occurrences),
            "step_errors": step_errors,
            "expectations": [r.to_dict() for r in results],
            "passed": passed,
        }

    def _execute_step(self, occ, ctx: _Context) -> Optional[str]:
        """One step runs as a one-shot scheduler job (pool + watchdog);
        the runner waits for it so timeline ordering holds. Direct call
        when no scheduler exists (unit tests, scheduler-less servers)."""
        fn = ACTIONS.get(occ.action)
        if fn is None:
            return f"unknown action {occ.action!r}"
        holder: Dict[str, Optional[str]] = {"err": None}
        done = threading.Event()

        def run_step() -> None:
            try:
                holder["err"] = fn(self.server, occ.step, ctx)
            except Exception as e:  # noqa: BLE001 — a step crash is a finding, not a runner crash
                logger.exception(
                    "chaos step %s.%d (%s) raised",
                    occ.step_index, occ.occurrence, occ.action,
                )
                holder["err"] = f"{type(e).__name__}: {e}"
            finally:
                done.set()

        scheduler = getattr(self.server, "scheduler", None)
        name = (
            f"chaos:{self.scenario.name}:"
            f"{occ.step_index}.{occ.occurrence}:{occ.action}"
        )
        if scheduler is not None and scheduler.submit(name, run_step):
            if not done.wait(STEP_WAIT_SECONDS):
                return f"step did not complete within {STEP_WAIT_SECONDS:g}s"
        else:
            run_step()
        return holder["err"]


class ChaosManager:
    """Server-side campaign owner: loads scenarios, runs one campaign at
    a time (inline or as a scheduler job), keeps a bounded result
    history. ``plane`` may be attached by the bench/e2e harness to give
    plane_disconnect steps a fake control plane to storm."""

    # _stop is a threading.Event (internally synchronized); plane /
    # on_result are wired once at server construction, before any
    # campaign thread exists
    GUARDED_BY = {
        "_history": "_mu",
        "_running": "_mu",
        "_seq": "_mu",
    }

    def __init__(
        self,
        server,
        history_limit: int = 32,
        max_campaign_seconds: float = 300.0,
        extra_dirs: Optional[List[str]] = None,
    ) -> None:
        self.server = server
        self.max_campaign_seconds = max_campaign_seconds
        self.extra_dirs = list(extra_dirs or [])
        self.plane = None
        # optional campaign-result observer (the server wires the session
        # outbox here); must never fail the campaign path
        self.on_result = None
        self._mu = threading.Lock()
        self._history: deque = deque(maxlen=max(1, history_limit))
        self._running: Optional[Dict] = None
        self._seq = 0
        self._stop = threading.Event()

    # -- runs --------------------------------------------------------------
    def run_campaign(
        self, spec, wait: bool = True
    ) -> Tuple[Optional[Dict], Optional[str]]:
        """Run (wait=True) or launch (wait=False) a campaign. Returns
        (result-or-status, error)."""
        if self._stop.is_set():
            return None, "daemon stopping"
        try:
            sc = load_scenario(spec, extra_dirs=self.extra_dirs)
        except (ScenarioError, ValueError) as e:
            return None, str(e)
        except Exception as e:  # noqa: BLE001 — bad YAML/JSON must be a clean error
            return None, f"unreadable scenario: {e}"
        budget = sc.duration_estimate() + sc.detect_timeout * max(
            1, len(sc.phases)
        )
        if budget > self.max_campaign_seconds:
            return None, (
                f"scenario needs up to {budget:.0f}s; over the "
                f"{self.max_campaign_seconds:g}s campaign budget "
                "(chaos_max_campaign_seconds)"
            )
        with self._mu:
            if self._running is not None:
                return None, (
                    f"campaign {self._running['scenario']!r} already running"
                )
            self._seq += 1
            cid = self._seq
            status = {
                "id": cid,
                "scenario": sc.name,
                "running": True,
                "started": time.time(),
            }
            self._running = status
        runner = CampaignRunner(
            self.server, sc, plane=self.plane, stop_event=self._stop
        )

        def execute() -> Dict:
            try:
                result = runner.run()
            except Exception as e:  # noqa: BLE001 — the manager must survive any campaign
                logger.exception("chaos campaign %s crashed", sc.name)
                result = {
                    "scenario": sc.name,
                    "passed": False,
                    "error": f"{type(e).__name__}: {e}",
                    "phases": [],
                }
            result["id"] = cid
            with self._mu:
                self._running = None
                self._history.appendleft(result)
            hook = self.on_result
            if hook is not None:
                try:
                    hook(result)
                except Exception:  # noqa: BLE001
                    logger.exception("chaos on_result hook failed")
            return result

        if wait:
            return execute(), None
        scheduler = getattr(self.server, "scheduler", None)
        if scheduler is None or scheduler.submit(
            f"chaos-campaign:{sc.name}", execute,
            hang_timeout=0.0,  # campaigns legitimately outlast the watchdog
        ) is None:
            threading.Thread(
                target=execute, name=f"tpud-chaos-{sc.name}", daemon=True
            ).start()
        return dict(status), None

    # -- views -------------------------------------------------------------
    def campaigns(self, limit: int = 0) -> Dict:
        with self._mu:
            results = list(self._history)
            running = dict(self._running) if self._running else None
        if limit > 0:
            results = results[:limit]
        return {
            "running": running,
            "campaigns": results,
            "count": len(results),
            "scenarios": sorted(self.list_scenarios()),
        }

    def list_scenarios(self) -> Dict[str, str]:
        out = shipped_scenarios()
        import os

        for d in self.extra_dirs:
            if not os.path.isdir(d):
                continue
            for fn in sorted(os.listdir(d)):
                base, ext = os.path.splitext(fn)
                if ext in (".yaml", ".yml", ".json"):
                    out.setdefault(base, os.path.join(d, fn))
        return out

    def close(self) -> None:
        self._stop.set()
