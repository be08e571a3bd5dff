"""Component model and registry (NVIDIA GPU edition).

The component model is the heart of the daemon: every health check is a
``Component`` that the registry owns and the server/scan paths drive
(reference: components/types.go:20-107, components/registry.go:24-226).

Design notes:
- ``TpudInstance`` is the dependency-injection container handed to every
  component constructor (reference: components/registry.go:24-104 GPUdInstance).
- ``PollingComponent`` implements the shared 1-minute self-ticker pattern
  (reference: components/accelerator/nvidia/temperature/component.go:81-97) so
  concrete components only implement ``check_once``.
- A component's externals are function-valued attributes so tests can swap
  them without mocking frameworks (reference test strategy, SURVEY §4.1).
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, TYPE_CHECKING

from gpud_tpu_torch.api.v1.types import (
    Event,
    EventType,
    HealthState,
    HealthStateType,
    SuggestedActions,
)
from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.metrics.registry import counter, gauge, histogram
from gpud_tpu_torch import tracing
from gpud_tpu_torch.tracing import DEFAULT_TRACER

if TYPE_CHECKING:  # avoid import cycles at runtime
    from gpud_tpu_torch.eventstore import EventStore
    from gpud_tpu_torch.gpu.instance import GPUInstance

logger = get_logger(__name__)

DEFAULT_POLL_INTERVAL = 60.0  # seconds (reference: temperature/component.go:83)

# self-observability: every component check is measured (tentpole of the
# observability layer; reference direction: pkg/metrics/recorder)
_h_check_duration = histogram(
    "tpud_component_check_duration_seconds",
    "wall time of one component check, by component and outcome",
)
_c_checks = counter(
    "tpud_component_check_total",
    "component checks by component and status (success|failure)",
)
_g_last_check = gauge(
    "tpud_component_last_check_unix_seconds",
    "unix time the component last completed a check (staleness signal)",
)


class AlreadyRegisteredError(Exception):
    pass


class FailureInjector:
    """Test-only failure injection knobs threaded through TpudInstance
    (reference: components/registry.go:77-104)."""

    def __init__(
        self,
        gpu_ids_lost: Optional[List[int]] = None,
        gpu_ids_requires_reset: Optional[List[int]] = None,
        gpu_ids_memory_ecc_pending: Optional[List[int]] = None,
        gpu_ids_thermal_slowdown: Optional[List[int]] = None,
        nvlink_links_down: Optional[List[str]] = None,
        gpu_enumeration_error: bool = False,
        product_name_override: str = "",
    ) -> None:
        self.gpu_ids_lost = gpu_ids_lost or []
        self.gpu_ids_requires_reset = gpu_ids_requires_reset or []
        self.gpu_ids_memory_ecc_pending = gpu_ids_memory_ecc_pending or []
        self.gpu_ids_thermal_slowdown = gpu_ids_thermal_slowdown or []
        self.nvlink_links_down = nvlink_links_down or []
        self.gpu_enumeration_error = gpu_enumeration_error
        self.product_name_override = product_name_override

    def empty(self) -> bool:
        return not (
            self.gpu_ids_lost
            or self.gpu_ids_requires_reset
            or self.gpu_ids_memory_ecc_pending
            or self.gpu_ids_thermal_slowdown
            or self.nvlink_links_down
            or self.gpu_enumeration_error
            or self.product_name_override
        )


class TpudInstance:
    """DI container for component constructors
    (reference: components/registry.go:24-104)."""

    def __init__(
        self,
        machine_id: str = "",
        gpu_instance: Optional["GPUInstance"] = None,
        db_rw=None,
        db_ro=None,
        event_store: Optional["EventStore"] = None,
        reboot_event_store=None,
        mount_points: Optional[List[str]] = None,
        mount_targets: Optional[List[str]] = None,
        kernel_modules_to_check: Optional[List[str]] = None,
        kmsg_path: str = "",
        failure_injector: Optional[FailureInjector] = None,
        config=None,
        health_ledger=None,
        scheduler=None,
    ) -> None:
        self.machine_id = machine_id
        self.gpu_instance = gpu_instance
        self.db_rw = db_rw
        self.db_ro = db_ro
        self.event_store = event_store
        self.reboot_event_store = reboot_event_store
        self.mount_points = mount_points or []
        self.mount_targets = mount_targets or []
        self.kernel_modules_to_check = kernel_modules_to_check or []
        self.kmsg_path = kmsg_path
        self.failure_injector = failure_injector
        self.config = config
        # health-transition ledger (None in scan mode — like event_store,
        # one-shot scans record no persistent timeline)
        self.health_ledger = health_ledger
        # unified check scheduler (the daemon's scheduler): when present,
        # PollingComponent.start() registers a heap job instead of
        # spawning a dedicated poller thread. None (standalone/test/scan
        # use) keeps the legacy thread-per-poller path.
        self.scheduler = scheduler
        # cross-component fast path: the kmsg pipeline (inotify, ~ms) calls
        # these on fabric-class catalog matches so pollers can open an
        # adaptive fast-poll window instead of waiting out their cadence
        # (listeners take the catalog error name; see components/gpu/nvlink.py)
        self.fabric_suspicion_listeners: List[Callable[[str], None]] = []


class CheckResult:
    """Result of one component check (reference: components/types.go:85-101).

    Concrete components may subclass to attach structured payloads; the base
    carries the health state list which is all the server needs.
    """

    def __init__(
        self,
        component_name: str,
        health: str = HealthStateType.HEALTHY,
        reason: str = "",
        error: str = "",
        suggested_actions: Optional[SuggestedActions] = None,
        extra_info: Optional[Dict[str, str]] = None,
        component_type: str = "",
        run_mode: str = "",
        raw_output: str = "",
        states: Optional[List[HealthState]] = None,
    ) -> None:
        self._component_name = component_name
        self.health = health
        self.reason = reason
        self.error = error
        self.suggested_actions = suggested_actions
        self.extra_info = extra_info or {}
        self.component_type = component_type
        self.run_mode = run_mode
        self.raw_output = raw_output
        self.time = time.time()
        self._states = states

    def component_name(self) -> str:
        return self._component_name

    def summary(self) -> str:
        return self.reason or ("ok" if self.health == HealthStateType.HEALTHY else self.health)

    def health_state_type(self) -> str:
        return self.health

    def health_states(self) -> List[HealthState]:
        if self._states is not None:
            return list(self._states)
        return [
            HealthState(
                time=self.time,
                component=self._component_name,
                component_type=self.component_type,
                name=self._component_name,
                run_mode=self.run_mode,
                health=self.health,
                reason=self.reason,
                error=self.error,
                suggested_actions=self.suggested_actions,
                extra_info=dict(self.extra_info),
                raw_output=self.raw_output,
            )
        ]

    def __str__(self) -> str:
        return self.summary()


class Component:
    """Base component (reference: components/types.go:20-67).

    Subclasses must set ``NAME`` and implement ``check_once() -> CheckResult``.
    Optional capabilities mirror the reference's optional interfaces:
    ``can_deregister()`` (Deregisterable), ``set_healthy()`` (HealthSettable).
    """

    NAME = ""
    TAGS: List[str] = []

    def __init__(self, instance: TpudInstance) -> None:
        self.instance = instance
        self._last_mu = threading.Lock()
        self._last_check_result: Optional[CheckResult] = None
        self._last_check_duration = 0.0

    # -- identity ----------------------------------------------------------
    def name(self) -> str:
        return self.NAME

    def tags(self) -> List[str]:
        return list(self.TAGS)

    def is_supported(self) -> bool:
        return True

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """Called at server start; spawn pollers here."""

    def close(self) -> None:
        """Called at server shutdown."""

    # -- checking ----------------------------------------------------------
    def check_once(self) -> CheckResult:
        raise NotImplementedError

    def check(self) -> CheckResult:
        """Run the check, trapping exceptions into an Unhealthy result so a
        crashing data source never takes the poller loop down. Every check
        is measured: duration histogram + success/failure counter + a trace
        span in the ring (sqlite leaves nest under it)."""
        t0 = time.monotonic()
        raised = False
        # one correlation id per check run: stamped on the root span AND
        # held in the tracing thread-local across the ledger observe()
        # below (which fires transition hooks after the span closes) —
        # the outbox producers read it so the manager can stitch a fleet
        # event back to this exact trace
        cid = tracing.new_correlation_id()
        tracing.set_correlation_id(cid)
        try:
            with DEFAULT_TRACER.span("component.check", component=self.NAME) as sp:
                sp.set_attr("correlation_id", cid)
                try:
                    cr = self.check_once()
                except Exception as e:  # noqa: BLE001 — health checks must not raise
                    raised = True
                    logger.exception("component %s check failed", self.NAME)
                    cr = CheckResult(
                        component_name=self.NAME,
                        health=HealthStateType.UNHEALTHY,
                        reason=f"check failed: {e}",
                        error=traceback.format_exc(limit=5),
                    )
                sp.set_attr("health", cr.health)
                if cr.reason:
                    sp.set_attr("reason", cr.reason[:200])
                if raised:
                    sp.status = "error"
                    sp.error = cr.reason[:500]
            duration = time.monotonic() - t0
            ok = not raised and cr.health == HealthStateType.HEALTHY
            _h_check_duration.observe(duration, {"component": self.NAME})
            _c_checks.inc(
                labels={
                    "component": self.NAME,
                    "status": "success" if ok else "failure",
                }
            )
            _g_last_check.set(time.time(), {"component": self.NAME})
            ledger = getattr(self.instance, "health_ledger", None)
            if ledger is not None:
                try:
                    annotations = ledger.observe(self.NAME, cr.health, cr.reason)
                    if annotations:
                        cr.extra_info.update(annotations)
                except Exception:  # noqa: BLE001 — accounting must not fail checks
                    logger.exception("health ledger observe failed for %s", self.NAME)
        finally:
            tracing.clear_correlation_id()
        self._last_check_duration = duration
        with self._last_mu:
            self._last_check_result = cr
        return cr

    def last_health_states(self) -> List[HealthState]:
        """Latest cached health states; Healthy-by-default before first check
        (reference: components/types.go:54-58)."""
        with self._last_mu:
            cr = self._last_check_result
        if cr is None:
            return [
                HealthState(
                    component=self.NAME,
                    name=self.NAME,
                    health=HealthStateType.INITIALIZING,
                    reason="no check performed yet",
                )
            ]
        return cr.health_states()

    def events(self, since: float) -> List[Event]:
        return []

    # -- optional capabilities --------------------------------------------
    def can_deregister(self) -> bool:
        return False


class PollingComponent(Component):
    """Component with the shared periodic-check pattern
    (reference: components/accelerator/nvidia/temperature/component.go:81-97).

    With a scheduler on the instance (the daemon path), ``start()``
    registers a deadline-heap job on the shared bounded pool — no thread
    is spawned, the first check runs on the pool off the startup path,
    and a hung check is watchdogged into a Degraded-stale cached result
    while the pool keeps draining. Without one (standalone components in
    tests/benches, scan mode), the legacy dedicated ``tpud-poll-<name>``
    thread is kept.

    ``time_now_fn`` / ``sleep interval`` are injectable for tests.
    """

    POLL_INTERVAL = DEFAULT_POLL_INTERVAL
    # a check slower than SLOW_CHECK_FACTOR × poll_interval() can't keep its
    # cadence; emit a Warning event so the control plane sees WHICH check is
    # dragging (rate-limited: one event per cooldown window, not per cycle)
    SLOW_CHECK_FACTOR = 1.0
    SLOW_CHECK_EVENT_COOLDOWN = 300.0

    def __init__(self, instance: TpudInstance) -> None:
        super().__init__(instance)
        self._stop_event = threading.Event()
        self._poke_event = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._job = None  # scheduler Job when scheduler-driven
        self._last_slow_event_at = 0.0
        self.time_now_fn: Callable[[], float] = time.time

    def start(self) -> None:
        scheduler = getattr(self.instance, "scheduler", None)
        if scheduler is not None:
            if self._job is not None:
                return
            self._job = scheduler.add_job(
                f"component:{self.NAME}",
                self._scheduled_run,
                interval_fn=self.poll_interval,
                on_hang=self._mark_check_stale,
            )
            return
        if self._thread is not None:
            return
        self._stop_event.clear()
        self._thread = threading.Thread(
            target=self._loop, name=f"tpud-poll-{self.NAME}", daemon=True
        )
        self._thread.start()

    def poll_interval(self) -> float:
        """Next sleep; override for adaptive cadences (e.g. the NVLink
        component's fast-poll-on-suspicion window). Re-read by the
        scheduler after every run."""
        return self.POLL_INTERVAL

    def poke(self) -> None:
        """Wake the poller now (event-triggered check instead of waiting
        out the cadence)."""
        if self._job is not None:
            self._job.poke()
            return
        self._poke_event.set()

    def _scheduled_run(self) -> None:
        """One scheduler-dispatched cycle: the body of one loop turn."""
        self.check()
        self._report_if_slow()

    def _mark_check_stale(self, elapsed: float) -> None:
        """Watchdog callback: the in-flight check blew its hang budget.
        Publish a Degraded-stale cached state (the staleness is the
        finding — the data source is wedged) without waiting for the
        stuck call; when the real check eventually returns, its result
        overwrites this marker."""
        cr = CheckResult(
            component_name=self.NAME,
            health=HealthStateType.DEGRADED,
            reason=(
                f"check stale: still running after {elapsed:.0f}s "
                "(watchdog fired; data source presumed wedged)"
            ),
        )
        with self._last_mu:
            self._last_check_result = cr

    def _loop(self) -> None:
        # first check runs inside the poller thread so a hung data source
        # can never wedge daemon startup (reference runs the initial Check in
        # the spawned goroutine, temperature/component.go:81-97)
        self.check()
        self._report_if_slow()
        while not self._stop_event.is_set():
            self._poke_event.wait(self.poll_interval())
            self._poke_event.clear()
            if self._stop_event.is_set():
                return
            self.check()
            self._report_if_slow()

    def _report_if_slow(self) -> None:
        """After-the-fact answer to 'why was this check slow': a check that
        outran its own cadence becomes a Warning event in the eventstore,
        carrying the measured duration (which /v1/debug/traces can then
        break down span-by-span)."""
        duration = self._last_check_duration
        threshold = self.SLOW_CHECK_FACTOR * self.poll_interval()
        es = getattr(self.instance, "event_store", None)
        if es is None or threshold <= 0 or duration <= threshold:
            return
        now = self.time_now_fn()
        if now - self._last_slow_event_at < self.SLOW_CHECK_EVENT_COOLDOWN:
            return
        self._last_slow_event_at = now
        try:
            es.bucket(self.NAME).insert(
                Event(
                    component=self.NAME,
                    time=now,
                    name="slow_check",
                    type=EventType.WARNING,
                    message=(
                        f"check took {duration:.3f}s, over "
                        f"{self.SLOW_CHECK_FACTOR:g}x the {self.poll_interval():g}s "
                        "poll interval"
                    ),
                    extra_info={
                        "duration_seconds": f"{duration:.6f}",
                        "poll_interval_seconds": f"{self.poll_interval():g}",
                    },
                )
            )
        except Exception:  # noqa: BLE001 — observability must not kill the poller
            logger.exception("slow-check event emit failed for %s", self.NAME)

    def close(self) -> None:
        if self._job is not None:
            self._job.cancel()
            self._job = None
        self._stop_event.set()
        self._poke_event.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


InitFunc = Callable[[TpudInstance], Component]


class Registry:
    """Thread-safe name→Component registry
    (reference: components/registry.go:106-226)."""

    def __init__(self, instance: TpudInstance) -> None:
        self._mu = threading.RLock()
        self._instance = instance
        self._components: Dict[str, Component] = {}

    def must_register(self, init_func: InitFunc) -> Component:
        c, err = self.register(init_func)
        if err is not None:
            raise err
        assert c is not None
        return c

    def register(self, init_func: InitFunc):
        try:
            c = init_func(self._instance)
        except Exception as e:  # noqa: BLE001
            return None, e
        with self._mu:
            if c.name() in self._components:
                return None, AlreadyRegisteredError(c.name())
            self._components[c.name()] = c
        return c, None

    def all(self) -> List[Component]:
        with self._mu:
            return [self._components[k] for k in sorted(self._components)]

    def get(self, name: str) -> Optional[Component]:
        with self._mu:
            return self._components.get(name)

    def deregister(self, name: str) -> Optional[Component]:
        with self._mu:
            return self._components.pop(name, None)

    def names(self) -> List[str]:
        with self._mu:
            return sorted(self._components)
