"""GPU kernel-error component — the Xid/SXid component.

The port of ``gpud_tpu/components/tpu/error_kmsg.py``. Reference:
components/accelerator/nvidia/xid — kmsg regex + catalog; event-sourced
health merging reboot events with error events and escalating suggested
actions via per-error reboot thresholds (component.go:400-650); SetHealthy
trims history (636-650); daemon mode consumes the follow watcher, scan mode
reads the whole ring buffer (component.go:214-265).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from gpud_tpu_torch.api.v1.types import Event, EventType
from gpud_tpu_torch.components.base import CheckResult, Component, TpudInstance
from gpud_tpu_torch.components.gpu import catalog
from gpud_tpu_torch.components.gpu.health_state import (
    EVENT_NAME_SET_HEALTHY,
    evolve_health,
)
from gpud_tpu_torch.kmsg.syncer import MatchFunc, Syncer
from gpud_tpu_torch.kmsg.watcher import read_all
from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.metrics.registry import counter

NAME = "accelerator-gpu-error-kmsg"

logger = get_logger(__name__)

_c_errors = counter("tpud_gpu_kmsg_errors_total", "matched GPU kernel errors")

DEFAULT_LOOKBACK_SECONDS = 14 * 86400  # events retention window
UPDATE_INTERVAL = 30.0  # state re-evaluation ticker (reference: component.go 30s)


def _gpu_extra(gpu_id: Optional[int]) -> Dict[str, str]:
    return {"gpu": str(gpu_id)} if gpu_id is not None else {}


def kmsg_match(bdf_to_index: Optional[Dict[catalog.PCIKey, int]] = None) -> MatchFunc:
    """MatchFunc for the shared kmsg watcher over the host's PCI map
    (``catalog.bdf_map`` of the adapter's GPUs). It forwards the GPU the
    matcher attributed, so evolve_health's per-GPU tracks read it from
    extra_info instead of re-parsing the line every evaluation."""

    def match(line: str) -> Optional[tuple]:
        m = catalog.match(line, bdf_to_index)
        if m is None:
            return None
        return (m.entry.name, m.entry.event_type, line.strip(), _gpu_extra(m.gpu_id) or None)

    return match


class GPUErrorKmsgComponent(Component):
    NAME = NAME
    TAGS = ["accelerator", "gpu", "kmsg"]

    def __init__(self, instance: TpudInstance) -> None:
        super().__init__(instance)
        self._event_bucket = (
            instance.event_store.bucket(NAME) if instance.event_store else None
        )
        self.reboot_event_store = instance.reboot_event_store
        self.lookback_seconds = DEFAULT_LOOKBACK_SECONDS
        # per-error-name reboot-threshold overrides pushed via updateConfig
        self.reboot_threshold_overrides: dict = {}
        self.time_now_fn: Callable[[], float] = time.time
        self._stop = threading.Event()
        self._ticker: Optional[threading.Thread] = None
        self._job = None  # scheduler Job when scheduler-driven
        gpu = instance.gpu_instance
        # an Xid line names its GPU by PCI address; a card whose NVML gives
        # no PCI info leaves the map empty and such lines host-wide
        self.bdf_to_index = (
            catalog.bdf_map(gpu.devices()) if gpu is not None and gpu.gpu_lib_exists() else {}
        )
        self.syncer: Optional[Syncer] = None
        if self._event_bucket is not None:
            self.syncer = Syncer(
                kmsg_match(self.bdf_to_index), self._event_bucket, on_event=self._on_event
            )

    def is_supported(self) -> bool:
        # supported wherever kmsg is readable; on non-GPU hosts it simply
        # never matches (cheap regex on the shared watcher). In scan mode
        # (no event store) check_once reads the whole ring buffer instead
        # (reference: xid/component.go:214-265).
        return True

    # -- event path --------------------------------------------------------
    def _on_event(self, ev: Event) -> None:
        _c_errors.inc(labels={"component": NAME, "error": ev.name})
        # NVLink-class matches open the NVLink component's fast-poll window —
        # the kmsg path is ~ms, so NVML confirmation starts now instead of
        # at the next 60s tick (see nvlink.py raise_suspicion)
        for listener in self.instance.fabric_suspicion_listeners:
            try:
                listener(ev.name)
            except Exception:  # noqa: BLE001 — a listener bug must not
                pass           # break error recording
        self.check()

    def start(self) -> None:
        # the SharedWatcher (server-owned) feeds self.syncer; here we only
        # run the periodic re-evaluation ticker (reference: component.go
        # updateCurrentState every 30s) — a scheduler job in the daemon,
        # a dedicated thread only in scheduler-less standalone use
        scheduler = getattr(self.instance, "scheduler", None)
        if scheduler is not None:
            if self._job is None:
                self._job = scheduler.add_job(
                    f"component:{NAME}", self.check, interval=UPDATE_INTERVAL
                )
            return
        if self._ticker is not None:
            return
        self._stop.clear()
        self._ticker = threading.Thread(
            target=self._tick_loop, name=f"tpud-{NAME}-ticker", daemon=True
        )
        self._ticker.start()

    def _tick_loop(self) -> None:
        self.check()
        while not self._stop.wait(UPDATE_INTERVAL):
            self.check()

    def close(self) -> None:
        if self._job is not None:
            self._job.cancel()
            self._job = None
        self._stop.set()
        if self._ticker is not None:
            self._ticker.join(timeout=2.0)
            self._ticker = None

    # -- health evaluation -------------------------------------------------
    def _merged_events(self) -> List[Event]:
        since = self.time_now_fn() - self.lookback_seconds
        evs: List[Event] = []
        if self._event_bucket is not None:
            evs.extend(self._event_bucket.get(since))
        if self.reboot_event_store is not None:
            evs.extend(self.reboot_event_store.get_reboot_events(since))
        return evs

    def check_once(self) -> CheckResult:
        if self._event_bucket is None:
            # scan mode (no event store): read the whole ring buffer now
            # (reference: xid/component.go:214-265 scan path)
            found = []
            for msg in read_all():
                m = catalog.match(msg.message, self.bdf_to_index)
                if m is not None:
                    found.append(
                        Event(
                            component=NAME,
                            time=msg.time,
                            name=m.entry.name,
                            type=m.entry.event_type,
                            message=msg.message,
                            extra_info=_gpu_extra(m.gpu_id),
                        )
                    )
            ev = evolve_health(found, self.reboot_threshold_overrides)
            return CheckResult(
                self.NAME,
                health=ev.health,
                reason=ev.reason or "no GPU errors in kmsg ring buffer",
                suggested_actions=ev.suggested_actions,
            )
        ev = evolve_health(self._merged_events(), self.reboot_threshold_overrides)
        extra = {name: str(n) for name, n in ev.active_errors.items()}
        return CheckResult(
            self.NAME,
            health=ev.health,
            reason=ev.reason,
            suggested_actions=ev.suggested_actions,
            extra_info=extra,
        )

    def events(self, since: float):
        if self._event_bucket is None:
            return []
        return self._event_bucket.get(since)

    # -- operator actions --------------------------------------------------
    def set_healthy(self) -> None:
        """Insert a SetHealthy marker: evolve_health clears everything
        before it (reference: xid/set_healthy.go + component.go:636-650)."""
        if self._event_bucket is not None:
            self._event_bucket.insert(
                Event(
                    component=NAME,
                    time=self.time_now_fn(),
                    name=EVENT_NAME_SET_HEALTHY,
                    type=EventType.INFO,
                    message="operator set-healthy",
                )
            )
        self.check()
