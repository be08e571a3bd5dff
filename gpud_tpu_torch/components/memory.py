"""Memory component (reference: components/memory — gopsutil VM stats, OOM
kmsg matcher ported from cadvisor at kmsg_matcher.go:16-50, SetHealthy
support). The port of ``gpud_tpu/components/memory.py``, reading
``/proc/meminfo`` where it reads psutil (gpud_tpu_torch/procfs.py)."""

from __future__ import annotations

import re
from typing import Optional

from gpud_tpu_torch.api.v1.types import Event, EventType, HealthStateType
from gpud_tpu_torch.components.base import CheckResult, PollingComponent, TpudInstance
from gpud_tpu_torch.metrics.registry import gauge
from gpud_tpu_torch import procfs

NAME = "memory"

# OOM-killer patterns (reference: components/memory/kmsg_matcher.go:16-50)
OOM_RE = re.compile(
    r"(invoked oom-killer|Out of memory: Kill(?:ed)? process|Memory cgroup out of memory|oom_reaper: reaped process)",
    re.IGNORECASE,
)

_g_total = gauge("tpud_memory_total_bytes", "total physical memory")
_g_used = gauge("tpud_memory_used_bytes", "used physical memory")
_g_avail = gauge("tpud_memory_available_bytes", "available physical memory")
_g_used_pct = gauge("tpud_memory_used_percent", "used memory percent")

LABELS = {"component": NAME}


def match_oom(line: str) -> Optional[tuple]:
    if OOM_RE.search(line):
        return ("oom_kill", EventType.WARNING, line.strip())
    return None


class MemoryComponent(PollingComponent):
    NAME = NAME
    TAGS = ["host", "memory"]

    def __init__(self, instance: TpudInstance) -> None:
        super().__init__(instance)
        self.get_vm_fn = procfs.virtual_memory
        self._event_bucket = (
            instance.event_store.bucket(NAME) if instance.event_store else None
        )

    def check_once(self) -> CheckResult:
        vm = self.get_vm_fn()
        _g_total.set(vm.total, LABELS)
        _g_used.set(vm.used, LABELS)
        _g_avail.set(vm.available, LABELS)
        _g_used_pct.set(vm.percent, LABELS)

        health = HealthStateType.HEALTHY
        reason = f"used {vm.percent:.1f}% of {vm.total // (1 << 30)} GiB"
        if vm.percent >= 95.0:
            health = HealthStateType.DEGRADED
            reason = f"memory pressure: {vm.percent:.1f}% used"
        return CheckResult(
            self.NAME,
            health=health,
            reason=reason,
            extra_info={
                "total_bytes": str(vm.total),
                "used_bytes": str(vm.used),
                "available_bytes": str(vm.available),
                "used_percent": f"{vm.percent:.1f}",
            },
        )

    def events(self, since: float):
        if self._event_bucket is None:
            return []
        return self._event_bucket.get(since)

    def set_healthy(self) -> None:
        """Reference: components/memory/set_healthy.go — drop recorded OOM
        events so state re-evaluates clean."""
        if self._event_bucket is not None:
            self._event_bucket.insert(
                Event(component=NAME, name="SetHealthy", type=EventType.INFO,
                      message="operator set-healthy")
            )
