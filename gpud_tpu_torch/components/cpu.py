"""CPU component (reference: components/cpu — gopsutil times/load, kmsg
CPU-lockup matcher at component.go:50-83). The port of
``gpud_tpu/components/cpu.py``, reading ``/proc`` where it reads psutil
(gpud_tpu_torch/procfs.py)."""

from __future__ import annotations

import os
import re
from typing import Optional

from gpud_tpu_torch.api.v1.types import EventType, HealthStateType
from gpud_tpu_torch.components.base import CheckResult, PollingComponent, TpudInstance
from gpud_tpu_torch.metrics.registry import gauge
from gpud_tpu_torch import procfs

NAME = "cpu"

# kernel soft/hard lockup lines (reference: components/cpu kmsg matcher)
LOCKUP_RE = re.compile(
    r"(soft lockup|hard LOCKUP|watchdog: BUG: soft lockup|hung_task|blocked for more than \d+ seconds)",
    re.IGNORECASE,
)

_g_usage = gauge("tpud_cpu_usage_percent", "total CPU usage percent")
_g_load1 = gauge("tpud_cpu_load_avg_1m", "1-minute load average")
_g_load5 = gauge("tpud_cpu_load_avg_5m", "5-minute load average")
_g_load15 = gauge("tpud_cpu_load_avg_15m", "15-minute load average")

LABELS = {"component": NAME}


def match_cpu_lockup(line: str) -> Optional[tuple]:
    if LOCKUP_RE.search(line):
        return ("cpu_lockup", EventType.CRITICAL, line.strip())
    return None


class CPUComponent(PollingComponent):
    NAME = NAME
    TAGS = ["host", "cpu"]

    def __init__(self, instance: TpudInstance) -> None:
        super().__init__(instance)
        usage = procfs.CPUUsage()  # prime: first call has no baseline
        self.get_usage_fn = usage.percent
        self.get_load_fn = os.getloadavg
        self.get_core_count_fn = procfs.cpu_count
        self._event_bucket = (
            instance.event_store.bucket(NAME) if instance.event_store else None
        )

    def check_once(self) -> CheckResult:
        usage = self.get_usage_fn()
        load1, load5, load15 = self.get_load_fn()
        cores = self.get_core_count_fn()
        _g_usage.set(usage, LABELS)
        _g_load1.set(load1, LABELS)
        _g_load5.set(load5, LABELS)
        _g_load15.set(load15, LABELS)

        health = HealthStateType.HEALTHY
        reason = f"usage {usage:.1f}%, load1 {load1:.2f} ({cores} cores)"
        if load5 > cores * 4:
            health = HealthStateType.DEGRADED
            reason = f"sustained high load: load5 {load5:.2f} on {cores} cores"
        return CheckResult(
            self.NAME,
            health=health,
            reason=reason,
            extra_info={
                "usage_percent": f"{usage:.1f}",
                "load_1m": f"{load1:.2f}",
                "load_5m": f"{load5:.2f}",
                "load_15m": f"{load15:.2f}",
                "logical_cores": str(cores),
            },
        )

    def events(self, since: float):
        if self._event_bucket is None:
            return []
        return self._event_bucket.get(since)
