"""GPU temperature component.

The port of ``gpud_tpu/components/tpu/temperature.py``. Reference:
components/accelerator/nvidia/temperature (component.go:119-190,
metrics.go:17-50) — per-GPU temps with margin-to-slowdown degraded
threshold and memory temperature; the thermal slowdown flag is NVML's HW
or SW thermal slowdown clock event reason.
"""

from __future__ import annotations

from gpud_tpu_torch.api.v1.types import (
    HealthStateType,
    RepairActionType,
    SuggestedActions,
)
from gpud_tpu_torch.components.base import CheckResult, PollingComponent, TpudInstance
from gpud_tpu_torch.components.gpu.shared import sampler_for, telemetry_source
from gpud_tpu_torch.metrics.registry import gauge

NAME = "accelerator-gpu-temperature"

_g_temp = gauge("tpud_gpu_temperature_celsius", "GPU temperature")
_g_mem_temp = gauge("tpud_gpu_memory_temperature_celsius", "GPU memory temperature")

# thermal design thresholds; slowdown flag from telemetry overrides
DEFAULT_DEGRADED_C = 85.0
DEFAULT_UNHEALTHY_C = 95.0


class GPUTemperatureComponent(PollingComponent):
    NAME = NAME
    TAGS = ["accelerator", "gpu", "temperature"]

    def __init__(self, instance: TpudInstance) -> None:
        super().__init__(instance)
        self.gpu = instance.gpu_instance
        self.sampler = sampler_for(self.gpu)
        # indirection so chaos campaigns can overlay slow-ramp faults on
        # the telemetry read without touching the shared sampler cache;
        # None means "read the live sampler" so late sampler swaps stick
        self.telemetry_fn = None
        self.degraded_c = DEFAULT_DEGRADED_C
        self.unhealthy_c = DEFAULT_UNHEALTHY_C

    def is_supported(self) -> bool:
        return (
            self.gpu is not None
            and self.gpu.gpu_lib_exists()
            and self.gpu.telemetry_supported()
        )

    def check_once(self) -> CheckResult:
        if not self.is_supported():
            return CheckResult(
                self.NAME,
                health=HealthStateType.HEALTHY,
                reason="no GPU telemetry on this host",
            )
        tel = (self.telemetry_fn or self.sampler.telemetry)()
        worst = -1.0
        slowdown_gpus = []
        extra = {"telemetry_source": telemetry_source(self.gpu)}
        for gid, t in sorted(tel.items()):
            labels = {"component": NAME, "gpu": str(gid)}
            _g_temp.set(t.temperature_c, labels)
            _g_mem_temp.set(t.memory_temperature_c, labels)
            extra[f"gpu{gid}_temp_c"] = f"{t.temperature_c:.1f}"
            worst = max(worst, t.temperature_c)
            if t.thermal_slowdown:
                slowdown_gpus.append(gid)

        if slowdown_gpus or worst >= self.unhealthy_c:
            gpus = slowdown_gpus or [
                gid for gid, t in tel.items() if t.temperature_c >= self.unhealthy_c
            ]
            return CheckResult(
                self.NAME,
                health=HealthStateType.UNHEALTHY,
                reason=f"thermal slowdown on GPU(s) {gpus}; max temp {worst:.1f}C",
                suggested_actions=SuggestedActions(
                    description="GPU thermal slowdown — check cooling / inspect hardware",
                    repair_actions=[RepairActionType.HARDWARE_INSPECTION],
                ),
                extra_info=extra,
            )
        if worst >= self.degraded_c:
            return CheckResult(
                self.NAME,
                health=HealthStateType.DEGRADED,
                reason=f"high GPU temperature: max {worst:.1f}C",
                extra_info=extra,
            )
        return CheckResult(
            self.NAME,
            reason=f"max temp {worst:.1f}C across {len(tel)} GPUs",
            extra_info=extra,
        )
