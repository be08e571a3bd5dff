"""GPU count component: lost-GPU detection.

The port of ``gpud_tpu/components/tpu/chip_counts.py``. Reference:
components/accelerator/nvidia/gpu-counts (502) — device enumeration vs
expected count (settable via flag/session updateConfig).
"""

from __future__ import annotations

from gpud_tpu_torch.api.v1.types import (
    HealthStateType,
    RepairActionType,
    SuggestedActions,
)
from gpud_tpu_torch.components.base import CheckResult, PollingComponent, TpudInstance
from gpud_tpu_torch.metrics.registry import gauge
from gpud_tpu_torch.gpu.topology import expected_local_gpus

NAME = "accelerator-gpu-counts"

_g_count = gauge("tpud_gpu_count", "enumerated GPUs")
_g_expected = gauge("tpud_gpu_count_expected", "expected GPUs")

LABELS = {"component": NAME}


class GPUCountsComponent(PollingComponent):
    NAME = NAME
    TAGS = ["accelerator", "gpu"]

    def __init__(self, instance: TpudInstance) -> None:
        super().__init__(instance)
        self.gpu = instance.gpu_instance
        # runtime-configurable expectation (session updateConfig analog,
        # reference: pkg/session/session.go:222-227)
        cfg = instance.config
        self.expected_count = getattr(cfg, "expected_gpu_count", 0) if cfg else 0

    def is_supported(self) -> bool:
        # an enumeration *failure* is supported-but-unhealthy, not
        # unsupported — otherwise a GPUs-fell-off-the-bus boot would be
        # reported as "not supported" and never checked
        if self.gpu is None:
            return False
        return self.gpu.gpu_lib_exists() or bool(self.gpu.init_error())

    def _expected(self) -> int:
        if self.expected_count:
            return self.expected_count
        if self.gpu is not None:
            return expected_local_gpus(self.gpu.accelerator_type())
        return 0

    def check_once(self) -> CheckResult:
        if self.gpu is None or not self.gpu.gpu_lib_exists():
            err = self.gpu.init_error() if self.gpu is not None else "no GPU instance"
            return CheckResult(
                self.NAME,
                health=HealthStateType.UNHEALTHY if err else HealthStateType.HEALTHY,
                reason=err or "no GPUs on this host",
            )
        devs = self.gpu.devices()
        healthy_devs = {gid: d for gid, d in devs.items() if not d.lost}
        lost = sorted(gid for gid, d in devs.items() if d.lost)
        needs_reset = sorted(gid for gid, d in devs.items() if d.requires_reset)
        expected = self._expected()
        _g_count.set(len(healthy_devs), LABELS)
        _g_expected.set(expected, LABELS)

        extra = {
            "found": str(len(healthy_devs)),
            "expected": str(expected),
            "accelerator_type": self.gpu.accelerator_type(),
        }
        if lost or (expected and len(healthy_devs) < expected):
            detail = f"found {len(healthy_devs)}/{expected or '?'} GPUs"
            if lost:
                detail += f"; lost GPU(s) {lost}"
            return CheckResult(
                self.NAME,
                health=HealthStateType.UNHEALTHY,
                reason=f"GPU(s) missing: {detail}",
                suggested_actions=SuggestedActions(
                    description="GPUs fell off the bus — reboot; if it persists, inspect hardware",
                    repair_actions=[
                        RepairActionType.REBOOT_SYSTEM,
                        RepairActionType.HARDWARE_INSPECTION,
                    ],
                ),
                extra_info=extra,
            )
        if needs_reset:
            return CheckResult(
                self.NAME,
                health=HealthStateType.UNHEALTHY,
                reason=f"GPU(s) require reset: {needs_reset}",
                suggested_actions=SuggestedActions(
                    description="GPUs in reset-required state",
                    repair_actions=[RepairActionType.REBOOT_SYSTEM],
                ),
                extra_info=extra,
            )
        return CheckResult(
            self.NAME,
            reason=f"all {len(healthy_devs)} expected GPUs present",
            extra_info=extra,
        )
