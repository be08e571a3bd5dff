"""GPU memory component: usage + ECC health.

The port of ``gpud_tpu/components/tpu/hbm.py``. Reference blend of
components/accelerator/nvidia/memory (usage gauges) and remapped-rows (587
LoC — pending ⇒ reboot; rationale at xid/component.go:276-290): volatile
corrected ECC counts are gauges; a volatile uncorrected ECC error or a
row remap pending drives suggested actions.
"""

from __future__ import annotations

from gpud_tpu_torch.api.v1.types import (
    Event,
    EventType,
    HealthStateType,
    RepairActionType,
    SuggestedActions,
)
from gpud_tpu_torch.components.base import CheckResult, PollingComponent, TpudInstance
from gpud_tpu_torch.components.gpu.shared import sampler_for, telemetry_source
from gpud_tpu_torch.metrics.registry import gauge

NAME = "accelerator-gpu-memory"

_g_used = gauge("tpud_gpu_memory_used_bytes", "GPU memory used bytes")
_g_total = gauge("tpud_gpu_memory_total_bytes", "GPU memory total bytes")
_g_ecc_corr = gauge("tpud_gpu_memory_ecc_correctable_total", "correctable GPU memory ECC errors")
_g_ecc_uncorr = gauge(
    "tpud_gpu_memory_ecc_uncorrectable_total", "uncorrectable GPU memory ECC errors"
)


class GPUMemoryComponent(PollingComponent):
    NAME = NAME
    TAGS = ["accelerator", "gpu", "memory"]

    def __init__(self, instance: TpudInstance) -> None:
        super().__init__(instance)
        self.gpu = instance.gpu_instance
        self.sampler = sampler_for(self.gpu)
        # indirection so chaos campaigns can overlay slow-ramp faults on
        # the telemetry read without touching the shared sampler cache;
        # None means "read the live sampler" so late sampler swaps stick
        self.telemetry_fn = None
        self._event_bucket = (
            instance.event_store.bucket(NAME) if instance.event_store else None
        )

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
        ecc_pending = []
        extra = {"telemetry_source": telemetry_source(self.gpu)}
        for gid, t in sorted(tel.items()):
            labels = {"component": NAME, "gpu": str(gid)}
            _g_used.set(t.memory_used_bytes, labels)
            _g_total.set(t.memory_total_bytes, labels)
            _g_ecc_corr.set(t.memory_ecc_correctable, labels)
            _g_ecc_uncorr.set(t.memory_ecc_uncorrectable, labels)
            if t.memory_total_bytes:
                extra[f"gpu{gid}_hbm_used_pct"] = (
                    f"{100.0 * t.memory_used_bytes / t.memory_total_bytes:.1f}"
                )
            if t.memory_ecc_pending or t.memory_ecc_uncorrectable > 0:
                ecc_pending.append(gid)

        if ecc_pending:
            # record an event so event-sourced health and the control plane
            # see the occurrence even after the condition clears; dedupe on
            # (name, message) against recent history — a still-pending
            # condition must not insert a new event every poll
            if self._event_bucket is not None:
                msg = f"uncorrectable GPU memory ECC on GPU(s) {ecc_pending}"
                recent = self._event_bucket.get(self.time_now_fn() - 86400)
                already = any(
                    e.name == "hbm_ecc_uncorrectable" and e.message == msg
                    for e in recent
                )
                if not already:
                    self._event_bucket.insert(
                        Event(
                            component=NAME,
                            name="hbm_ecc_uncorrectable",
                            type=EventType.FATAL,
                            message=msg,
                        )
                    )
            return CheckResult(
                self.NAME,
                health=HealthStateType.UNHEALTHY,
                reason=f"uncorrectable GPU memory ECC pending on GPU(s) {ecc_pending}",
                suggested_actions=SuggestedActions(
                    description=(
                        "uncorrectable GPU memory ECC — reboot to re-map; if it "
                        "persists, hardware inspection"
                    ),
                    repair_actions=[
                        RepairActionType.REBOOT_SYSTEM,
                        RepairActionType.HARDWARE_INSPECTION,
                    ],
                ),
                extra_info=extra,
            )
        return CheckResult(
            self.NAME,
            reason=f"GPU memory healthy on {len(tel)} GPUs",
            extra_info=extra,
        )

    def events(self, since: float):
        if self._event_bucket is None:
            return []
        return self._event_bucket.get(since)
