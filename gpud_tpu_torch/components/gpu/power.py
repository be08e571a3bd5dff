"""GPU power + utilization component.

The port of ``gpud_tpu/components/tpu/power.py``. Reference:
components/accelerator/nvidia/power (493) + utilization (403) + gpm (733)
— draw gauges and NVML's two utilization rates (the duty cycle, the time
a kernel ran, and the memory controller's), collapsed into one component
since all values come from the same telemetry sample.
"""

from __future__ import annotations

import collections
import threading
import time

from gpud_tpu_torch.api.v1.types import HealthStateType
from gpud_tpu_torch.components.base import CheckResult, PollingComponent, TpudInstance
from gpud_tpu_torch.components.gpu.shared import sampler_for, telemetry_source
from gpud_tpu_torch.metrics.registry import gauge

NAME = "accelerator-gpu-power"

_g_power = gauge("tpud_gpu_power_watts", "GPU power draw")
_g_duty = gauge("tpud_gpu_duty_cycle_percent", "GPU duty cycle (time a kernel ran)")
_g_util = gauge("tpud_gpu_memory_util_percent", "GPU memory controller utilization")
_g_clock = gauge("tpud_gpu_clock_mhz", "GPU SM clock")
# sampled-over-interval analog of the reference's GPM metrics (SM occupancy
# sampled over a GPM window, gpm/component.go:34): a point-in-time duty
# cycle aliases badly against bursty training steps, so a windowed mean
# over recent samples is exported alongside the instantaneous value. The
# window is time-based (not poll-count) so on-demand triggered checks
# can't evict real history with duplicate cached samples.
_g_duty_avg = gauge(
    "tpud_gpu_duty_cycle_avg_percent",
    "GPU duty cycle averaged over the sampling window",
)

SAMPLING_WINDOW_SECONDS = 300.0  # ≈5 polls at the default cadence


class GPUPowerComponent(PollingComponent):
    NAME = NAME
    TAGS = ["accelerator", "gpu", "power"]

    def __init__(self, instance: TpudInstance) -> None:
        super().__init__(instance)
        self.gpu = instance.gpu_instance
        self.sampler = sampler_for(self.gpu)
        self.sampling_window_seconds = SAMPLING_WINDOW_SECONDS
        self.time_now_fn = time.time
        self._hist_mu = threading.Lock()  # triggered checks race the poller
        self._duty_hist: dict = {}  # gpu_id → deque of (ts, duty) samples

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
        tel = self.sampler.telemetry()
        now = self.time_now_fn()
        total_w = 0.0
        extra = {"telemetry_source": telemetry_source(self.gpu)}
        with self._hist_mu:
            # prune GPUs gone from telemetry: hours-old samples from a
            # reset GPU must not blend into its average when it returns
            for gone in set(self._duty_hist) - set(tel):
                del self._duty_hist[gone]
        for gid, t in sorted(tel.items()):
            labels = {"component": NAME, "gpu": str(gid)}
            _g_power.set(t.power_w, labels)
            _g_duty.set(t.duty_cycle_pct, labels)
            _g_util.set(t.memory_util_pct, labels)
            _g_clock.set(t.clock_mhz, labels)
            with self._hist_mu:
                hist = self._duty_hist.setdefault(gid, collections.deque())
                # one sample per sampler refresh: a triggered check inside
                # the sampler TTL re-reads the same cached value
                if not hist or now - hist[-1][0] >= self.sampler.ttl:
                    hist.append((now, t.duty_cycle_pct))
                cutoff = now - self.sampling_window_seconds
                while hist and hist[0][0] < cutoff:
                    hist.popleft()
                avg = sum(v for _ts, v in hist) / len(hist)
            _g_duty_avg.set(avg, labels)
            total_w += t.power_w
            extra[f"gpu{gid}_power_w"] = f"{t.power_w:.1f}"
            extra[f"gpu{gid}_duty_pct"] = f"{t.duty_cycle_pct:.1f}"
        return CheckResult(
            self.NAME,
            reason=f"total draw {total_w:.0f}W across {len(tel)} GPUs",
            extra_info=extra,
        )
