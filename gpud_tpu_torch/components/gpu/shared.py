"""Shared telemetry sampler for GPU components.

The reference's NVIDIA components each call NVML separately; here all GPU
components share one cached sample with a short TTL, as the TPU edition's
do (footprint discipline: "shared pollers", SURVEY §7 hard parts): one
NVML walk per TTL, whatever the number of components.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from gpud_tpu_torch.gpu.instance import GPUInstance, GPUTelemetry, NVLinkSnapshot

DEFAULT_TTL = 10.0


class TelemetrySampler:
    def __init__(self, instance: GPUInstance, ttl_seconds: float = DEFAULT_TTL) -> None:
        self.instance = instance
        self.ttl = ttl_seconds
        self._mu = threading.Lock()
        self._tel: Dict[int, GPUTelemetry] = {}
        self._tel_ts = 0.0
        self._links: List[NVLinkSnapshot] = []
        self._links_ts = 0.0
        self.time_now_fn = time.time

    def telemetry(self) -> Dict[int, GPUTelemetry]:
        now = self.time_now_fn()
        with self._mu:
            if now - self._tel_ts >= self.ttl:
                self._tel = self.instance.telemetry()
                self._tel_ts = now
            return dict(self._tel)

    def nvlink_links(self) -> List[NVLinkSnapshot]:
        now = self.time_now_fn()
        with self._mu:
            if now - self._links_ts >= self.ttl:
                self._links = self.instance.nvlink_links()
                self._links_ts = now
            return list(self._links)


def telemetry_source(instance: Optional[GPUInstance]) -> str:
    """Measurement-vs-fixture label for check extra_info: operators must
    be able to tell NVML-measured telemetry ("nvml") from torch's memory
    counters ("torch") or fixtures ("mock")."""
    if instance is None:
        return ""
    src = getattr(instance, "telemetry_source", None)
    return src() if callable(src) else ""


_samplers_mu = threading.Lock()


def sampler_for(instance: Optional[GPUInstance]) -> Optional[TelemetrySampler]:
    """One sampler per GPUInstance, stored on the instance itself so its
    lifetime matches the instance (no process-global cache to leak)."""
    if instance is None:
        return None
    with _samplers_mu:
        s = getattr(instance, "_tpud_sampler", None)
        if s is None:
            s = TelemetrySampler(instance)
            instance._tpud_sampler = s  # type: ignore[attr-defined]
        return s
