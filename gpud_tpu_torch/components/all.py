"""Ordered registration list of the port's components
(reference: components/all/all.go:56-90; ``gpud_tpu/components/all.py``).

The accelerator components ported so far; the host components and the rest
of the accelerator ones (runtime, processes, the Xid kmsg catalog, the
anomaly scorer) come in later slices.
"""

from __future__ import annotations

from typing import List

from gpud_tpu_torch.components.base import InitFunc
from gpud_tpu_torch.components.gpu.gpu_counts import GPUCountsComponent
from gpud_tpu_torch.components.gpu.memory import GPUMemoryComponent
from gpud_tpu_torch.components.gpu.nvlink import GPUNVLinkComponent
from gpud_tpu_torch.components.gpu.power import GPUPowerComponent
from gpud_tpu_torch.components.gpu.temperature import GPUTemperatureComponent


def all_components() -> List[InitFunc]:
    """In the reference's order of the accelerator components."""
    return [
        GPUCountsComponent,
        GPUTemperatureComponent,
        GPUMemoryComponent,
        GPUPowerComponent,
        GPUNVLinkComponent,
    ]
