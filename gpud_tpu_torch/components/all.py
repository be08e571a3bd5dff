"""Ordered registration list of the port's components
(reference: components/all/all.go:56-90; ``gpud_tpu/components/all.py``).

The accelerator components, in the reference's order; the host components
come with the device-free daemon.
"""

from __future__ import annotations

from typing import List

from gpud_tpu_torch.components.base import InitFunc
from gpud_tpu_torch.components.gpu.anomaly import GPUAnomalyComponent
from gpud_tpu_torch.components.gpu.error_kmsg import GPUErrorKmsgComponent
from gpud_tpu_torch.components.gpu.gpu_counts import GPUCountsComponent
from gpud_tpu_torch.components.gpu.memory import GPUMemoryComponent
from gpud_tpu_torch.components.gpu.nvlink import GPUNVLinkComponent
from gpud_tpu_torch.components.gpu.power import GPUPowerComponent
from gpud_tpu_torch.components.gpu.runtime import (
    GPUProcessesComponent,
    GPURuntimeComponent,
)
from gpud_tpu_torch.components.gpu.temperature import GPUTemperatureComponent


def all_components() -> List[InitFunc]:
    """In the reference's order of the accelerator components."""
    return [
        GPUCountsComponent,
        GPUTemperatureComponent,
        GPUMemoryComponent,
        GPUPowerComponent,
        GPUNVLinkComponent,
        GPURuntimeComponent,
        GPUProcessesComponent,
        GPUErrorKmsgComponent,
        GPUAnomalyComponent,
    ]
