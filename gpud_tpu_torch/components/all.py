"""Ordered registration list of all built-in components
(reference: components/all/all.go:56-90; ``gpud_tpu/components/all.py``).

The 13 host components first, then the nine GPU components, in the
reference's order.
"""

from __future__ import annotations

from typing import List

from gpud_tpu_torch.components.base import InitFunc
from gpud_tpu_torch.components.cpu import CPUComponent
from gpud_tpu_torch.components.disk import DiskComponent
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
from gpud_tpu_torch.components.host_extra import (
    ContainerdComponent,
    DockerComponent,
    FuseComponent,
    KernelModuleComponent,
    KubeletComponent,
    LibraryComponent,
    NetworkLatencyComponent,
    NFSComponent,
    PCIComponent,
)
from gpud_tpu_torch.components.memory import MemoryComponent
from gpud_tpu_torch.components.os_comp import OSComponent


def all_components() -> List[InitFunc]:
    """Registration order mirrors dependency order: host basics first,
    then accelerator components."""
    return [
        OSComponent,
        CPUComponent,
        MemoryComponent,
        DiskComponent,
        FuseComponent,
        KernelModuleComponent,
        LibraryComponent,
        NetworkLatencyComponent,
        NFSComponent,
        PCIComponent,
        ContainerdComponent,
        DockerComponent,
        KubeletComponent,
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
