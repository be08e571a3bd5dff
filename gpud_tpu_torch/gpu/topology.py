"""GPU product knowledge: accelerator-type parsing and expectations.

The port's counterpart of ``gpud_tpu/tpu/topology.py`` and of the
reference's product→capabilities mapping (reference: pkg/nvidia/product).
The accelerator type is ``<generation>-<count>``, e.g. ``h100-sxm-8``: a
product generation from the table below and the number of GPUs in the
deployment. The derived facts are GPU counts, GPUs per host, NVLink links
per GPU and memory per GPU.

Conventions encoded here:
- the numeric suffix counts GPUs (there is no core count to convert);
- GPUs per host: an HGX board holds 8 SXM GPUs; a PCIe server is sized by
  the suffix, up to 8;
- NVLink links per GPU: what each product's data sheet gives; a PCIe card
  without a bridge has none, so no NVLink link is expected of it.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

_GB = 1000**3


@dataclass(frozen=True)
class GenerationSpec:
    name: str
    gpus_per_host: int
    nvlink_links_per_gpu: int
    memory_bytes_per_gpu: int
    nvlink_gbps_per_link: float  # one direction, gigabits per second
    supports_nvlink_fabric: bool  # GPU-to-GPU NVLink observable


GENERATIONS = {
    # NVIDIA H100 Tensor Core GPU data sheet: SXM5, 80 GB HBM3, NVLink 4
    # at 900 GB/s = 18 links x 50 GB/s (25 GB/s each way); HGX H100 holds
    # 8 GPUs
    "h100-sxm": GenerationSpec("h100-sxm", 8, 18, 80 * _GB, 200.0, True),
    # same data sheet, PCIe form factor: 80 GB HBM2e; NVLink only through
    # an optional two-card bridge, so none is expected
    "h100-pcie": GenerationSpec("h100-pcie", 8, 0, 80 * _GB, 0.0, False),
    # NVIDIA H200 Tensor Core GPU data sheet: SXM, 141 GB HBM3e, NVLink 4
    # at 900 GB/s (18 links); HGX H200 holds 8 GPUs
    "h200-sxm": GenerationSpec("h200-sxm", 8, 18, 141 * _GB, 200.0, True),
    # NVIDIA A100 Tensor Core GPU data sheet: SXM4, 80 GB HBM2e, NVLink 3
    # at 600 GB/s = 12 links x 50 GB/s; HGX A100 holds 8 GPUs
    "a100-sxm": GenerationSpec("a100-sxm", 8, 12, 80 * _GB, 200.0, True),
}

_ACCEL_RE = re.compile(r"^([a-z]\d+(?:-[a-z]+)?)-(\d+)$")

# product names as NVML reports them (nvmlDeviceGetName), lower-cased and
# without the "nvidia " prefix
_ALIASES = {
    "h100 80gb hbm3": "h100-sxm",
    "h100 sxm5 80gb": "h100-sxm",
    "h100 pcie": "h100-pcie",
    "h200": "h200-sxm",
    "a100-sxm4-80gb": "a100-sxm",
}


def normalize_generation(name: str) -> str:
    n = name.strip().lower()
    if n in GENERATIONS:
        return n
    if n.startswith("nvidia "):
        n = n[len("nvidia "):]
    if n in _ALIASES:
        return _ALIASES[n]
    return n


@dataclass
class HostTopology:
    accelerator_type: str
    generation: str
    total_gpus: int
    hosts: int
    gpus_per_host: int
    nvlink_links_per_gpu: int
    memory_bytes_per_gpu: int

    @property
    def multi_host(self) -> bool:
        return self.hosts > 1


def parse_accelerator_type(accel_type: str) -> Optional[HostTopology]:
    """``h100-sxm-16`` → HostTopology(generation=h100-sxm, gpus=16, hosts=2,
    ...). Returns None for unknown formats."""
    m = _ACCEL_RE.match(accel_type.strip().lower())
    if not m:
        return None
    gen_name = normalize_generation(m.group(1))
    spec = GENERATIONS.get(gen_name)
    if spec is None:
        return None
    gpus = max(1, int(m.group(2)))
    hosts = (gpus + spec.gpus_per_host - 1) // spec.gpus_per_host
    return HostTopology(
        accelerator_type=accel_type,
        generation=gen_name,
        total_gpus=gpus,
        hosts=hosts,
        gpus_per_host=min(gpus, spec.gpus_per_host),
        nvlink_links_per_gpu=spec.nvlink_links_per_gpu,
        memory_bytes_per_gpu=spec.memory_bytes_per_gpu,
    )


def expected_local_gpus(accel_type: str) -> int:
    """How many GPUs this host should see for the given accelerator type
    (reference: components/accelerator/nvidia/gpu-counts)."""
    topo = parse_accelerator_type(accel_type)
    if topo is None:
        return 0
    return topo.gpus_per_host
