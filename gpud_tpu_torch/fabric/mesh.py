"""What a fabric link is on a GPU host, and how the sweep finds them; the
port's counterpart of ``gpud_tpu/fabric/mesh.py``.

The reference sweeps a 2-D torus of TPU chips, with ports ``2k``/``2k+1``
facing the two neighbours along axis ``k``. GPUs on an HGX board are not
joined that way: each GPU's NVLink ports (18 on an H100 SXM) run to the
NVSwitches, and NVML names no remote end for a port. So a logical link
here is one GPU's NVLink port, GPU to switch:

- ``src_chip`` is the GPU index, ``port`` the NVLink index, ``dst_chip``
  is ``SWITCH_SIDE`` (-1: the switch, which NVML does not name) and
  ``axis`` is ``"nvlink"``; the store keeps the reference's columns;
- its name is ``gpu{g}/nvlink{k}``, the name of ``NVLinkSnapshot`` in
  ``gpu/instance.py``, so the matrix, the NVLink check's reasons and the
  NVLink store name a link the same way.

Discovery reads the port inventory the adapter already walks
(``nvlink_links()``: NVML, or the mock). Two sources remain of the
reference's three:

1. ``nvml`` — the inventory's ``(gpu, port)`` pairs; the mesh shape is
   ``(gpus, ports per GPU)``.
2. ``degraded`` — no inventory at all (no NVML, or a card without
   NVLink): zero links, so every consumer sees a trivially complete,
   trivially healthy sweep instead of an error path.

The reference's ``jax`` rung has no counterpart (NVML is the inventory),
and its torus helpers (``near_square_factor``, ``link_ports`` and the
torus ``mesh_links``) are not ported: nothing here would call them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from gpud_tpu_torch.log import get_logger

logger = get_logger(__name__)

AXIS_NVLINK = "nvlink"
SWITCH_SIDE = -1  # dst_chip of every link: the NVSwitch, unnamed by NVML

SOURCE_NVML = "nvml"
SOURCE_DEGRADED = "degraded"


@dataclass(frozen=True)
class MeshLink:
    """One logical link: a GPU's NVLink port, GPU to switch."""

    src_chip: int
    port: int
    dst_chip: int = SWITCH_SIDE
    axis: str = AXIS_NVLINK

    @property
    def name(self) -> str:
        return f"gpu{self.src_chip}/nvlink{self.port}"

    def to_dict(self) -> Dict:
        return {
            "link": self.name,
            "src_chip": self.src_chip,
            "dst_chip": self.dst_chip,
            "axis": self.axis,
        }


@dataclass(frozen=True)
class MeshSpec:
    """A discovered fabric: the inventory's ports + provenance."""

    shape: Tuple[int, ...]          # (gpus, ports per GPU)
    chips: Tuple[int, ...] = field(default=())  # GPU ids, ascending
    ports: Tuple[Tuple[int, int], ...] = field(default=())  # (gpu, port)
    source: str = SOURCE_DEGRADED

    def to_dict(self) -> Dict:
        return {
            "shape": list(self.shape),
            "chips": len(self.chips),
            "source": self.source,
        }


def discover_mesh(gpu=None) -> MeshSpec:
    """The fabric from the adapter's port inventory (module docstring)."""
    ports: List[Tuple[int, int]] = []
    if gpu is not None:
        try:
            ports = sorted({(s.gpu_id, s.link_id) for s in gpu.nvlink_links()})
        except Exception as exc:  # noqa: BLE001 — backend probe failed
            logger.debug("nvlink inventory unavailable for mesh discovery: %s", exc)
            ports = []
    if not ports:
        return MeshSpec(shape=(1, 1), source=SOURCE_DEGRADED)
    chips = tuple(sorted({g for g, _ in ports}))
    per_gpu = max(sum(1 for g, _ in ports if g == c) for c in chips)
    return MeshSpec(
        shape=(len(chips), per_gpu),
        chips=chips,
        ports=tuple(ports),
        source=SOURCE_NVML,
    )


def mesh_links(mesh: MeshSpec) -> List[MeshLink]:
    """Every logical link, ordered by GPU, then port."""
    return [MeshLink(g, k) for g, k in mesh.ports]


def link_port_state(
    link: MeshLink, port_up: Dict[Tuple[int, int], bool]
) -> Optional[bool]:
    """The link's verdict from its one port: ``False`` when the port reports
    down, ``True`` when up, ``None`` when it is not in the inventory (the
    plane reads that as up, as the reference does)."""
    return port_up.get((link.src_chip, link.port))
