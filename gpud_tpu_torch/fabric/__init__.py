"""Fabric observability plane: link discovery, all-links sweep, matrix; the
port of ``gpud_tpu/fabric/``.

The NVLink component (components/gpu/nvlink.py) answers "is any port on
this host down". This package keeps the history behind "which links
degraded this week": it discovers the host's NVLink ports, sweeps every
link on a scheduler cadence, keeps per-link EWMA latency baselines, and
ships deviations as ``ici_link`` outbox records (the reference's kind).
"""

from gpud_tpu_torch.fabric.mesh import MeshLink, MeshSpec, discover_mesh, mesh_links
from gpud_tpu_torch.fabric.plane import FabricPlane
from gpud_tpu_torch.fabric.store import FabricMatrixStore

__all__ = [
    "FabricMatrixStore",
    "FabricPlane",
    "MeshLink",
    "MeshSpec",
    "discover_mesh",
    "mesh_links",
]
