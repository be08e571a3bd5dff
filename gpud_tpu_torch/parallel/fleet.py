"""Fleet-scale sharded analytics over a device mesh.

Counterpart of ``gpud_tpu/parallel/fleet.py``, on ``torch.distributed``:
one process per device, a ``DeviceMesh`` with ("data", "model") axes, gloo
on the CPU and NCCL on the card. Every function here is called by every
process of the mesh with the same arguments, and returns the same result
on every process.

Axes:
- ``data``  — fleet/batch axis: chips, links, or telemetry windows.
- ``model`` — tensor-parallel axis for the autoencoder's hidden dim.

The autoencoder's parameters are ``DTensor``s with the reference's
placements (:func:`ae_param_sharding`), but the step computes on their
local shards with explicit collectives, Megatron style: a column-parallel
encoder and first decoder layer, a row-parallel latent and output layer.
DTensor would carry a row-parallel product's ``Partial(sum)`` through the
cast to bf16 and so round each rank's partial sum before the sum; here the
sum comes first, as in the unsharded product. For the same reason the
gradients of the weights are summed over "data" before they are rounded
to bf16, so the step equals :func:`models.anomaly.ae_train_step` on the
whole batch up to float32 summation order.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from gpud_tpu_torch.device import DeviceLike, resolve_device
from gpud_tpu_torch.models.anomaly import (
    AEConfig,
    AEParams,
    ae_init,
    bf16_round,
    gelu,
    robust_scores,
)
from gpud_tpu_torch.ops.window_scan import WindowScan, classify_links, scan_links

_DATA, _MODEL = "data", "model"


def make_mesh(
    n_devices: Optional[int] = None, model_parallel: int = 1, device: DeviceLike = None
) -> DeviceMesh:
    """Mesh over the process group's ranks with (data, model) axes: rank r
    sits at (r // model_parallel, r % model_parallel), as the reference
    reshapes its device list. ``model_parallel`` must divide n, and n must
    be the group's world size (one process per device). Runs on the card
    unless ``device="cpu"``; call it after ``init_process_group``."""
    dev = resolve_device(device)
    if n_devices and n_devices % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide {n_devices}")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized process group of one process per "
            "device (see gpud_tpu_torch.entry.dryrun_multichip)")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"n_devices={n} but the process group has {world} processes")
    if n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide {n}")
    if dev.type == "cuda" and n > torch.cuda.device_count():
        raise RuntimeError(f"{n} devices asked for, {torch.cuda.device_count()} present")
    return init_device_mesh(dev.type, (n // model_parallel, model_parallel),
                            mesh_dim_names=(_DATA, _MODEL))


def _axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def _device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# ---------------------------------------------------------------------------
# rows over "data": pad, take this rank's block, gather the blocks back
# ---------------------------------------------------------------------------

def _local_rows(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of x's rows, the rows padded with zeros up to a
    multiple of the "data" size (as the reference pads its fleet)."""
    dp, d = _axis_size(mesh, _DATA), mesh.get_local_rank(_DATA)
    per = -(-x.shape[0] // dp)
    block = x[d * per:(d + 1) * per]
    if block.shape[0] < per:
        pad = block.new_zeros((per - block.shape[0],) + tuple(x.shape[1:]))
        block = torch.cat([block, pad])
    return block


def _gather_rows(mesh: DeviceMesh, block: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The inverse of :func:`_local_rows`: every rank's block, in rank order
    along "data", without the padding."""
    group = mesh.get_group(_DATA)
    wire = block.to(torch.uint8) if block.dtype == torch.bool else block.contiguous()
    parts = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    return torch.cat(parts)[:n_rows].to(block.dtype)


def _on(mesh: DeviceMesh, x, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=dtype).to(_device(mesh))


# ---------------------------------------------------------------------------
# sharded link scan
# ---------------------------------------------------------------------------

def sharded_link_scan(
    mesh: DeviceMesh,
    states,
    counters,
    valid,
    flap_threshold: int = 3,
    crc_threshold: int = 100,
) -> Tuple[WindowScan, torch.Tensor]:
    """Scan [L, T] link history sharded along L over the ``data`` axis.
    Each rank scans its block of links with ``ops.window_scan.scan_links``
    (as the reference does here, not the packed kernel) and classifies it;
    the blocks are gathered, so every rank returns the whole scan and the
    classes of all L links."""
    L = int(np.shape(states)[0])
    st = _local_rows(mesh, _on(mesh, states, torch.int8))
    ct = _local_rows(mesh, _on(mesh, counters, torch.int32))
    vl = _local_rows(mesh, _on(mesh, valid, torch.bool))
    scan = scan_links(st, ct, vl)
    classes = classify_links(scan, flap_threshold=flap_threshold,
                             crc_threshold=crc_threshold)
    full = WindowScan(*(_gather_rows(mesh, f, L) for f in scan))
    return full, _gather_rows(mesh, classes, L)


def fleet_health_summary(mesh: DeviceMesh, classes: torch.Tensor) -> Dict[str, int]:
    """Global counts per health class: each rank counts its block of links
    along "data", then one all_reduce over "data" sums the counts."""
    per = -(-classes.shape[0] // _axis_size(mesh, _DATA))
    d = mesh.get_local_rank(_DATA)
    local = classes[d * per:(d + 1) * per]
    counts = torch.stack([(local == c).sum() for c in (0, 1, 2)]).to(torch.int64)
    dist.all_reduce(counts, group=mesh.get_group(_DATA))
    healthy, degraded, unhealthy = counts.tolist()
    return {"healthy": healthy, "degraded": degraded, "unhealthy": unhealthy}


# ---------------------------------------------------------------------------
# sharded anomaly scoring + autoencoder training
# ---------------------------------------------------------------------------

def sharded_robust_scores(mesh: DeviceMesh, windows) -> torch.Tensor:
    """[C, T, F] chip windows sharded along chips; every rank returns all
    C scores."""
    x = _on(mesh, windows)
    return _gather_rows(mesh, robust_scores(_local_rows(mesh, x)), x.shape[0])


def ae_param_sharding(mesh: DeviceMesh) -> AEParams:
    """Tensor-parallel layout, as placements over ("data", "model"): hidden
    dimension split over ``model`` (column-parallel encoder and first
    decoder layer, row-parallel latent and output layer), every parameter
    replicated over ``data``. The same on every mesh; ``mesh`` is taken for
    the reference's signature."""
    del mesh
    r = Replicate()
    return AEParams(
        w_enc=(r, Shard(1)), b_enc=(r, Shard(0)),
        w_lat=(r, Shard(0)), b_lat=(r, r),
        w_dec1=(r, Shard(1)), b_dec1=(r, Shard(0)),
        w_dec2=(r, Shard(0)), b_dec2=(r, r),
    )


def _shard(mesh: DeviceMesh, full: torch.Tensor, placements: tuple) -> DTensor:
    """A DTensor from a full tensor that every rank holds: each rank takes
    its own slice, with no communication."""
    local = full
    for dim_name, pl in zip(mesh.mesh_dim_names, placements):
        if isinstance(pl, Shard):
            n = _axis_size(mesh, dim_name)
            local = local.chunk(n, dim=pl.dim)[mesh.get_local_rank(dim_name)]
    return DTensor.from_local(local.contiguous(), mesh, placements, run_check=False)


def init_sharded_params(mesh: DeviceMesh, cfg: AEConfig, seed: int = 0) -> AEParams:
    """``ae_init`` from a generator seeded ``seed`` (the same draws on every
    rank), laid out by :func:`ae_param_sharding`."""
    if cfg.hidden % _axis_size(mesh, _MODEL):
        raise ValueError(f"hidden={cfg.hidden} is not divisible by the model axis")
    full = ae_init(cfg, torch.Generator().manual_seed(seed), device=_device(mesh))
    return AEParams(*(_shard(mesh, p, placements)
                      for p, placements in zip(full, ae_param_sharding(mesh))))


class _SumForward(torch.autograd.Function):
    """All-reduce (sum) over a group forward, identity backward: the output
    of a row-parallel product, used alike on every rank of the group."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumBackward(torch.autograd.Function):
    """Identity forward, all-reduce (sum) of the gradient backward: the
    input of a column-parallel product, whose gradient each rank holds a
    part of."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _tp_apply(p: AEParams, x: torch.Tensor, group) -> torch.Tensor:
    """``ae_apply`` on local shards whose weights are already rounded to
    bf16 values. The activations are rounded before they cross ranks, so
    their gradients are summed over "model" before they are rounded, as
    in the unsharded product."""
    h = gelu(bf16_round(x) @ p.w_enc + p.b_enc)
    zl = _SumForward.apply(bf16_round(h) @ p.w_lat, group) + p.b_lat
    h2 = gelu(_SumBackward.apply(bf16_round(zl), group) @ p.w_dec1 + p.b_dec1)
    return _SumForward.apply(bf16_round(h2) @ p.w_dec2, group) + p.b_dec2


_WEIGHTS = ("w_enc", "w_lat", "w_dec1", "w_dec2")


def _rounded_local(params: AEParams) -> AEParams:
    return AEParams(*(bf16_round(p.to_local()) if name in _WEIGHTS else p.to_local()
                      for name, p in zip(AEParams._fields, params)))


def _local_batch(mesh: DeviceMesh, batch) -> Tuple[torch.Tensor, int]:
    x = _on(mesh, batch, torch.float32)
    dp = _axis_size(mesh, _DATA)
    if x.shape[0] % dp:
        raise ValueError(f"batch of {x.shape[0]} does not split over {dp} data ranks")
    return _local_rows(mesh, x), x.shape[0]


def make_sharded_train_step(mesh: DeviceMesh, lr: float = 1e-3):
    """dp+tp training step: batch over ``data`` (``Shard(0)``), hidden over
    ``model``. ``step(params, batch)`` takes the sharded parameters and the
    whole batch (each rank keeps its rows) and returns the new parameters,
    sharded alike, and the loss, the same on every rank. Gradients are
    summed over "data" (the loss is already divided by the whole batch), so
    the step is the unsharded step on the whole batch."""
    model_group, data_group = mesh.get_group(_MODEL), mesh.get_group(_DATA)

    def step(params: AEParams, batch) -> Tuple[AEParams, torch.Tensor]:
        x, n_rows = _local_batch(mesh, batch)
        with torch.enable_grad():
            leaves = AEParams(*(p.detach().requires_grad_()
                                for p in _rounded_local(params)))
            out = _tp_apply(leaves, x, model_group)
            loss = torch.square(out - x).sum() / (n_rows * x.shape[1])
            grads = torch.autograd.grad(loss, leaves)
        # one all_reduce over "data" for the loss and every gradient
        flat = torch.cat([loss.detach().reshape(1)] + [g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=data_group)
        sizes = [1] + [g.numel() for g in grads]
        total, *summed = flat.split(sizes)
        new = []
        for name, p, g in zip(AEParams._fields, params, summed):
            g = g.view(p.to_local().shape)
            if name in _WEIGHTS:  # the gradient of the bf16 cast, after the sum
                g = bf16_round(g)
            new.append(DTensor.from_local(p.to_local() - lr * g, mesh, p.placements,
                                          run_check=False))
        return AEParams(*new), total.reshape(())

    return step


def sharded_ae_scores(mesh: DeviceMesh, params: AEParams, batch) -> torch.Tensor:
    """Per-sample reconstruction error of the whole batch, its rows sharded
    over ``data`` and the hidden dimension over ``model``."""
    x = _on(mesh, batch, torch.float32)
    local = _local_rows(mesh, x)
    with torch.no_grad():
        out = _tp_apply(_rounded_local(params), local, mesh.get_group(_MODEL))
        scores = torch.mean(torch.square(out - local), dim=-1)
    return _gather_rows(mesh, scores, x.shape[0])
