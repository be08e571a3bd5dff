"""Entry points of the port's analytics.

Counterparts of the reference's entry points in ``__graft_entry__.py``:

``entry(device=None)``      — the forward step of the flagship analytics
                              model (telemetry autoencoder anomaly scoring),
                              one device.
``dryrun_multichip(n, device=None)`` — one dp+tp-sharded training step and a
                              sharded link scan over an n-device mesh, on
                              small shapes, one process per device.

Both run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import datetime
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from gpud_tpu_torch.device import DeviceLike, resolve_device
from gpud_tpu_torch.models.anomaly import (
    AEConfig,
    AEParams,
    ae_init,
    ae_scores,
    windows_to_batch,
)
from gpud_tpu_torch.parallel.fleet import (
    fleet_health_summary,
    init_sharded_params,
    make_mesh,
    make_sharded_train_step,
    sharded_ae_scores,
    sharded_link_scan,
    sharded_robust_scores,
)

# a collective that waits longer than this on a peer fails the dry run
_COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=5)


def entry(device: DeviceLike = None):
    """``(fn, (params, batch))``: ``fn(params, batch)`` is ``ae_scores`` at
    the model's full width (window 16, features 8, hidden 256, latent 32)
    on a batch of 64, with parameters from ``ae_init`` seeded 0 and the
    reference's batch."""
    dev = resolve_device(device)
    cfg = AEConfig(window=16, features=8, hidden=256, latent=32)
    params = ae_init(cfg, torch.Generator().manual_seed(0), device=dev)
    batch = torch.from_numpy(
        np.random.default_rng(0).normal(size=(64, cfg.input_dim)).astype(np.float32)
    ).to(dev)
    return ae_scores, (params, batch)


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> dict:
    """Spawn one process per device (NCCL on the card, gloo on the CPU,
    rendezvous through a file store in a temporary directory), and in them
    take one sharded training step of the autoencoder and scan a fleet's
    links sharded over "data", as the reference's dry run does; then score
    the batch with both scorers over the mesh. Raises if a process fails or
    the health summary does not count every link.

    Returns rank 0's results, on the CPU: the mesh shape, the loss, the new
    parameters gathered whole, the sharded scan, classes and summary, and
    the scores."""
    dev = resolve_device(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) needs {n_devices} CUDA devices, "
            f"{torch.cuda.device_count()} present")
    with tempfile.TemporaryDirectory(prefix="dryrun_multichip_") as tmp:
        torch.multiprocessing.spawn(_dryrun_process, args=(n_devices, dev.type, tmp),
                                    nprocs=n_devices, join=True)
        return torch.load(os.path.join(tmp, "result.pt"), weights_only=True)


def _dryrun_process(rank: int, n_devices: int, device_type: str, tmp: str) -> None:
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        backend = "nccl"
    else:
        torch.set_num_threads(1)  # n processes share the host's cores
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            world_size=n_devices, rank=rank,
                            timeout=_COLLECTIVE_TIMEOUT)
    try:
        result = _dryrun(n_devices, device_type)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        torch.save(result, os.path.join(tmp, "result.pt"))


def _dryrun(n_devices: int, device_type: str) -> dict:
    model_parallel = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_devices, model_parallel=model_parallel, device=device_type)

    # tiny but real shapes, divisible by both mesh axes
    cfg = AEConfig(window=4, features=8, hidden=16 * model_parallel, latent=8)
    params = init_sharded_params(mesh, cfg)
    rng = np.random.default_rng(0)
    windows = rng.normal(size=(4 * n_devices, cfg.window, cfg.features)).astype(np.float32)
    batch = windows_to_batch(torch.from_numpy(windows))

    step = make_sharded_train_step(mesh)
    params, loss = step(params, batch)

    # sharded link scan over the same mesh (data-parallel over links)
    n_links = 8 * n_devices
    states = rng.integers(0, 2, size=(n_links, 16)).astype(np.int8)
    counters = np.cumsum(rng.integers(0, 3, size=(n_links, 16)), axis=1).astype(np.int32)
    valid = np.ones((n_links, 16), dtype=bool)
    scan, classes = sharded_link_scan(mesh, states, counters, valid)
    summary = fleet_health_summary(mesh, classes)
    if sum(summary.values()) != n_links:
        raise AssertionError(f"summary {summary} does not count {n_links} links")

    return {
        "mesh": tuple(mesh.shape),
        "loss": float(loss),
        "params": {name: p.full_tensor().cpu()
                   for name, p in zip(AEParams._fields, params)},
        "scan": {name: f.cpu() for name, f in zip(scan._fields, scan)},
        "classes": classes.cpu(),
        "summary": summary,
        "ae_scores": sharded_ae_scores(mesh, params, batch).cpu(),
        "robust_scores": sharded_robust_scores(mesh, windows).cpu(),
    }
