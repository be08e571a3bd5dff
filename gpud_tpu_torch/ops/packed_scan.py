"""Packed link-history scan: the CUDA kernel's wrapper and its plain version.

Counterpart of ``gpud_tpu/ops/pallas_scan.py``. When histories are packed
(each link's samples left-aligned and contiguous, validity a prefix mask,
which is what ``fleet_scan.load_fleet_history`` produces) the transitions
are adjacent compares and the whole scan is one pass per link. On the card
that pass is the hand-written kernel in ``csrc/packed_scan.cu``; on the CPU
it is :func:`scan_links_packed_reference`, which states the same semantics
in plain PyTorch and is what the kernel is held against.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from gpud_tpu_torch.device import DeviceLike, resolve_device

# result columns of the kernel's [L, 5] int64 output
COL_DROPS, COL_FLAPS, COL_DOWN, COL_SAMPLES, COL_DELTA = range(5)
N_COLS = 5


class PackedScan(NamedTuple):
    """Per-link packed-scan results (all [L]): int64 counts, bool down."""

    drops: torch.Tensor
    flaps: torch.Tensor
    currently_down: torch.Tensor
    samples: torch.Tensor
    counter_delta: torch.Tensor


def _from_columns(out: torch.Tensor) -> PackedScan:
    # the kernel writes currently_down as int64 0 or 1, so the low byte of
    # that column (little-endian) is a valid bool: a view, with no second
    # kernel launch
    return PackedScan(
        drops=out[:, COL_DROPS],
        flaps=out[:, COL_FLAPS],
        currently_down=out.view(torch.bool)[:, 8 * COL_DOWN],
        samples=out[:, COL_SAMPLES],
        counter_delta=out[:, COL_DELTA],
    )


def scan_links_packed_reference(
    states: torch.Tensor, counters: torch.Tensor, valid: torch.Tensor
) -> PackedScan:
    """Plain PyTorch version of the packed scan, on any device.

    With ``up(x) := x >= 1``, ``down(x) := x <= 0`` and
    ``pair(t) := valid[t] & valid[t+1]``: drops and flaps count the
    up→down and down→up pairs, ``samples`` counts valid samples,
    ``currently_down`` says the sample at index ``samples - 1`` is not a
    valid up sample (false for a row with no samples), and
    ``counter_delta`` sums the positive counter steps of pairs, in int64.
    """
    v = valid.to(torch.bool)
    up = states >= 1
    down = states <= 0
    pair = v[:, :-1] & v[:, 1:]
    drops = (pair & up[:, :-1] & down[:, 1:]).sum(dim=1)
    flaps = (pair & down[:, :-1] & up[:, 1:]).sum(dim=1)
    samples = v.sum(dim=1)
    last = (samples - 1).clamp(min=0)[:, None]
    last_up = (v.gather(1, last) & up.gather(1, last))[:, 0]
    currently_down = (samples > 0) & ~last_up
    steps = counters[:, 1:].long() - counters[:, :-1].long()
    counter_delta = torch.where(pair, steps.clamp(min=0), 0).sum(dim=1)
    return PackedScan(drops, flaps, currently_down, samples, counter_delta)


def _check(states, counters, valid) -> Tuple[int, int]:
    for name, x, dtype in (
        ("states", states, torch.int8),
        ("counters", counters, torch.int32),
        ("valid", valid, torch.bool),
    ):
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.dim() != 2:
            raise ValueError(f"{name} must be [L, T], got shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not states.shape == counters.shape == valid.shape:
        raise ValueError(
            "states, counters and valid must share one [L, T] shape, got "
            f"{tuple(states.shape)}, {tuple(counters.shape)}, {tuple(valid.shape)}"
        )
    if not states.device == counters.device == valid.device:
        raise ValueError(
            "states, counters and valid must be on one device, got "
            f"{states.device}, {counters.device}, {valid.device}"
        )
    L, T = states.shape
    if not 0 < T < 2**31:
        raise ValueError(f"T must be in [1, 2^31), got {T}")
    return L, T


def scan_links_packed(
    states: torch.Tensor, counters: torch.Tensor, valid: torch.Tensor
) -> PackedScan:
    """Packed-history scan. Inputs are contiguous [L, T] tensors: int8
    ``states``, int32 ``counters`` and a bool prefix mask ``valid``.

    CUDA tensors run the kernel of ``csrc/packed_scan.cu`` (and raise if it
    cannot build or launch); CPU tensors run the plain version. Each kernel
    launch adds one to ``scan_links_packed.launches``.
    """
    L, T = _check(states, counters, valid)
    dev = states.device
    if dev.type == "cpu":
        return scan_links_packed_reference(states, counters, valid)
    if dev.type != "cuda":
        raise ValueError(f"scan_links_packed runs on cuda or cpu, not {dev}")
    out = torch.empty((L, N_COLS), dtype=torch.int64, device=dev)
    if L == 0:
        return _from_columns(out)

    from gpud_tpu_torch.ops._build import load_library

    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gpud_packed_scan(
            states.data_ptr(), counters.data_ptr(), valid.data_ptr(),
            L, T, out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"packed_scan kernel launch failed: cudaError_t {err} "
            f"(L={L}, T={T}, device={dev})"
        )
    scan_links_packed.launches += 1
    return _from_columns(out)


scan_links_packed.launches = 0


def packed_from_numpy(
    states: np.ndarray,
    counters: np.ndarray,
    valid: np.ndarray,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Turn the loaders' numpy arrays into the scan's contiguous tensors
    (int8 / int32 / bool) on ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    return (
        torch.from_numpy(np.ascontiguousarray(states, dtype=np.int8)).to(dev),
        torch.from_numpy(np.ascontiguousarray(counters, dtype=np.int32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(valid, dtype=bool)).to(dev),
    )
