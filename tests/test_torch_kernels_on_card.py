"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc, and skip elsewhere. The file
imports no JAX, so it runs where only the port is installed:

    python -m pytest -m cuda tests/test_torch_kernels_on_card.py
"""

import numpy as np
import pytest
import torch

from gpud_tpu_torch.ops.packed_scan import (
    packed_from_numpy,
    scan_links_packed,
    scan_links_packed_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    # decided here, at run time, so every test worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return "cuda"


def _case(rng, L, T):
    n = rng.integers(0, T + 1, L)
    valid = np.arange(T)[None, :] < n[:, None]
    states = rng.integers(-1, 3, (L, T), dtype=np.int8)
    counters = np.cumsum(rng.integers(-2, 5, (L, T)), axis=1).astype(np.int32)
    return states, counters, valid


def _offset_view(x):
    # a contiguous view one element into a larger allocation: its data
    # pointer is off the 16-byte grid the kernel's vector loads need
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    flat[1:] = x.reshape(-1)
    return flat[1:].view(x.shape)


def _assert_kernel_equals_plain(st, ct, vl):
    before = scan_links_packed.launches
    got = scan_links_packed(st, ct, vl)
    torch.cuda.synchronize()
    assert scan_links_packed.launches == before + 1
    ref = scan_links_packed_reference(st, ct, vl)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


@pytest.mark.parametrize("L, T", [(1, 1), (20, 40), (997, 1003), (77, 1), (4608, 1440)])
def test_packed_scan_kernel_matches_plain_version(cuda_device, L, T):
    rng = np.random.default_rng(L * 7919 + T)
    _assert_kernel_equals_plain(*packed_from_numpy(*_case(rng, L, T), cuda_device))


# T around the kernel's 16-sample chunks and 512-sample warp steps (odd T
# starts rows off the 16-byte grid); L = 4609 is one row past a 4-warp block
@pytest.mark.parametrize("T", [15, 16, 17, 511, 512, 513, 1025])
@pytest.mark.parametrize("L", [3, 997, 4609])
def test_packed_scan_kernel_at_chunk_and_step_edges(cuda_device, L, T):
    rng = np.random.default_rng(L * 31 + T)
    _assert_kernel_equals_plain(*packed_from_numpy(*_case(rng, L, T), cuda_device))


@pytest.mark.parametrize("T", [1040, 1041])
def test_packed_scan_kernel_last_valid_at_lane_and_step_edges(cuda_device, T):
    ns = np.array([0, 1, 15, 16, 17, 31, 32, 33, 511, 512, 513, 527, 528,
                   1023, 1024, 1025, T - 1, T])
    states, counters, _ = _case(np.random.default_rng(T), len(ns), T)
    valid = np.arange(T)[None, :] < ns[:, None]
    _assert_kernel_equals_plain(*packed_from_numpy(states, counters, valid, cuda_device))


@pytest.mark.parametrize("misaligned", [(0, 1, 2), (1,), (2,)])
def test_packed_scan_kernel_on_views_off_the_16_byte_grid(cuda_device, misaligned):
    rng = np.random.default_rng(len(misaligned))
    states, counters, valid = _case(rng, 301, 1040)
    if misaligned == (2,):  # with a ragged mask
        valid = rng.random(valid.shape) < 0.7
    tensors = packed_from_numpy(states, counters, valid, cuda_device)
    _assert_kernel_equals_plain(*(_offset_view(x) if i in misaligned else x
                                  for i, x in enumerate(tensors)))


def test_packed_scan_kernel_counters_between_int32_min_and_max(cuda_device):
    rng = np.random.default_rng(5)
    states, _, valid = _case(rng, 61, 1040)
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    counters = np.tile(np.where(np.arange(1040) % 2 == 0, lo, hi).astype(np.int32), (61, 1))
    counters[1::2] = rng.choice(np.array([lo, hi, -1, 0, 1], dtype=np.int32), (30, 1040))
    _assert_kernel_equals_plain(*packed_from_numpy(states, counters, valid, cuda_device))


def test_packed_scan_on_an_empty_fleet_launches_nothing(cuda_device):
    st, ct, vl = packed_from_numpy(np.zeros((0, 4)), np.zeros((0, 4)),
                                   np.zeros((0, 4)), cuda_device)
    before = scan_links_packed.launches
    got = scan_links_packed(st, ct, vl)
    assert scan_links_packed.launches == before
    assert got.drops.shape == (0,) and got.drops.device.type == "cuda"
