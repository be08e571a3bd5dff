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


@pytest.mark.parametrize("L, T", [(1, 1), (20, 40), (997, 1003), (77, 1), (4608, 1440)])
def test_packed_scan_kernel_matches_plain_version(cuda_device, L, T):
    rng = np.random.default_rng(L * 7919 + T)
    st, ct, vl = packed_from_numpy(*_case(rng, L, T), cuda_device)
    before = scan_links_packed.launches
    got = scan_links_packed(st, ct, vl)
    torch.cuda.synchronize()
    assert scan_links_packed.launches == before + 1
    ref = scan_links_packed_reference(st, ct, vl)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


def test_packed_scan_on_an_empty_fleet_launches_nothing(cuda_device):
    st, ct, vl = packed_from_numpy(np.zeros((0, 4)), np.zeros((0, 4)),
                                   np.zeros((0, 4)), cuda_device)
    before = scan_links_packed.launches
    got = scan_links_packed(st, ct, vl)
    assert scan_links_packed.launches == before
    assert got.drops.shape == (0,) and got.drops.device.type == "cuda"

