"""The port's CUDA kernels against their plain PyTorch versions, and its
analytics against the numpy twin and against device="cpu", on the card.

These tests need an NVIDIA GPU and nvcc, and skip elsewhere. The file
imports no JAX, so it runs where only the port is installed:

    python -m pytest -m cuda tests/test_torch_kernels_on_card.py
"""

import numpy as np
import pytest
import torch

from gpud_tpu_torch import entry as torch_entry
from gpud_tpu_torch.models import anomaly as torch_an
from gpud_tpu_torch.models.anomaly_np import robust_scores_np
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


# -- analytics: torch ops on the card (no hand kernel), against the CPU ------

@pytest.mark.parametrize("shape, dtype", [((4, 64, 8), torch.float32),
                                          ((1024, 180, 8), torch.float32),
                                          ((64, 17, 7), torch.bfloat16)])
def test_robust_scores_on_the_card_match_the_numpy_twin(cuda_device, shape, dtype):
    rng = np.random.default_rng(shape[0])
    w = rng.normal(50.0, 0.5, size=shape).astype(np.float32)
    w[0, shape[1] - shape[1] // 4:, 0] += np.linspace(0, 40, shape[1] // 4)
    x = torch.from_numpy(w).to(cuda_device, dtype)
    got = torch_an.robust_scores(x)
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), robust_scores_np(x.float().cpu().numpy()),
                               rtol=1e-4, atol=1e-4)
    assert int(got.argmax()) == 0


def test_entry_on_the_card_matches_the_cpu(cuda_device):
    fn, (params, batch) = torch_entry.entry()
    assert batch.device.type == "cuda" and not torch.backends.cuda.matmul.allow_tf32
    _, (params_cpu, batch_cpu) = torch_entry.entry(device="cpu")
    np.testing.assert_allclose(fn(params, batch).cpu().numpy(),
                               fn(params_cpu, batch_cpu).numpy(), rtol=1e-5)


@pytest.mark.parametrize("lr", [1e-3, 1.0])
def test_train_step_on_the_card_matches_the_cpu(cuda_device, lr):
    _, (params, batch) = torch_entry.entry()
    _, (params_cpu, batch_cpu) = torch_entry.entry(device="cpu")
    new, loss = torch_an.ae_train_step(params, batch, lr=lr)
    new_cpu, loss_cpu = torch_an.ae_train_step(params_cpu, batch_cpu, lr=lr)
    assert float(loss) == pytest.approx(float(loss_cpu), rel=1e-5)
    for a, b in zip(new, new_cpu):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-6 if lr < 1 else 1e-4)


def test_dryrun_multichip_on_one_card_over_nccl(cuda_device):
    res = torch_entry.dryrun_multichip(1)
    cfg = torch_an.AEConfig(4, 8, 16, 8)
    params = torch_an.ae_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    w = np.random.default_rng(0).normal(size=(4, 4, 8)).astype(np.float32)
    new, loss = torch_an.ae_train_step(params, torch_an.windows_to_batch(torch.from_numpy(w)))
    assert res["mesh"] == (1, 1) and sum(res["summary"].values()) == 8
    assert res["loss"] == pytest.approx(float(loss), abs=1e-6)
    for name, want in zip(torch_an.AEParams._fields, new):
        torch.testing.assert_close(res["params"][name], want, rtol=0, atol=1e-6)
