"""The port's packed scan (gpud_tpu_torch/ops/packed_scan.py) against the
Pallas kernel it replaces, run in interpret mode as tests/test_pallas_scan.py
runs it, and against the jnp window scan. Every field must be exactly equal.

On the CPU the wrapper runs the plain PyTorch version; the CUDA kernel is
held against that version by tests/test_torch_kernels_on_card.py and by
chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gpud_tpu.ops.pallas_scan import scan_links_packed as pallas_scan_links_packed
from gpud_tpu.ops.window_scan import scan_links as jax_scan_links

from gpud_tpu_torch.ops.packed_scan import (
    PackedScan,
    packed_from_numpy,
    scan_links_packed,
    scan_links_packed_reference,
)

FIELDS = ("drops", "flaps", "currently_down", "samples", "counter_delta")


def _packed_case(rng, L=20, T=40):
    """Random packed histories: contiguous samples, suffix padding (the
    generator of tests/test_pallas_scan.py)."""
    states = np.zeros((L, T), dtype=np.int8)
    counters = np.zeros((L, T), dtype=np.int32)
    valid = np.zeros((L, T), dtype=bool)
    for l in range(L):
        n = int(rng.integers(1, T + 1))
        states[l, :n] = rng.integers(0, 2, n)
        counters[l, :n] = np.cumsum(rng.integers(0, 5, n))
        if rng.random() < 0.3:  # occasional counter reset
            k = n // 2
            counters[l, k:n] = np.cumsum(rng.integers(0, 5, n - k))
        valid[l, :n] = True
    return states, counters, valid


def _port(states, counters, valid) -> dict:
    got = scan_links_packed(*packed_from_numpy(states, counters, valid, "cpu"))
    return {f: getattr(got, f).numpy() for f in FIELDS}


def _pallas(states, counters, valid) -> dict:
    got = pallas_scan_links_packed(
        jnp.asarray(states), jnp.asarray(counters), jnp.asarray(valid),
        interpret=True,
    )
    return {f: np.asarray(getattr(got, f)) for f in FIELDS}


def _assert_fields_equal(got: dict, ref: dict, fields=FIELDS):
    for f in fields:
        # the reference's counts are int32 (x64 off): compare values
        np.testing.assert_array_equal(got[f].astype(np.int64),
                                      ref[f].astype(np.int64), err_msg=f)


@pytest.mark.parametrize("seed", [7, 11, 23, 101, 2024, 31337])
def test_reference_matches_pallas_and_window_scan(seed):
    rng = np.random.default_rng(seed)
    case = _packed_case(rng, L=int(rng.integers(1, 30)), T=int(rng.integers(2, 70)))
    got = _port(*case)
    _assert_fields_equal(got, _pallas(*case))
    ws = jax_scan_links(*map(jnp.asarray, case))
    ref = {f: np.asarray(getattr(ws, f))
           for f in ("drops", "flaps", "currently_down", "counter_delta")}
    _assert_fields_equal(got, ref, fields=tuple(ref))
    np.testing.assert_array_equal(got["samples"], case[2].sum(axis=1))


def test_padding_shapes():
    # L and T deliberately not multiples of the TPU tile sizes
    states = np.ones((3, 17), dtype=np.int8)
    states[1, 5] = 0
    counters = np.tile(np.arange(17, dtype=np.int32), (3, 1))
    valid = np.ones((3, 17), dtype=bool)
    got = _port(states, counters, valid)
    _assert_fields_equal(got, _pallas(states, counters, valid))
    assert got["drops"].tolist() == [0, 1, 0]
    assert got["flaps"].tolist() == [0, 1, 0]
    assert got["samples"].tolist() == [17, 17, 17]
    assert got["counter_delta"].tolist() == [16, 16, 16]


def test_all_down_link():
    states = np.zeros((1, 8), dtype=np.int8)
    counters = np.zeros((1, 8), np.int32)
    valid = np.ones((1, 8), bool)
    got = _port(states, counters, valid)
    _assert_fields_equal(got, _pallas(states, counters, valid))
    assert got["currently_down"].tolist() == [True]
    assert got["drops"].tolist() == [0]


def test_single_sample_rows():
    # T == 1: no pairs, so no transitions and no counter steps
    states = np.array([[1], [0], [1]], dtype=np.int8)
    counters = np.array([[5], [9], [0]], dtype=np.int32)
    valid = np.array([[True], [True], [False]])
    got = _port(states, counters, valid)
    _assert_fields_equal(got, _pallas(states, counters, valid))
    assert got["currently_down"].tolist() == [False, True, False]
    assert got["samples"].tolist() == [1, 1, 0]
    assert got["drops"].tolist() == got["counter_delta"].tolist() == [0, 0, 0]


def test_all_invalid_row():
    rng = np.random.default_rng(3)
    states, counters, valid = _packed_case(rng, L=6, T=33)
    valid[2] = False  # garbage samples behind an empty mask are ignored
    states[2] = rng.integers(0, 2, 33)
    got = _port(states, counters, valid)
    _assert_fields_equal(got, _pallas(states, counters, valid))
    assert got["samples"][2] == 0 and not got["currently_down"][2]
    assert got["drops"][2] == got["flaps"][2] == got["counter_delta"][2] == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_states_outside_zero_one(seed):
    # 2 counts as up and -1 as down (x >= 1 / x <= 0), as the Pallas
    # kernel's f32 compares against 0.5 read them
    rng = np.random.default_rng(seed)
    states, counters, valid = _packed_case(rng, L=15, T=29)
    u = rng.random(states.shape)
    states[u < 0.2] = 2
    states[(u >= 0.2) & (u < 0.4)] = -1
    _assert_fields_equal(_port(states, counters, valid),
                         _pallas(states, counters, valid))


def test_states_outside_zero_one_literal():
    states = np.array([[2, -1, 2, 2], [-1, 1, 0, -1]], dtype=np.int8)
    got = _port(states, np.zeros((2, 4), np.int32), np.ones((2, 4), bool))
    assert got["drops"].tolist() == [1, 1]
    assert got["flaps"].tolist() == [1, 1]
    assert got["currently_down"].tolist() == [False, True]


def test_empty_fleet_returns_empty_results():
    got = scan_links_packed(
        *packed_from_numpy(np.zeros((0, 5), np.int8), np.zeros((0, 5), np.int32),
                           np.zeros((0, 5), bool), "cpu")
    )
    assert isinstance(got, PackedScan)
    assert all(getattr(got, f).shape == (0,) for f in FIELDS)


def test_packed_from_numpy_makes_contiguous_typed_tensors():
    states = np.ones((4, 6), dtype=np.int64)[:, ::2]  # wrong dtype, strided
    st, ct, vl = packed_from_numpy(states, states, states, "cpu")
    assert (st.dtype, ct.dtype, vl.dtype) == (torch.int8, torch.int32, torch.bool)
    assert st.is_contiguous() and st.shape == (4, 3)
    assert st.device.type == "cpu"


@pytest.mark.parametrize(
    "bad, exc",
    [
        ("dtype", TypeError),
        ("shape", ValueError),
        ("rank", ValueError),
        ("contiguity", ValueError),
        ("mixed devices", ValueError),
        ("empty time axis", ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, exc):
    st, ct, vl = packed_from_numpy(*_packed_case(np.random.default_rng(0), 4, 6), "cpu")
    if bad == "dtype":
        ct = ct.long()
    elif bad == "shape":
        ct = ct[:, :5].contiguous()
    elif bad == "rank":
        st, ct, vl = st[0], ct[0], vl[0]
    elif bad == "contiguity":
        st = st.t().contiguous().t()
    elif bad == "mixed devices":
        vl = vl.to("meta")
    elif bad == "empty time axis":
        st, ct, vl = st[:, :0], ct[:, :0], vl[:, :0]
    launches = scan_links_packed.launches
    with pytest.raises(exc):
        scan_links_packed(st, ct, vl)
    assert scan_links_packed.launches == launches


INT32_MIN, INT32_MAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max


def _extreme_counters(rng, pattern, L=9, T=48):
    if pattern == "one step INT32_MIN -> INT32_MAX":
        counters = np.full((L, T), INT32_MIN, np.int32)
        for l, k in enumerate(rng.integers(1, T, L)):
            counters[l, k:] = INT32_MAX
    elif pattern == "alternating INT32_MIN, INT32_MAX":
        counters = np.tile(np.where(np.arange(T) % 2 == 0, INT32_MIN, INT32_MAX), (L, 1))
    else:  # random extremes and their neighbours
        counters = rng.choice(np.array([INT32_MIN, INT32_MIN + 1, -1, 0, 1,
                                        INT32_MAX - 1, INT32_MAX]), (L, T))
    return counters.astype(np.int32)


@pytest.mark.parametrize("prefix", [True, False])
@pytest.mark.parametrize("pattern", ["one step INT32_MIN -> INT32_MAX",
                                     "alternating INT32_MIN, INT32_MAX",
                                     "random extremes"])
def test_counter_delta_is_exact_in_int64_for_extreme_int32_steps(pattern, prefix):
    """The port sums positive counter steps in int64, exact for any int32
    counters: one step from INT32_MIN to INT32_MAX is 2^32 - 1, and a row's
    sum passes 2^32. The Pallas kernel sums in f32, exact only below 2^24,
    so it is no reference here: the plain version (and the CPU wrapper,
    which runs it) is held against a numpy int64 sum."""
    rng = np.random.default_rng(len(pattern) + prefix)
    L, T = 9, 48
    counters = _extreme_counters(rng, pattern, L, T)
    states = rng.integers(-1, 3, (L, T), dtype=np.int8)
    if prefix:
        valid = np.arange(T)[None, :] < rng.integers(T // 2, T + 1, L)[:, None]
    else:
        valid = rng.random((L, T)) < 0.8
    steps = np.diff(counters.astype(np.int64), axis=1)
    want = np.where(valid[:, 1:] & valid[:, :-1], np.maximum(steps, 0), 0).sum(axis=1)
    # the case is out of f32's exact range, where the Pallas sum would round
    assert (want.astype(np.float32).astype(np.int64) != want).any()
    ref = scan_links_packed_reference(*packed_from_numpy(states, counters, valid, "cpu"))
    assert ref.counter_delta.dtype == torch.int64
    np.testing.assert_array_equal(ref.counter_delta.numpy(), want)
    np.testing.assert_array_equal(_port(states, counters, valid)["counter_delta"], want)


def test_kernel_output_columns_read_back_as_the_scan_fields():
    # the CUDA path reads the kernel's [L, 5] int64 output through views:
    # currently_down is the low byte of column 2, which the kernel writes
    # as 0 or 1, viewed as bool without a second kernel
    from gpud_tpu_torch.ops.packed_scan import N_COLS, _from_columns

    out = torch.tensor([[3, 1, 1, 40, 2**40], [0, 0, 0, 0, 0], [1, 2, 0, 7, 5]],
                       dtype=torch.int64)
    assert out.shape[1] == N_COLS
    got = _from_columns(out)
    assert got.currently_down.dtype == torch.bool
    assert got.currently_down.tolist() == [True, False, False]
    assert got.drops.tolist() == [3, 0, 1] and got.flaps.tolist() == [1, 0, 2]
    assert got.samples.tolist() == [40, 0, 7]
    assert got.counter_delta.tolist() == [2**40, 0, 5]
