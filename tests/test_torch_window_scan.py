"""The port's window scan and health classes (gpud_tpu_torch/ops/
window_scan.py) against gpud_tpu/ops/window_scan.py on the same numpy
inputs. Counts and classes must be exactly equal; down_time_frac, an f32
division on both sides, within 1e-6 absolute."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gpud_tpu.ops import window_scan as jax_ws

from gpud_tpu_torch.ops import window_scan as torch_ws

INT_FIELDS = ("drops", "flaps", "currently_down", "counter_delta")

# the four cases of tests/test_jax_analytics.py: (states, counters, valid)
CASES = {
    "reference_semantics": (
        [[1, 1, 1, 1, 1, 1], [1, 0, 1, 0, 0, 0], [0, 0, 0, 0, 0, 0]],
        [[0, 0, 0, 0, 0, 0], [0, 10, 20, 30, 40, 50], [5, 4, 10, 10, 10, 10]],
        None,
    ),
    "transitions_span_gaps": (
        [[1, 0, 0, 1, 1]], None, [[True, False, True, False, True]],
    ),
    "counter_delta_spans_gaps": (
        [[1, 1, 1, 1]], [[10, 0, 30, 35]], [[True, False, True, True]],
    ),
    "ragged_validity": (
        [[1, 0, 1, 1]], None, [[True, True, False, False]],
    ),
}

# what tests/test_jax_analytics.py asserts of each case
EXPECTED = {
    "reference_semantics": dict(drops=[0, 2, 0], flaps=[0, 1, 0],
                                currently_down=[False, True, True],
                                counter_delta=[0, 50, 6]),
    "transitions_span_gaps": dict(drops=[1], flaps=[1], currently_down=[False]),
    "counter_delta_spans_gaps": dict(counter_delta=[25]),
    "ragged_validity": dict(drops=[1], currently_down=[True]),
}


def _arrays(states, counters, valid):
    states = np.asarray(states, dtype=np.int8)
    counters = (np.zeros(states.shape, np.int32) if counters is None
                else np.asarray(counters, dtype=np.int32))
    valid = (np.ones(states.shape, bool) if valid is None
             else np.asarray(valid, dtype=bool))
    return states, counters, valid


def _both(states, counters, valid):
    ref = jax_ws.scan_links(jnp.asarray(states), jnp.asarray(counters),
                            jnp.asarray(valid))
    got = torch_ws.scan_links(torch.from_numpy(states), torch.from_numpy(counters),
                              torch.from_numpy(valid))
    return got, ref


def _assert_scan_equal(got, ref):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(
            getattr(got, f).numpy().astype(np.int64),
            np.asarray(getattr(ref, f)).astype(np.int64), err_msg=f,
        )
    np.testing.assert_allclose(got.down_time_frac.numpy(),
                               np.asarray(ref.down_time_frac), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(CASES))
def test_scan_links_matches_jax_on_reference_cases(name):
    got, ref = _both(*_arrays(*CASES[name]))
    _assert_scan_equal(got, ref)
    for field, want in EXPECTED[name].items():
        assert getattr(got, field).tolist() == want, field


def test_classify_reference_case():
    got, ref = _both(*_arrays(*CASES["reference_semantics"]))
    classes = torch_ws.classify_links(got, flap_threshold=2, crc_threshold=100)
    assert classes.dtype == torch.int32
    assert classes.tolist() == [0, 2, 2]
    assert classes.tolist() == np.asarray(
        jax_ws.classify_links(ref, flap_threshold=2, crc_threshold=100)).tolist()


def _random_ragged(seed, L=37, T=123):
    rng = np.random.default_rng(seed)
    states = (rng.random((L, T)) > 0.1).astype(np.int8)
    states[rng.random((L, T)) < 0.03] = 2  # neither up (== 1) nor down (== 0)
    counters = np.cumsum(rng.integers(0, 30, (L, T)), axis=1).astype(np.int32)
    resets = rng.random((L, T)) < 0.02
    counters[resets] = 0
    valid = rng.random((L, T)) > rng.uniform(0.0, 0.9)
    valid[0] = False  # an empty row
    valid[1, 1:] = False  # a single sample
    return states, counters, valid


@pytest.mark.parametrize("seed", [7, 8, 9, 10])
def test_scan_links_matches_jax_on_random_ragged_masks(seed):
    got, ref = _both(*_random_ragged(seed))
    _assert_scan_equal(got, ref)


@pytest.mark.parametrize("flap_threshold, crc_threshold", [(3, 100), (1, 10), (5, 1000)])
def test_classify_links_matches_jax(flap_threshold, crc_threshold):
    got, ref = _both(*_random_ragged(11))
    want = jax_ws.classify_links(ref, flap_threshold=flap_threshold,
                                 crc_threshold=crc_threshold)
    classes = torch_ws.classify_links(got, flap_threshold=flap_threshold,
                                      crc_threshold=crc_threshold)
    np.testing.assert_array_equal(classes.numpy(), np.asarray(want))
    assert len(set(classes.tolist())) >= 2  # the case is not trivial
