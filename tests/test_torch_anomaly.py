"""The port's analytics models (gpud_tpu_torch/models/) against
gpud_tpu/models/ on the same numpy inputs, on the CPU.

Tolerances:
- robust_scores: rtol = atol = 1e-4 against both JAX's robust_scores and
  the numpy twin. The three compute one function in three orders (JAX's
  associative scan, a Hillis–Steele scan, a sequential loop); the
  reference's own numpy/JAX parity test uses the same bound.
- The autoencoder's forward: rtol 1e-5 (a few 1e-7 measured); the
  reconstruction also takes atol 1e-6 for its elements near 0.
- One training step: parameters within 1e-6 at lr 1e-3 and 1e-4 at lr 1.0,
  where a step that did not round its gradients to bf16 as JAX does would
  show.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpud_tpu.models import anomaly as jax_an
from gpud_tpu.models.anomaly_np import robust_scores_np as ref_robust_scores_np

from gpud_tpu_torch import entry as torch_entry
from gpud_tpu_torch.models import anomaly as torch_an
from gpud_tpu_torch.models.anomaly_np import robust_scores_np

ENTRY_CFG = (16, 8, 256, 32)
SMALL_CFG = (8, 8, 32, 8)


def _windows(shape, seed=0, drift_chip=None):
    rng = np.random.default_rng(seed)
    w = rng.normal(50.0, 0.5, size=shape).astype(np.float32)
    if drift_chip is not None:  # a temperature ramp in the last quarter
        T = shape[1]
        w[drift_chip, T - T // 4:, 0] += np.linspace(0, 40, T // 4)
    return w


# (label, shape, drifting chip): T - 1 even and odd, F = 7 (the anomaly
# component's feature count) and the fleet sweep's window length
SCORER_CASES = [
    ("drifting_chip_4x64x8", (4, 64, 8), 2),
    ("T2", (5, 2, 8), None),
    ("T17", (5, 17, 8), 1),
    ("T18", (5, 18, 8), 3),
    ("T180", (6, 180, 8), 0),
    ("F7", (3, 40, 7), 2),
]


def _reference(which, w):
    if which == "jax":
        return np.asarray(jax_an.robust_scores(jnp.asarray(w)))
    return robust_scores_np(w)


@pytest.mark.parametrize("which", ["jax", "numpy"])
@pytest.mark.parametrize("label, shape, drift", SCORER_CASES,
                         ids=[c[0] for c in SCORER_CASES])
def test_robust_scores_matches_the_reference(which, label, shape, drift):
    w = _windows(shape, seed=len(label), drift_chip=drift)
    got = torch_an.robust_scores(torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (shape[0],)
    np.testing.assert_allclose(got.numpy(), _reference(which, w), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("which", ["jax", "numpy"])
def test_robust_scores_takes_bf16_windows(which):
    w = _windows((4, 64, 8), drift_chip=2)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    w_rounded = wb.float().numpy()  # the values both sides see
    got = torch_an.robust_scores(wb).numpy()
    np.testing.assert_allclose(got, _reference(which, w_rounded), rtol=1e-4, atol=1e-4)
    if which == "jax":  # JAX casts its own bf16 input to float32 first too
        ref = np.asarray(jax_an.robust_scores(jnp.asarray(w_rounded).astype(jnp.bfloat16)))
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_robust_scores_flags_the_drifting_chip():
    # tests/test_jax_analytics.py's case, on the port
    rng = np.random.default_rng(0)
    w = rng.normal(50.0, 0.5, size=(4, 64, 8)).astype(np.float32)
    w[2, 48:, 0] += np.linspace(0, 40, 16)
    scores = torch_an.robust_scores(torch.from_numpy(w)).numpy()
    assert scores[2] == max(scores)
    assert scores[2] > 3 * max(scores[0], scores[1], scores[3])


@pytest.mark.parametrize("shape", [(4, 1, 8), (4, 64), (2, 3, 4, 5)])
def test_robust_scores_rejects_bad_shapes_with_the_shape(shape):
    with pytest.raises(ValueError, match=r"\(" + ", ".join(map(str, shape)) + r"\)"):
        torch_an.robust_scores(torch.zeros(shape))


@pytest.mark.parametrize("shape", [(4, 64, 8), (3, 1, 8), (2, 17, 7), (7, 180, 8)])
def test_numpy_twin_equals_the_reference_twin(shape):
    w = _windows(shape, seed=shape[1])
    np.testing.assert_array_equal(robust_scores_np(w), ref_robust_scores_np(w))


def test_ewma_scan_equals_the_sequential_recurrence():
    x = torch.from_numpy(_windows((3, 5, 77)))
    got = torch_an._ewma(x, 0.3)
    ref = torch.empty_like(x)
    ref[..., 0] = x[..., 0]
    for t in range(1, x.shape[-1]):
        ref[..., t] = 0.7 * ref[..., t - 1] + 0.3 * x[..., t]
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("n", [1, 2, 7, 8])
def test_median_averages_the_two_middle_values(n):
    x = torch.from_numpy(np.random.default_rng(n).normal(size=(3, 4, n)).astype(np.float32))
    got = torch_an._median(x)
    np.testing.assert_allclose(got.numpy(), np.median(x.numpy(), axis=-1, keepdims=True),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the autoencoder, from the reference's parameters carried across
# ---------------------------------------------------------------------------

def _jax_params(cfg, seed=0):
    return jax_an.ae_init(jax.random.PRNGKey(seed), jax_an.AEConfig(*cfg))


def _batch(cfg, n=64, seed=0):
    d = cfg[0] * cfg[1]
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("cfg", [SMALL_CFG, ENTRY_CFG], ids=["small", "entry"])
@pytest.mark.parametrize("fn", ["ae_apply", "ae_scores", "ae_loss"])
def test_autoencoder_forward_matches_the_reference(cfg, fn):
    jp = _jax_params(cfg)
    tp = torch_an.params_from_numpy(jp, "cpu")
    b = _batch(cfg, seed=cfg[2])
    ref = np.asarray(getattr(jax_an, fn)(jp, jnp.asarray(b)))
    got = getattr(torch_an, fn)(tp, torch.from_numpy(b)).detach().numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 if fn == "ae_apply" else 0)


@pytest.mark.parametrize("cfg", [SMALL_CFG, ENTRY_CFG], ids=["small", "entry"])
@pytest.mark.parametrize("lr, atol", [(1e-3, 1e-6), (1.0, 1e-4)], ids=["lr1e-3", "lr1"])
def test_train_step_matches_the_reference(cfg, lr, atol):
    jp = _jax_params(cfg, seed=1)
    tp = torch_an.params_from_numpy(jp, "cpu")
    b = _batch(cfg, seed=2)
    jnew, jloss = jax_an.ae_train_step(jp, jnp.asarray(b), lr=lr)
    tnew, tloss = torch_an.ae_train_step(tp, torch.from_numpy(b), lr=lr)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for name, ref in zip(jax_an.AEParams._fields, jnew):
        got = torch_an.params_to_numpy(tnew)[name]
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=atol, err_msg=name)


def test_train_step_leaves_its_input_alone():
    tp = torch_an.params_from_numpy(_jax_params(SMALL_CFG), "cpu")
    before = [p.clone() for p in tp]
    new, _ = torch_an.ae_train_step(tp, torch.from_numpy(_batch(SMALL_CFG)), lr=0.5)
    for b, p, n in zip(before, tp, new):
        assert torch.equal(b, p) and not p.requires_grad and not n.requires_grad
    assert not all(torch.equal(p, n) for p, n in zip(tp, new))


def test_train_step_works_under_no_grad():
    tp = torch_an.params_from_numpy(_jax_params(SMALL_CFG), "cpu")
    b = torch.from_numpy(_batch(SMALL_CFG))
    want, _ = torch_an.ae_train_step(tp, b)
    with torch.no_grad():
        got, _ = torch_an.ae_train_step(tp, b)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_autoencoder_trains_and_scores_on_its_own_init():
    # tests/test_jax_analytics.py's 60-step case, on the port's own init
    cfg = torch_an.AEConfig(window=8, features=8, hidden=32, latent=8)
    params = torch_an.ae_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    nominal = torch_an.windows_to_batch(
        torch.from_numpy(rng.normal(0, 1, size=(128, cfg.window, cfg.features))))
    loss0 = None
    for _ in range(60):
        params, loss = torch_an.ae_train_step(params, nominal, lr=1e-2)
        if loss0 is None:
            loss0 = float(loss)
    assert float(loss) < loss0
    anomalous = nominal.clone()
    anomalous[0] *= 8.0
    scores = torch_an.ae_scores(params, anomalous).numpy()
    assert scores[0] > 2 * np.median(scores)


def test_ae_init_is_glorot_normal_with_zero_biases():
    cfg = torch_an.AEConfig(*ENTRY_CFG)
    p = torch_an.ae_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = _jax_params(ENTRY_CFG)
    for name, t, r in zip(torch_an.AEParams._fields, p, ref):
        assert t.shape == r.shape and t.dtype == torch.float32, name
        if name.startswith("b_"):
            assert not t.any(), name
        else:
            want = np.sqrt(2.0 / sum(t.shape))
            assert abs(float(t.std()) / want - 1) < 0.1, name
    again = torch_an.ae_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(p, again))


@pytest.mark.parametrize("form", ["reference_params", "mapping", "tuple_of_numpy"])
def test_params_carry_across_both_ways(form):
    jp = _jax_params(SMALL_CFG, seed=3)
    as_numpy = {n: np.asarray(a) for n, a in zip(jax_an.AEParams._fields, jp)}
    arg = {"reference_params": jp, "mapping": as_numpy,
           "tuple_of_numpy": tuple(as_numpy.values())}[form]
    back = torch_an.params_to_numpy(torch_an.params_from_numpy(arg, "cpu"))
    assert list(back) == list(jax_an.AEParams._fields)
    for name in back:
        np.testing.assert_array_equal(back[name], as_numpy[name])
    jax_an.AEParams(**back)  # the reference takes the result back


def test_params_from_numpy_rejects_a_short_tuple():
    with pytest.raises(ValueError, match="expected 8 arrays"):
        torch_an.params_from_numpy((np.zeros(3),) * 7, "cpu")


def test_windows_to_batch_matches_the_reference():
    w = _windows((5, 16, 8))
    got = torch_an.windows_to_batch(torch.from_numpy(w).double())
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_an.windows_to_batch(jnp.asarray(w))))


def test_module_forward_and_gradients_are_the_functions():
    tp = torch_an.params_from_numpy(_jax_params(SMALL_CFG), "cpu")
    b = torch.from_numpy(_batch(SMALL_CFG))
    module = torch_an.TelemetryAutoencoder(tp)
    assert [n for n, _ in module.named_parameters()] == list(torch_an.AEParams._fields)
    torch.testing.assert_close(module(b), torch_an.ae_apply(tp, b), rtol=0, atol=0)
    torch.mean(torch.square(module(b) - b)).backward()
    new, _ = torch_an.ae_train_step(tp, b, lr=1.0)
    for p, n, m in zip(tp, new, module.parameters()):
        torch.testing.assert_close(p - m.grad, n, rtol=0, atol=0)


def test_products_round_their_inputs_to_bf16():
    a = torch.tensor([[1.0 + 2.0 ** -10]])
    w = torch.tensor([[1.0 + 2.0 ** -12]])
    assert float(torch_an.mm(a, w)) == 1.0  # both round to 1.0 in bf16


def test_summation_order_moves_fleet_scores_within_the_card_tolerance(monkeypatch):
    # why chip_smoke.py holds the card's ae_scores on raw fleet telemetry
    # (about 50) to rtol 2e-3 and not 1e-5: another float32 summation order
    # (here: products accumulated in float64) flips some bf16 roundings of
    # the large pre-activations
    _, (params, _) = torch_entry.entry(device="cpu")
    w = np.random.default_rng(3).normal(50, 0.5, size=(16384, 16, 8)).astype(np.float32)
    batch = torch_an.windows_to_batch(torch.from_numpy(w))
    base = torch_an.ae_scores(params, batch)
    monkeypatch.setattr(torch_an, "mm", lambda a, w: (
        torch_an.bf16_round(a).double() @ torch_an.bf16_round(w).double()).float())
    other = torch_an.ae_scores(params, batch)
    rel = float(((base - other) / other).abs().max())
    assert 1e-5 < rel < 2e-3, rel
