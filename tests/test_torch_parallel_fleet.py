"""The port's sharded analytics (gpud_tpu_torch/parallel/fleet.py, driven by
gpud_tpu_torch.entry.dryrun_multichip) against the single-process port and
against gpud_tpu/parallel/fleet.py on the virtual CPU devices of
tests/conftest.py.

One gloo spawn per world size (n = 1, 2, 3, 8): each runs the dry run,
which takes one dp×tp training step, scans a fleet's links and scores the
batch over the mesh, and every test below reads its results. Tolerances:
the step's loss and parameters within 1e-6 (float32 summation order is all
that differs); classes, scans and summaries exactly equal; the AE scores
rtol 1e-5 and the robust scores rtol = atol = 1e-4, as in
tests/test_torch_anomaly.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpud_tpu.models import anomaly as jax_an
from gpud_tpu.parallel import fleet as jax_fleet

from gpud_tpu_torch import entry as torch_entry
from gpud_tpu_torch.models import anomaly as torch_an
from gpud_tpu_torch.ops import window_scan as torch_ws
from gpud_tpu_torch.parallel import fleet as torch_fleet

WORLD_SIZES = [1, 2, 3, 8]


def _inputs(n):
    """The dry run's inputs, generated as the reference's dry run does."""
    mp = 2 if n % 2 == 0 else 1
    cfg = (4, 8, 16 * mp, 8)
    rng = np.random.default_rng(0)
    windows = rng.normal(size=(4 * n, cfg[0], cfg[1])).astype(np.float32)
    n_links = 8 * n
    states = rng.integers(0, 2, size=(n_links, 16)).astype(np.int8)
    counters = np.cumsum(rng.integers(0, 3, size=(n_links, 16)), axis=1).astype(np.int32)
    valid = np.ones((n_links, 16), dtype=bool)
    params0 = torch_an.ae_init(torch_an.AEConfig(*cfg), torch.Generator().manual_seed(0),
                               device="cpu")
    return dict(mp=mp, windows=windows, batch=windows.reshape(4 * n, -1),
                states=states, counters=counters, valid=valid, params0=params0)


@pytest.fixture(scope="module", params=WORLD_SIZES, ids=[f"n{n}" for n in WORLD_SIZES])
def run(request):
    n = request.param
    return n, torch_entry.dryrun_multichip(n, device="cpu"), _inputs(n)


def _jax_mesh(n, mp):
    return jax_fleet.make_mesh(n, model_parallel=mp)


def _jax_sharded_params(mesh, params):
    arrays = jax_an.AEParams(**torch_an.params_to_numpy(params))
    return jax.tree_util.tree_map(jax.device_put, arrays, jax_fleet.ae_param_sharding(mesh))


def test_dryrun_mesh_and_summary(run):
    n, res, inp = run
    assert res["mesh"] == (n // inp["mp"], inp["mp"])
    assert sum(res["summary"].values()) == 8 * n


def test_sharded_step_equals_the_unsharded_step(run):
    _, res, inp = run
    new, loss = torch_an.ae_train_step(inp["params0"], torch.from_numpy(inp["batch"]))
    assert res["loss"] == pytest.approx(float(loss), abs=1e-6)
    for name, want in zip(torch_an.AEParams._fields, new):
        torch.testing.assert_close(res["params"][name], want, rtol=0, atol=1e-6)


def test_sharded_step_equals_the_reference_sharded_step(run):
    n, res, inp = run
    mesh = _jax_mesh(n, inp["mp"])
    step = jax_fleet.make_sharded_train_step(mesh)
    jnew, jloss = step(_jax_sharded_params(mesh, inp["params0"]), jnp.asarray(inp["batch"]))
    assert res["loss"] == pytest.approx(float(jloss), abs=1e-6)
    for name, want in zip(jax_an.AEParams._fields, jnew):
        np.testing.assert_allclose(res["params"][name].numpy(), np.asarray(want),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_sharded_scan_equals_the_single_process_scan(run):
    _, res, inp = run
    scan = torch_ws.scan_links(*(torch.from_numpy(inp[k])
                                 for k in ("states", "counters", "valid")))
    assert torch.equal(res["classes"], torch_ws.classify_links(scan))
    for field in scan._fields:
        assert torch.equal(res["scan"][field], getattr(scan, field)), field
    classes = res["classes"].tolist()
    assert res["summary"] == {name: classes.count(c)
                              for c, name in enumerate(("healthy", "degraded", "unhealthy"))}


def test_sharded_scan_and_summary_equal_the_reference(run):
    n, res, inp = run
    mesh = _jax_mesh(n, inp["mp"])
    _scan, classes = jax_fleet.sharded_link_scan(mesh, inp["states"], inp["counters"],
                                                 inp["valid"])
    np.testing.assert_array_equal(res["classes"].numpy(), np.asarray(classes))
    assert res["summary"] == jax_fleet.fleet_health_summary(mesh, classes)


def test_sharded_ae_scores_equal_the_reference(run):
    n, res, inp = run
    mesh = _jax_mesh(n, inp["mp"])
    jparams = _jax_sharded_params(mesh, torch_an.params_from_numpy(res["params"], "cpu"))
    want = np.asarray(jax_fleet.sharded_ae_scores(mesh, jparams, inp["batch"]))
    np.testing.assert_allclose(res["ae_scores"].numpy(), want, rtol=1e-5)
    carried = torch_an.params_from_numpy(res["params"], "cpu")
    single = torch_an.ae_scores(carried, torch.from_numpy(inp["batch"]))
    np.testing.assert_allclose(res["ae_scores"].numpy(), single.numpy(), rtol=1e-5)


def test_sharded_robust_scores_equal_the_reference(run):
    n, res, inp = run
    mesh = _jax_mesh(n, inp["mp"])
    want = np.asarray(jax_fleet.sharded_robust_scores(mesh, inp["windows"]))
    np.testing.assert_allclose(res["robust_scores"].numpy(), want, rtol=1e-4, atol=1e-4)
    single = torch_an.robust_scores(torch.from_numpy(inp["windows"]))
    assert torch.equal(res["robust_scores"], single)


# -- without a process group ---------------------------------------------------

@pytest.mark.parametrize("field", jax_an.AEParams._fields)
def test_param_sharding_is_the_reference_layout(field):
    placements = getattr(torch_fleet.ae_param_sharding(None), field)
    spec = getattr(jax_fleet.ae_param_sharding(_jax_mesh(2, 2)), field).spec
    # the reference shards at most one dimension, over "model"
    want = [d for d, axis in enumerate(spec) if axis == "model"]
    assert [type(p).__name__ for p in placements][0] == "Replicate"
    got = [p.dim for p in placements[1:] if hasattr(p, "dim")]
    assert got == want


@pytest.mark.parametrize("n, mp", [(3, 2), (8, 3)])
def test_make_mesh_rejects_a_model_axis_that_does_not_divide(n, mp):
    with pytest.raises(ValueError, match="does not divide"):
        torch_fleet.make_mesh(n, model_parallel=mp, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        jax_fleet.make_mesh(n, model_parallel=mp)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        torch_fleet.make_mesh(2, device="cpu")
