"""The port's entry() (gpud_tpu_torch/entry.py) against the reference's
__graft_entry__.entry(), with device="cpu": the same shapes, the same batch,
and the same scores once the reference's parameters are carried across
(rtol 1e-5; a few 1e-7 measured)."""

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from gpud_tpu_torch import entry as torch_entry
from gpud_tpu_torch.models import anomaly as torch_an


@pytest.fixture(scope="module")
def both():
    jfn, (jparams, jbatch) = ge.entry()
    tfn, (tparams, tbatch) = torch_entry.entry(device="cpu")
    return (jfn, jparams, jbatch), (tfn, tparams, tbatch)


def test_entry_uses_the_reference_batch(both):
    (_, _, jbatch), (_, _, tbatch) = both
    assert tbatch.device.type == "cpu" and tbatch.dtype == torch.float32
    np.testing.assert_array_equal(tbatch.numpy(), np.asarray(jbatch))


@pytest.mark.parametrize("field", torch_an.AEParams._fields)
def test_entry_params_have_the_reference_shapes(both, field):
    (_, jparams, _), (_, tparams, _) = both
    t, j = getattr(tparams, field), getattr(jparams, field)
    assert tuple(t.shape) == tuple(j.shape) and t.dtype == torch.float32


def test_entry_scores_equal_the_reference_with_its_params(both):
    (jfn, jparams, jbatch), (tfn, _, tbatch) = both
    carried = torch_an.params_from_numpy(jparams, "cpu")
    got = tfn(carried, tbatch)
    assert got.shape == (64,)
    np.testing.assert_allclose(got.numpy(), np.asarray(jfn(jparams, jbatch)), rtol=1e-5)


def test_entry_on_its_own_params_is_finite_and_deterministic(both):
    _, (tfn, tparams, tbatch) = both
    scores = tfn(tparams, tbatch)
    assert scores.shape == (64,) and torch.isfinite(scores).all()
    _, (params2, batch2) = torch_entry.entry(device="cpu")
    assert torch.equal(tfn(params2, batch2), scores)
