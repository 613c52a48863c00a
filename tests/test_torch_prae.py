"""``repro_torch.models.prae`` against ``repro.models.prae`` on the
reference's ``cnn.init`` weights (carried across by
``convert.cnn_params_from_reference``) and the reference test's task batch
(``RavenConfig(batch_size=32, seed=123)``).

Tolerances: the perceived probabilities at atol 1e-6 (softmax of fp32
logits that agree to 1e-5); the per-candidate totals (sums of three logs of
expected probabilities) at rtol 1e-5; answers equal except on a task whose
top two totals lie within 1e-5 of each other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import symbolic as rsym
from repro.data import raven as rr
from repro.models import cnn as rc
from repro.models import nvsa as rn
from repro.models import prae as rp
from repro_torch import convert
from repro_torch.device import disable_tf32
from repro_torch.models import cnn as tc
from repro_torch.models import prae as tp

PROB_ATOL = 1e-6
TOTAL_RTOL = 1e-5
TIE = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    disable_tf32()
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = rn.NVSAConfig().cnn
    params = rc.init(jax.random.PRNGKey(11), cfg)
    model = convert.cnn_params_from_reference(
        jax.tree.map(np.asarray, params), device="cpu")
    b = rr.RavenDataset(rr.RavenConfig(batch_size=32, seed=123)).next_batch()
    return cfg, params, model, b


@jax.jit
def _ref_totals_jit(params, images, cands):
    cfg = rn.NVSAConfig().cnn
    B = images.shape[0]
    ctx = rp.perceive_probs(params, images[:, :8], cfg)
    cand = rp.perceive_probs(params, cands, cfg)
    total = jnp.zeros((B, 8))
    for a, name in enumerate(rr.ATTRS):
        n = rr.ATTR_SIZES[name]
        grid = jnp.concatenate([ctx[a], jnp.full((B, 1, n), 1.0 / n)],
                               axis=1).reshape(B, 3, 3, n)
        pred = rsym.execute_rules(grid, rsym.abduce_rules(grid))
        total = total + jnp.log(jnp.einsum("bn,bcn->bc", pred, cand[a]) + 1e-9)
    return total


def _ref_totals(params, b):
    """The reference's ``prae.solve`` up to its argmax."""
    return np.asarray(_ref_totals_jit(params, jnp.asarray(b["images"]),
                                      jnp.asarray(b["candidate_images"])))


_ref_probs = jax.jit(rp.perceive_probs, static_argnums=2)
_ref_solve = jax.jit(rp.solve, static_argnums=2)


def test_perceive_probs_matches_the_reference(setup):
    cfg, params, model, b = setup
    for key in ("images", "candidate_images"):
        want = _ref_probs(params, jnp.asarray(b[key]), cfg)
        got = tp.perceive_probs(model, torch.from_numpy(b[key]), cfg)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=PROB_ATOL, rtol=0)


def test_solve_matches_the_reference(setup):
    cfg, params, model, b = setup
    want = _ref_totals(params, b)
    np.testing.assert_array_equal(  # the oracle above is the reference's solve
        np.argmax(want, -1), np.asarray(_ref_solve(
            params, {k: jnp.asarray(v) for k, v in b.items()}, cfg)))
    got = tp.candidate_scores(model, b, cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=TOTAL_RTOL)
    ans = tp.solve(model, b, cfg).numpy()
    top2 = np.sort(want, -1)[:, -2:]
    near_tie = top2[:, 1] - top2[:, 0] <= TIE
    assert ((ans == np.argmax(want, -1)) | near_tie).all()
    acc = float(tp.accuracy(model, b, cfg))
    assert acc == pytest.approx(float((ans == b["answer"]).mean()))


def test_a_port_model_scores_the_same_in_the_reference():
    """``cnn_params_to_reference`` carries a port model (here a seeded
    ``cnn.init``) into the reference's layout: the reference's
    ``prae.accuracy`` on it equals the port's."""
    cfg = rn.NVSAConfig().cnn
    model = tc.init(tc.CNNConfig(), 5, device="cpu")
    b = rr.RavenDataset(rr.RavenConfig(batch_size=16, seed=7)).next_batch()
    params = jax.tree.map(jnp.asarray, convert.cnn_params_to_reference(model))
    want = _ref_solve(params, {k: jnp.asarray(v) for k, v in b.items()}, cfg)
    np.testing.assert_array_equal(tp.solve(model, b, cfg).numpy(),
                                  np.asarray(want))
