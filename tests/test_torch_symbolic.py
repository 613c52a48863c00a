"""``repro_torch.core.symbolic`` against the reference ``repro.core.symbolic``
on the same random distributions (numpy-drawn, n in {5, 6, 10}, batch dims),
rtol 1e-5 / atol 1e-6, plus ports of the reference's own abduction tests
(``tests/test_symbolic_and_data.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import symbolic as rs
from repro.data import raven as rr
from repro_torch.core import symbolic as ts
from repro_torch.data import raven as tr

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dists(rng, shape):
    p = rng.random(shape).astype(np.float32) ** 3  # peaked, like beliefs
    return p / p.sum(-1, keepdims=True)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_constants_equal_the_reference():
    assert ts.RULES == rs.RULES and ts.NUM_RULES == rs.NUM_RULES


@pytest.mark.parametrize("n", [5, 6, 10])
@pytest.mark.parametrize("lead", [(), (7,), (3, 4)])
def test_pairwise_ops_equal_the_reference(n, lead):
    rng = np.random.default_rng(n * 10 + len(lead))
    p, q = _dists(rng, (*lead, n)), _dists(rng, (*lead, n))
    tp, tq = torch.from_numpy(p), torch.from_numpy(q)
    _close(ts._circconv_p(tp, tq), rs._circconv_p(jnp.asarray(p), jnp.asarray(q)))
    _close(ts._circcorr_p(tp, tq), rs._circcorr_p(jnp.asarray(p), jnp.asarray(q)))
    for k in (-2, -1, 1, 2):
        np.testing.assert_array_equal(ts._shift(tp, k).numpy(),
                                      np.asarray(rs._shift(jnp.asarray(p), k)))
    r = _dists(rng, (*lead, n))
    _close(ts._row_rule_score(tp, tq, torch.from_numpy(r)),
           rs._row_rule_score(jnp.asarray(p), jnp.asarray(q), jnp.asarray(r)))


@pytest.mark.parametrize("n", [5, 6, 10])
@pytest.mark.parametrize("lead", [(9,), (2, 5)])
def test_abduce_execute_score_equal_the_reference(n, lead):
    rng = np.random.default_rng(n + 100 * len(lead))
    grid = _dists(rng, (*lead, 3, 3, n))
    post_t = ts.abduce_rules(torch.from_numpy(grid))
    post_r = rs.abduce_rules(jnp.asarray(grid))
    _close(post_t, post_r)
    pred_t = ts.execute_rules(torch.from_numpy(grid), post_t)
    pred_r = rs.execute_rules(jnp.asarray(grid), post_r)
    _close(pred_t, pred_r)
    cand = rng.integers(0, n, (*lead, 8))
    _close(ts.score_candidates(pred_t, torch.from_numpy(cand)),
           rs.score_candidates(pred_r, jnp.asarray(cand)))


def test_solve_attribute_grids_equals_the_reference():
    rng = np.random.default_rng(3)
    grids = {a: _dists(rng, (16, 3, 3, n)) for a, n in rr.ATTR_SIZES.items()}
    cands = {a: rng.integers(0, n, (16, 8)) for a, n in rr.ATTR_SIZES.items()}
    got = ts.solve_attribute_grids(
        {a: torch.from_numpy(g) for a, g in grids.items()},
        {a: torch.from_numpy(c) for a, c in cands.items()})
    want = rs.solve_attribute_grids(
        {a: jnp.asarray(g) for a, g in grids.items()},
        {a: jnp.asarray(c) for a, c in cands.items()})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# Ports of tests/test_symbolic_and_data.py (abduction) ----------------------

def test_oracle_abduction_accuracy():
    ds = tr.RavenDataset(tr.RavenConfig(batch_size=256, render=False))
    b = ds.next_batch()
    grids = {a: torch.eye(tr.ATTR_SIZES[a])[torch.from_numpy(b[f"grid_{a}"]).long()]
             for a in tr.ATTRS}
    cands = {a: torch.from_numpy(b[f"cand_{a}"]) for a in tr.ATTRS}
    pred = ts.solve_attribute_grids(grids, cands)
    assert (pred.numpy() == b["answer"]).mean() >= 0.95


@pytest.mark.parametrize("rule,row", [
    ("constant", [3, 3, 3]),
    ("progression_p1", [2, 3, 4]),
    ("progression_m1", [4, 3, 2]),
    ("arithmetic_plus", [2, 3, 5]),
    ("arithmetic_minus", [5, 3, 2]),
])
def test_rule_scores_peak_correctly(rule, row):
    p = torch.eye(6)
    s = ts._row_rule_score(p[row[0]], p[row[1]], p[row[2]])
    assert float(s[ts.RULES.index(rule)]) > 0.99
