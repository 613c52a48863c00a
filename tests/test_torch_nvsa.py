"""``repro_torch.models.nvsa`` against the reference ``repro.models.nvsa`` on
the reference's codebooks and CNN params (converted by
``repro_torch.convert``) and numpy-drawn queries.

Contracts (ROADMAP, rules of every slice): the front end at atol 1e-5;
beliefs and the abduction tail at rtol 1e-5 with equal answers; bipolar
deterministic NVSA (fused masked sweep) bitwise; unitary deterministic NVSA
equal indices and converged flags, iterations within +-1 (see the recorded
divergence below); the default stochastic config statistically (the RNGs
differ); the adSCH cost model and plan equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import symbolic as rsym
from repro.core import vsa as rv
from repro.data import raven as rr
from repro.engine.build import plan_interleave as r_plan
from repro.models import cnn as rc
from repro.models import nvsa as rn
from repro_torch import convert
from repro_torch.core import symbolic as tsym
from repro_torch.core import vsa as tv
from repro_torch.device import disable_tf32
from repro_torch.engine.build import plan_interleave as t_plan
from repro_torch.models import nvsa as tn

ATOL, RTOL = 1e-5, 1e-5
B = 24  # tests/test_system.py's oracle batch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(kind):
    """(reference, port) NVSAConfig of one kind."""
    if kind == "default":
        return rn.NVSAConfig(), tn.NVSAConfig()
    if kind == "unitary_det":  # noise 0, no restarts, Gauss-Seidel
        pairs = [(c, dataclasses.replace(c.factorizer, noise_std=0.0,
                                         restart_every=0))
                 for c in (rn.NVSAConfig(), tn.NVSAConfig())]
    else:  # bipolar deterministic, fused (Jacobi, noise 0)
        pairs = [(c, dataclasses.replace(c.factorizer, noise_std=0.0,
                                         restart_every=0, synchronous=True,
                                         fused_step=True))
                 for c in (rn.NVSAConfig(vsa=rv.VSAConfig(1024, 1024)),
                           tn.NVSAConfig(vsa=tv.VSAConfig(1024, 1024)))]
    return tuple(dataclasses.replace(c, factorizer=f) for c, f in pairs)


def _books(cfg_r):
    cbs_r, mask_r = rn.make_codebooks(jax.random.PRNGKey(0), cfg_r)
    cbs_t, mask_t = convert.spec_arrays_from_reference(
        np.asarray(cbs_r), np.asarray(mask_r), device="cpu")
    return cbs_r, mask_r, cbs_t, mask_t


def _oracle(cfg_r, cbs_r, noise, seed=0):
    """tests/test_system.py's stand-in for a trained CNN: ground-truth
    product queries of the 9 panels [B, 9, D] and the 8 candidates [B, 8, D],
    plus ``noise`` x std Gaussian noise drawn with numpy."""
    b = rr.RavenDataset(rr.RavenConfig(batch_size=B, seed=5,
                                       render=False)).next_batch()
    attrs = np.stack([b[f"grid_{a}"].reshape(B, 9) for a in rr.ATTRS], -1)
    cands = np.stack([b[f"cand_{a}"] for a in rr.ATTRS], -1)
    rng = np.random.default_rng(seed)
    out = []
    for a in (attrs, cands):
        q = np.asarray(rn.target_query(cbs_r, jnp.asarray(a), cfg_r))
        out.append((q + noise * q.std() * rng.standard_normal(q.shape))
                   .astype(np.float32))
    return out[0], out[1], b


def _both_factorize(kind, ctx):
    cfg_r, cfg_t = _configs(kind)
    cbs_r, mask_r, cbs_t, mask_t = _books(cfg_r)
    flat = ctx[:, :8].reshape(B * 8, -1)
    bel_r, res_r = rn.beliefs_from_queries(jnp.asarray(flat), cbs_r, mask_r,
                                           jax.random.PRNGKey(1), cfg_r)
    bel_t, res_t = tn.beliefs_from_queries(torch.from_numpy(flat), cbs_t,
                                           mask_t, 1, cfg_t)
    return (bel_r, res_r), (bel_t, res_t)


# Front end --------------------------------------------------------------------

@pytest.fixture(scope="module")
def frontend():
    disable_tf32()
    cfg_r, cfg_t = _configs("default")
    cbs_r, mask_r, cbs_t, mask_t = _books(cfg_r)
    params = rc.init(jax.random.PRNGKey(1), cfg_r.cnn)
    model = convert.cnn_params_from_reference(jax.tree.map(np.asarray, params),
                                              device="cpu")
    b = rr.RavenDataset(rr.RavenConfig(batch_size=2, seed=9)).next_batch()
    return cfg_r, cfg_t, cbs_r, cbs_t, params, model, b


def test_constants_and_codebooks_shape(frontend):
    cfg_r, cfg_t, cbs_r, cbs_t, *_ = frontend
    assert tn.ATTR_SIZES == rn.ATTR_SIZES and tn.MAX_M == rn.MAX_M
    for f in ("num_factors", "codebook_size", "algebra", "activation",
              "max_iters", "noise_std", "restart_every", "conv_threshold",
              "synchronous", "fused_step"):
        assert getattr(cfg_t.factorizer, f) == getattr(cfg_r.factorizer, f), f
    cbs, mask = tn.make_codebooks(0, cfg_t, device="cpu")
    assert cbs.shape == tuple(cbs_r.shape)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(
        rn.make_codebooks(jax.random.PRNGKey(0), cfg_r)[1]))


def test_target_query_equals_the_reference(frontend):
    cfg_r, cfg_t, cbs_r, cbs_t, *_ = frontend
    attrs = np.random.default_rng(0).integers(0, (5, 6, 10), (4, 9, 3))
    np.testing.assert_allclose(
        tn.target_query(cbs_t, torch.from_numpy(attrs), cfg_t).numpy(),
        np.asarray(rn.target_query(cbs_r, jnp.asarray(attrs), cfg_r)),
        atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["logits_bind", "head"])
def test_perceive_equals_the_reference(frontend, mode):
    cfg_r, cfg_t, cbs_r, cbs_t, params, model, b = frontend
    cfg_r = dataclasses.replace(cfg_r, query_mode=mode)
    cfg_t = dataclasses.replace(cfg_t, query_mode=mode)
    for key in ("images", "candidate_images"):
        got = tn.perceive(model, torch.from_numpy(b[key]), cfg_t, cbs_t)
        want = rn.perceive(params, jnp.asarray(b[key]), cfg_r, cbs_r)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("mode", ["logits_bind", "head"])
def test_frontend_loss_matches_the_reference(frontend, mode):
    """The loss and its metrics on a rendered task batch's panels at rtol
    1e-5 (the gradients: tests/test_torch_frontend_train.py).  The loss
    trains the query head and the attribute heads whatever the query mode,
    so both modes give the same loss."""
    cfg_r, cfg_t, cbs_r, cbs_t, params, model, b = frontend
    cfg_r = dataclasses.replace(cfg_r, query_mode=mode)
    cfg_t = dataclasses.replace(cfg_t, query_mode=mode)
    imgs = b["images"][:, :8].reshape(-1, 32, 32)
    labels = {a: b[f"grid_{a}"].reshape(len(b["images"]), 9)[:, :8].reshape(-1)
              for a in ("type", "size", "color")}
    loss_r, m_r = rn.frontend_loss(params, {"images": jnp.asarray(imgs),
                                            **{k: jnp.asarray(v) for k, v in
                                               labels.items()}}, cbs_r, cfg_r)
    loss, m = tn.frontend_loss(model, {"images": torch.from_numpy(imgs),
                                       **{k: torch.from_numpy(v) for k, v in
                                          labels.items()}}, cbs_t, cfg_t)
    assert float(loss) == pytest.approx(float(loss_r), rel=RTOL)
    for k in ("cosine", "aux_ce"):
        assert float(m[k]) == pytest.approx(float(m_r[k]), rel=RTOL)


# Beliefs and the abduction tail ----------------------------------------------

def test_beliefs_and_abduction_equal_the_reference():
    cfg_r, cfg_t = _configs("default")
    cbs_r, mask_r, cbs_t, mask_t = _books(cfg_r)
    rng = np.random.default_rng(4)
    qs = rng.standard_normal((B * 8, 1024)).astype(np.float32)
    scores = (rng.standard_normal((B * 8, 3, 10)) * 10).astype(np.float32)
    bel_t = tn.beliefs_from_scores(torch.from_numpy(qs),
                                   torch.from_numpy(scores), mask_t, cfg_t)
    bel_r = rn.beliefs_from_scores(jnp.asarray(qs), jnp.asarray(scores),
                                   mask_r, cfg_r)
    np.testing.assert_allclose(bel_t.numpy(), np.asarray(bel_r), rtol=RTOL,
                               atol=1e-7)
    # The tail on the beliefs the reference decodes from oracle queries.
    ctx, cand, _ = _oracle(cfg_r, cbs_r, 0.3)
    beliefs = np.array(rn.beliefs_from_queries(
        jnp.asarray(ctx[:, :8].reshape(B * 8, -1)), cbs_r, mask_r,
        jax.random.PRNGKey(1), cfg_r)[0]).reshape(B, 8, 3, 10)
    ans_t, sims_t = tn.abduce_answers(torch.from_numpy(beliefs),
                                      torch.from_numpy(cand), cbs_t, cfg_t)
    ans_r, sims_r = rn.abduce_answers(jnp.asarray(beliefs), jnp.asarray(cand),
                                      cbs_r, cfg_r)
    np.testing.assert_array_equal(ans_t.numpy(), np.asarray(ans_r))
    np.testing.assert_allclose(sims_t.numpy(), np.asarray(sims_r), rtol=RTOL,
                               atol=1e-6)


# The factorizer behind NVSA -----------------------------------------------

def test_bipolar_deterministic_nvsa_is_bitwise_the_reference():
    """+-1 target queries through the fused masked sweep (on the CPU its
    plain version): indices, iterations, converged, scores and answers
    bitwise."""
    cfg_r, cfg_t = _configs("bipolar")
    cbs_r, mask_r, cbs_t, mask_t = _books(cfg_r)
    ctx, cand, _ = _oracle(cfg_r, cbs_r, 0.0)
    assert set(np.unique(ctx)) == {-1.0, 1.0}
    (bel_r, res_r), (bel_t, res_t) = _both_factorize("bipolar", ctx)
    for f in ("indices", "iterations", "converged", "scores"):
        np.testing.assert_array_equal(getattr(res_t, f).numpy(),
                                      np.asarray(getattr(res_r, f)), err_msg=f)
    ans_t = tn.answers_from_queries(torch.from_numpy(ctx[:, :8]),
                                    torch.from_numpy(cand), cbs_t, mask_t, 1,
                                    cfg_t)
    ans_r = rn.answers_from_queries(jnp.asarray(ctx[:, :8]), jnp.asarray(cand),
                                    cbs_r, mask_r, jax.random.PRNGKey(1), cfg_r)
    np.testing.assert_array_equal(ans_t.numpy(), np.asarray(ans_r))


@pytest.mark.parametrize("noise", [0.0, 0.3])
def test_unitary_deterministic_nvsa_matches_the_reference(noise):
    """Indices and converged flags equal on every row, iterations within +-1.

    Recorded divergence (ROADMAP Queue C): the size codebook's 6 atoms sum
    to a zero DC bin in blocks 1 and 3, so ``superposition_init``'s
    unit-spectrum projection turns round-off into another start (1.9e-3
    apart).  On the 0.3-noise oracle queries, row 155 hovers: the reference
    settles it after 28 sweeps, the port after 11, both right.  So with
    noise, iterations are held on the rows the reference settles within 5
    sweeps, as for rows placement."""
    cfg_r, _ = _configs("unitary_det")
    cbs_r = _books(cfg_r)[0]
    ctx, _, _ = _oracle(cfg_r, cbs_r, noise)
    (_, res_r), (_, res_t) = _both_factorize("unitary_det", ctx)
    for f in ("indices", "converged"):
        np.testing.assert_array_equal(getattr(res_t, f).numpy(),
                                      np.asarray(getattr(res_r, f)), err_msg=f)
    it_r, it_t = np.asarray(res_r.iterations), res_t.iterations.numpy()
    held = it_r <= 5 if noise else np.ones_like(it_r, bool)
    assert np.abs(it_r - it_t)[held].max() <= 1
    assert held.mean() > 0.98


def _oracle_accuracy(sym, beliefs, b):
    """tests/test_system.py's scoring: the symbolic tail on the candidates'
    attribute values."""
    beliefs = beliefs.reshape(B, 8, 3, 10)
    total = 0.0
    for ai, a in enumerate(rr.ATTRS):
        n = rr.ATTR_SIZES[a]
        g = beliefs[:, :, ai, :n]
        g = g / (g.sum(-1, keepdims=True) + 1e-9)
        pad = np.full((B, 1, n), 1.0 / n, np.float32)
        grid = np.concatenate([np.asarray(g), pad], 1).reshape(B, 3, 3, n)
        if sym is tsym:
            grid, cand = torch.from_numpy(grid), torch.from_numpy(b[f"cand_{a}"])
        else:
            grid, cand = jnp.asarray(grid), jnp.asarray(b[f"cand_{a}"])
        post = sym.abduce_rules(grid)
        total = total + np.asarray(sym.score_candidates(
            sym.execute_rules(grid, post), cand))
    return float((np.argmax(total, -1) == b["answer"]).mean())


def test_default_stochastic_nvsa_oracle_accuracy_in_both_packages():
    """tests/test_system.py:19-45 in both packages on the same numpy-drawn
    queries: converged share > 0.9, accuracy >= 0.85 each, within 0.1."""
    cfg_r, _ = _configs("default")
    cbs_r = _books(cfg_r)[0]
    ctx, _, b = _oracle(cfg_r, cbs_r, 0.3)
    (bel_r, res_r), (bel_t, res_t) = _both_factorize("default", ctx)
    assert float(np.asarray(res_r.converged).mean()) > 0.9
    assert float(res_t.converged.float().mean()) > 0.9
    acc_r = _oracle_accuracy(rsym, np.asarray(bel_r), b)
    acc_t = _oracle_accuracy(tsym, bel_t.numpy(), b)
    assert acc_r >= 0.85 and acc_t >= 0.85, (acc_r, acc_t)
    assert abs(acc_r - acc_t) <= 0.1


# The adSCH cost model -----------------------------------------------------

def _op_tuple(op):
    return (op.name, op.kind, tuple(op.dims), tuple(op.deps), op.symbolic,
            op.weight_resident)


@pytest.mark.parametrize("kind", ["default", "bipolar"])
@pytest.mark.parametrize("batch,sweeps", [(2, None), (32, 7)])
def test_cost_model_and_plan_equal_the_reference(kind, batch, sweeps):
    cfg_r, cfg_t = _configs(kind)
    assert [_op_tuple(o) for o in tn._neural_cost_ops(cfg_t, batch)] == \
        [_op_tuple(o) for o in rn._neural_cost_ops(cfg_r, batch)]
    assert [_op_tuple(o) for o in tn._symbolic_cost_ops(cfg_t, batch, sweeps)] == \
        [_op_tuple(o) for o in rn._symbolic_cost_ops(cfg_r, batch, sweeps)]
    g_t = tn.stage_graph(None, None, None, cfg_t, batch=batch,
                         expected_sweeps=sweeps)
    g_r = rn.stage_graph(None, None, None, cfg_r, batch=batch,
                         expected_sweeps=sweeps)
    assert not g_t.runnable and g_t.name == g_r.name
    for st_t, st_r in zip(g_t.stages, g_r.stages, strict=True):
        assert (st_t.name, st_t.symbolic) == (st_r.name, st_r.symbolic)
        assert [_op_tuple(o) for o in st_t.cost_ops] == \
            [_op_tuple(o) for o in st_r.cost_ops]
    p_t, p_r = t_plan(g_t), r_plan(g_r)
    assert p_t.lags == p_r.lags
    np.testing.assert_allclose(p_t.gains, p_r.gains, rtol=1e-9)
    np.testing.assert_allclose([p_t.makespan_seq, p_t.makespan_overlap],
                               [p_r.makespan_seq, p_r.makespan_overlap],
                               rtol=1e-9)
    if kind == "default" and batch == 2:  # tests/test_engine.py:89-95
        assert p_t.lags == (1,) and p_t.gains[0] > 1.0
