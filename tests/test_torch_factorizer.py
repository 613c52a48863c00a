"""The port's factorizer (``repro_torch.core.factorizer``) against the reference.

The same codebooks and queries (drawn with ``jax.random``, carried across as
numpy) go through ``repro.core.factorizer`` (fused sweeps in Pallas
interpret mode) and the port on the CPU (plain versions of the kernel).

Contracts: bipolar with +-1 queries is BITWISE (indices, iterations,
converged, scores; ``reconstruction_sim`` at rtol 1e-6, the frameworks may
take the norm differently); deterministic unitary (FFT) gives equal indices
and converged flags with iterations within +-1, the reference's own drift
across batch layouts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import factorizer as rfz
from repro.core import vsa as rv
from repro.core.quantization import quantize
from repro_torch import convert
from repro_torch.core import factorizer as tfz
from repro_torch.core import vsa as tv
from repro_torch.device import disable_tf32

SIZES = (5, 6, 8)  # ragged cardinalities for the masked cases


def _cfgs(**kw):
    """Reference and port FactorizerConfig with the same fields."""
    dim, blocks = kw.pop("dims", (256, 256))
    base = dict(num_factors=3, codebook_size=8, max_iters=20,
                conv_threshold=0.5)
    base.update(kw)
    return (rfz.FactorizerConfig(vsa=rv.VSAConfig(dim, blocks), **base),
            tfz.FactorizerConfig(vsa=tv.VSAConfig(dim, blocks), **base))


def _problem(rcfg, n, masked=False, seed=7):
    cbs = rfz.make_codebooks(jax.random.PRNGKey(1), rcfg)
    mask = None
    if masked:
        mask = jnp.stack([jnp.arange(rcfg.codebook_size) < s for s in SIZES])
        idxs = jnp.stack([jax.random.randint(jax.random.PRNGKey(10 + f), (n,),
                                             0, s)
                          for f, s in enumerate(SIZES)], -1)
    else:
        idxs = jax.random.randint(jax.random.PRNGKey(seed),
                                  (n, rcfg.num_factors), 0, rcfg.codebook_size)
    return cbs, mask, rfz.bind_combo(cbs, idxs, rcfg.vsa)


def _port(cbs, mask, qs):
    t_cbs, t_mask = convert.spec_arrays_from_reference(
        np.asarray(cbs), None if mask is None else np.asarray(mask),
        device="cpu")
    return t_cbs, t_mask, torch.from_numpy(np.array(qs))


def _assert_results_equal(ref, got, *, iter_tol=0, exact_scores=True):
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(ref.converged))
    it_r, it_t = np.asarray(ref.iterations), got.iterations.numpy()
    if iter_tol:
        assert np.abs(it_r - it_t).max() <= iter_tol
    else:
        np.testing.assert_array_equal(it_t, it_r)
    if exact_scores:
        np.testing.assert_array_equal(got.scores.numpy(),
                                      np.asarray(ref.scores))
    np.testing.assert_allclose(got.reconstruction_sim.numpy(),
                               np.asarray(ref.reconstruction_sim), rtol=1e-6)


CASES = {
    "fused_jacobi": dict(synchronous=True, fused_step=True),
    "fused_jacobi_abs": dict(synchronous=True, fused_step=True,
                             activation="abs"),
    "fused_masked": dict(synchronous=True, fused_step=True, masked=True),
    "jacobi": dict(synchronous=True),
    "gauss_seidel": dict(synchronous=False),
    "gauss_seidel_masked_relu": dict(synchronous=False, activation="relu",
                                     masked=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_factorize_batch_bipolar_bit_equals_reference(case):
    disable_tf32()
    kw = dict(CASES[case])
    masked = kw.pop("masked", False)
    rcfg, tcfg = _cfgs(**kw)
    cbs, mask, qs = _problem(rcfg, 5, masked)
    ref = rfz.factorize_batch(qs, cbs, jax.random.PRNGKey(2), rcfg, mask)
    t_cbs, t_mask, t_qs = _port(cbs, mask, qs)
    got = tfz.factorize_batch(t_qs, t_cbs, torch.Generator().manual_seed(2),
                              tcfg, t_mask, device="cpu")
    _assert_results_equal(ref, got)
    assert bool(np.asarray(ref.converged).any())  # the case exercises both
    if masked:
        assert got.scores[:, 0, SIZES[0]:].max() <= -1e9


def test_factorize_single_query_bit_equals_reference():
    rcfg, tcfg = _cfgs(synchronous=False)
    cbs, _, qs = _problem(rcfg, 1, seed=3)
    ref = rfz.factorize(qs[0], cbs, jax.random.PRNGKey(5), rcfg)
    t_cbs, _, t_qs = _port(cbs, None, qs)
    got = tfz.factorize(t_qs[0], t_cbs, torch.Generator().manual_seed(5), tcfg,
                        device="cpu")
    assert got.indices.shape == (3,) and got.scores.shape == (3, 8)
    _assert_results_equal(ref, got)


def test_factorize_batch_unitary_matches_reference():
    # An odd codebook size keeps the superposition's real DC/Nyquist bins off
    # exact zero, where the unit-spectrum projection would amplify round-off
    # into a different start; rows here converge after 1-5 sweeps.
    rcfg, tcfg = _cfgs(dims=(256, 4), algebra="unitary", activation="abs",
                       codebook_size=7, max_iters=30, conv_threshold=0.55)
    cbs, _, qs = _problem(rcfg, 6)
    ref = rfz.factorize_batch(qs, cbs, jax.random.PRNGKey(2), rcfg)
    t_cbs, _, t_qs = _port(cbs, None, qs)
    got = tfz.factorize_batch(t_qs, t_cbs, torch.Generator().manual_seed(2),
                              tcfg, device="cpu")
    _assert_results_equal(ref, got, iter_tol=1, exact_scores=False)
    assert bool(got.converged.all()) and int(got.iterations.max()) > 1
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores),
                               atol=1e-4)


def test_score_tie_resolves_to_the_first_index():
    """Two identical atoms score the same: both packages decode the FIRST,
    as jnp.argmax and torch.argmax do."""
    rcfg, tcfg = _cfgs(synchronous=True, fused_step=True)
    cbs = rfz.make_codebooks(jax.random.PRNGKey(1), rcfg)
    cbs = cbs.at[:, 4].set(cbs[:, 3])  # atoms 3 and 4 tie in every factor
    qs = rfz.bind_combo(cbs, jnp.array([[4, 4, 4], [3, 1, 4], [0, 4, 2]]),
                        rcfg.vsa)
    ref = rfz.factorize_batch(qs, cbs, jax.random.PRNGKey(2), rcfg)
    t_cbs, _, t_qs = _port(cbs, None, qs)
    got = tfz.factorize_batch(t_qs, t_cbs, torch.Generator(), tcfg,
                              device="cpu")
    _assert_results_equal(ref, got)
    assert not bool((got.indices == 4).any())  # the later twin never wins
    np.testing.assert_array_equal(got.indices[0].numpy(), [3, 3, 3])


SWEEP_CFGS = [
    dict(synchronous=True, fused_step=True),
    dict(synchronous=True, fused_step=True, activation="softmax"),
    dict(synchronous=False, fused_step=True),
    dict(synchronous=True),
    dict(synchronous=True, fused_step=True, codebook_fmt="int8"),
    dict(synchronous=True, fused_step=True, noise_std=0.1),
    dict(dims=(512, 4), algebra="unitary", activation="abs", fused_step=True),
]


def _op_tuple(op):
    return (op.name, op.kind, tuple(op.dims), tuple(op.deps), op.symbolic,
            op.weight_resident, op.batch)


@pytest.mark.parametrize("i", range(len(SWEEP_CFGS)))
def test_fused_eligibility_and_sweep_cost_ops_equal_reference(i):
    rcfg, tcfg = _cfgs(**SWEEP_CFGS[i])
    assert tfz.fused_sweep_eligible(tcfg) == rfz.fused_sweep_eligible(rcfg)
    for n, shards in ((1, {}), (256, {}), (33, dict(data_shards=4)),
                      (64, dict(model_shards=2)), (8, dict(fused=False))):
        assert ([_op_tuple(o) for o in tfz.sweep_cost_ops(tcfg, n, **shards)]
                == [_op_tuple(o) for o in rfz.sweep_cost_ops(rcfg, n, **shards)])
    assert tfz.codebook_bytes(tcfg) == rfz.codebook_bytes(rcfg)


@pytest.mark.parametrize("act", ["identity", "abs", "relu", "softmax"])
def test_activation_matches_reference(act):
    rcfg, tcfg = _cfgs(activation=act, temperature=0.7)
    alpha = np.random.default_rng(0).normal(size=(4, 3, 8)).astype(np.float32)
    got = tfz._activation(torch.from_numpy(alpha), tcfg).numpy()
    want = np.asarray(rfz._activation(jnp.asarray(alpha), rcfg))
    if act == "softmax":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_superposition_init_and_bind_combo_equal_reference(masked):
    rcfg, tcfg = _cfgs()
    cbs, mask, qs = _problem(rcfg, 4, masked)
    t_cbs, t_mask, t_qs = _port(cbs, mask, qs)
    np.testing.assert_array_equal(
        tfz.superposition_init(t_cbs, tcfg, t_mask).numpy(),
        np.asarray(rfz.superposition_init(cbs, rcfg, mask)))
    idx = np.array([[0, 1, 2], [4, 3, 0]])
    np.testing.assert_array_equal(
        tfz.bind_combo(t_cbs, torch.from_numpy(idx), tcfg.vsa).numpy(),
        np.asarray(rfz.bind_combo(cbs, jnp.asarray(idx), rcfg.vsa)))


@pytest.mark.parametrize("field,value", [
    ("noise_std", 0.3), ("proj_noise_std", 0.1), ("restart_every", 10)])
def test_stochastic_configs_are_refused(field, value):
    _, tcfg = _cfgs(**{field: value})
    cbs = tfz.make_codebooks(torch.Generator(), tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="counter-based RNG"):
        tfz.factorize_batch(cbs[0, :2], cbs, torch.Generator(), tcfg,
                            device="cpu")


def test_quantized_codebooks_are_refused():
    rcfg, tcfg = _cfgs(codebook_fmt="int8")
    cbs = tfz.make_codebooks(torch.Generator(), tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="QTensor"):
        tfz.make_resonator(cbs, tcfg)
    qt = quantize(rfz.make_codebooks(jax.random.PRNGKey(0), rcfg), "int8")
    with pytest.raises(NotImplementedError, match="QTensor"):
        tfz.make_resonator(qt, dataclasses.replace(tcfg, codebook_fmt="fp32"))


def test_model_axis_is_refused():
    _, tcfg = _cfgs()
    cbs = tfz.make_codebooks(torch.Generator(), tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="sharded engine"):
        tfz.make_resonator(cbs, tcfg, model_axis="model")
