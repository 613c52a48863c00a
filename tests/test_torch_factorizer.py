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
from repro_torch import convert
from repro_torch.core import factorizer as tfz
from repro_torch.core import vsa as tv
from repro_torch.device import disable_tf32

SIZES = (5, 6, 8)  # ragged cardinalities for the masked cases


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread is faster, and keeps parallel test
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# -- quantized codebooks (Tab. IX) -------------------------------------------

QCASES = {  # deterministic configs; the reference's QTensor branch
    "unitary_gauss_seidel": dict(dims=(512, 4), algebra="unitary",
                                 activation="abs", codebook_size=9,
                                 max_iters=40, conv_threshold=0.55),
    "unitary_masked_5_6_10": dict(dims=(512, 4), algebra="unitary",
                                  activation="abs", codebook_size=10,
                                  max_iters=40, conv_threshold=0.55,
                                  masked=True),
    "bipolar_jacobi": dict(synchronous=True, codebook_size=10),
}


def _qproblem(kw, fmt, n=12):
    kw = dict(kw)
    masked = kw.pop("masked", False)
    rcfg, tcfg = _cfgs(codebook_fmt=fmt, **kw)
    cbs = rfz.make_codebooks(jax.random.PRNGKey(1), rcfg)
    mask = None
    if masked:
        sizes = (5, 6, 10)
        mask = jnp.stack([jnp.arange(rcfg.codebook_size) < s for s in sizes])
        idxs = jnp.stack([jax.random.randint(jax.random.PRNGKey(10 + f), (n,),
                                             0, s)
                          for f, s in enumerate(sizes)], -1)
    else:
        idxs = jax.random.randint(jax.random.PRNGKey(7),
                                  (n, rcfg.num_factors), 0,
                                  rcfg.codebook_size)
    qs = rfz.bind_combo(cbs, idxs, rcfg.vsa)
    return rcfg, tcfg, rfz.quantize_codebooks(cbs, fmt), mask, qs, idxs


@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("case", list(QCASES))
def test_quantized_factorize_batch_matches_reference(case, fmt):
    """Equal indices and converged flags, iterations within +-1: the
    reference's own contract across batch layouts
    (tests/test_factorizer_batch.py); final scores within fp32 (int8) or
    bf16 (fp8) rounding."""
    disable_tf32()
    rcfg, tcfg, qt, mask, qs, idxs = _qproblem(QCASES[case], fmt)
    ref = rfz.factorize_batch(qs, qt, jax.random.PRNGKey(2), rcfg, mask)
    t_qt = convert.qtensor_from_reference(qt, device="cpu")
    t_mask = None if mask is None else torch.from_numpy(np.array(mask))
    got = tfz.factorize_batch(torch.from_numpy(np.array(qs)), t_qt,
                              torch.Generator().manual_seed(2), tcfg, t_mask,
                              device="cpu")
    _assert_results_equal(ref, got, iter_tol=1, exact_scores=False)
    # fp8 scores are bf16 products in both packages: one bf16 rounding
    # (2^-9 relative) apart where the two sum in another order
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores),
                               atol=1e-4 if fmt == "int8" else 4e-3)
    conv = got.converged.numpy()
    assert conv.any()  # and every converged row decodes right
    np.testing.assert_array_equal(got.indices.numpy()[conv],
                                  np.asarray(idxs)[conv])


def test_quantized_superposition_init_equals_reference():
    rcfg, tcfg, qt, mask, _, _ = _qproblem(QCASES["unitary_masked_5_6_10"],
                                           "int8")
    got = tfz.superposition_init(convert.qtensor_from_reference(qt, "cpu"),
                                 tcfg, torch.from_numpy(np.array(mask)))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(rfz.superposition_init(qt, rcfg, mask)),
        atol=1e-6)


def test_int8_scores_go_through_the_similarity_op_once_per_factor():
    from repro_torch.kernels.similarity import ops as sim_ops

    _, tcfg, qt, _, qs, _ = _qproblem(QCASES["unitary_gauss_seidel"], "int8")
    calls = []
    real = sim_ops.codebook_scores

    def spy(q, codebook):
        calls.append(tuple(codebook.shape))
        return real(q, codebook)

    sim_ops.codebook_scores = spy
    try:
        got = tfz.factorize_batch(torch.from_numpy(np.array(qs)),
                                  convert.qtensor_from_reference(qt, "cpu"),
                                  2, tcfg, device="cpu")
    finally:
        sim_ops.codebook_scores = real
    assert len(calls) == 3 * int(got.iterations.max())
    assert set(calls) == {(9, 512)}


# -- stochasticity injection (Sec. IV-B) --------------------------------------

HARD = dict(dims=(1024, 4), num_factors=4, codebook_size=10,
            algebra="unitary", activation="abs", max_iters=150,
            conv_threshold=0.9)


def _hard_problem(rcfg, n=32):
    """tests/test_factorizer.py's problem set: codebooks from PRNGKey(1),
    indices from PRNGKey(7)."""
    cbs = rfz.make_codebooks(jax.random.PRNGKey(1), rcfg)
    idxs = jax.random.randint(jax.random.PRNGKey(7),
                              (n, rcfg.num_factors), 0, rcfg.codebook_size)
    return cbs, np.asarray(idxs), rfz.bind_combo(cbs, idxs, rcfg.vsa)


@pytest.mark.parametrize("fmt", ["fp32", "int8"])
def test_stochasticity_improves_the_hard_case(fmt):
    """The reference's own bar (tests/test_factorizer.py): noise 0.3 and
    restarts every 20 beat the deterministic sweep by more than 5 points."""
    _, tcfg0 = _cfgs(codebook_fmt=fmt, **HARD)
    rcfg, tcfg1 = _cfgs(codebook_fmt=fmt, noise_std=0.3, restart_every=20,
                        **HARD)
    cbs, idxs, qs = _hard_problem(rcfg)
    t_cbs = torch.from_numpy(np.array(cbs))
    if fmt == "int8":
        t_cbs = tfz.quantize_codebooks(t_cbs, "int8")
    t_qs = torch.from_numpy(np.array(qs))
    acc = [float((tfz.factorize_batch(t_qs, t_cbs, 2, c, device="cpu")
                  .indices.numpy() == idxs).all(-1).mean())
           for c in (tcfg0, tcfg1)]
    assert acc[1] > acc[0] + 0.05, acc


@pytest.mark.parametrize("fmt", ["fp32", "int8"])
def test_tab07_stochastic_accuracy_is_the_reference_s(fmt):
    """Tab. VII "2x2Grid" (benchmarks/paper_tables.py: F=4, M=10, D=1024,
    B=4, noise 0.3, restarts every 20, 48 problems with query noise 0.3 std):
    the port's accuracy within 0.1 of the reference's on the same problems
    (the two draw different noise)."""
    rcfg, tcfg = _cfgs(dims=(1024, 4), num_factors=4, codebook_size=10,
                       algebra="unitary", activation="abs", noise_std=0.3,
                       restart_every=20, max_iters=100, conv_threshold=0.55,
                       codebook_fmt=fmt)
    cbs = rfz.make_codebooks(jax.random.PRNGKey(1), rcfg)
    idxs = jax.random.randint(jax.random.PRNGKey(0), (48, 4), 0, 10)
    qs = rfz.bind_combo(cbs, idxs, rcfg.vsa)
    qs = qs + 0.3 * jnp.std(qs) * jax.random.normal(jax.random.PRNGKey(1),
                                                     qs.shape)
    cb_r = rfz.quantize_codebooks(cbs, fmt) if fmt == "int8" else cbs
    ref = rfz.factorize_batch(qs, cb_r, jax.random.PRNGKey(2), rcfg)
    cb_t = (convert.qtensor_from_reference(cb_r, "cpu") if fmt == "int8"
            else torch.from_numpy(np.array(cbs)))
    got = tfz.factorize_batch(torch.from_numpy(np.array(qs)), cb_t, 2, tcfg,
                              device="cpu")
    idxs = np.asarray(idxs)
    acc_r = float((np.asarray(ref.indices) == idxs).all(-1).mean())
    acc_t = float((got.indices.numpy() == idxs).all(-1).mean())
    assert abs(acc_t - acc_r) <= 0.1, (acc_t, acc_r)
    assert acc_t >= 0.85


STOCHASTIC = {  # each noise source alone, on a bipolar Gauss-Seidel problem
    "noise_std": dict(noise_std=0.3),
    "proj_noise_std": dict(proj_noise_std=0.5),
    "restart_every": dict(restart_every=3),
    "jacobi_all_three": dict(synchronous=True, noise_std=0.3,
                             proj_noise_std=0.2, restart_every=4),
}


@pytest.mark.parametrize("case", list(STOCHASTIC))
def test_stochastic_rows_do_not_depend_on_their_batch(case):
    """Each row's noise is a function of its key and its own sweep index:
    a row solo, in a batch, or in a shuffled batch gives the same bits, and
    the noise is live (the deterministic trajectory differs)."""
    kw = dict(num_factors=3, codebook_size=10, max_iters=30,
              conv_threshold=0.95)
    _, tcfg = _cfgs(**kw, **STOCHASTIC[case])
    _, tcfg0 = _cfgs(**kw, synchronous=STOCHASTIC[case].get("synchronous",
                                                            False))
    cbs = tfz.make_codebooks(3, tcfg, device="cpu")
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, 10, (6, 3)))
    qs = tfz.bind_combo(cbs, idx, tcfg.vsa)
    qs = qs * torch.where(torch.rand(qs.shape, generator=torch.Generator()
                                     .manual_seed(1)) < 0.25, -1.0, 1.0)
    keys = tfz.draw_keys(4, 6)
    batch = tfz._factorize_batched(qs, cbs, keys, tcfg, None)
    perm = torch.tensor([3, 0, 5, 1, 4, 2])
    shuffled = tfz._factorize_batched(qs[perm], cbs, keys[perm], tcfg, None)
    for i in range(6):
        solo = tfz._factorize_batched(qs[i:i + 1], cbs, keys[i:i + 1], tcfg,
                                      None)
        j = int((perm == i).nonzero())
        for name in tfz.FactorizerResult._fields:
            assert torch.equal(getattr(solo, name)[0], getattr(batch, name)[i])
            assert torch.equal(getattr(shuffled, name)[j],
                               getattr(batch, name)[i])
    plain = tfz._factorize_batched(qs, cbs, keys, tcfg0, None)
    assert not torch.equal(plain.scores, batch.scores)
    other = tfz._factorize_batched(qs, cbs, tfz.draw_keys(5, 6), tcfg, None)
    assert not torch.equal(other.scores, batch.scores)


def test_restarts_rerandomise_stuck_rows_only():
    """A row that has not converged when its sweep count reaches a multiple
    of restart_every starts again from fresh normalised noise."""
    _, tcfg = _cfgs(num_factors=3, codebook_size=10, max_iters=8,
                    conv_threshold=1.1, restart_every=4)  # never converges
    cbs = tfz.make_codebooks(3, tcfg, device="cpu")
    rs = tfz.make_resonator(cbs, tcfg)
    qs = cbs[0, :2] * cbs[1, :2] * cbs[2, :2]
    s = rs.init(qs, tfz.draw_keys(1, 2))
    for _ in range(3):
        s = rs.sweep(qs, s)
    before = s.est.clone()
    s = rs.sweep(qs, s)  # the 4th sweep restarts both rows
    assert s.iters.tolist() == [4, 4]
    from repro_torch.core import rng
    want = tfz._norm(rng.normal(s.keys, s.iters, rng.RESTART, 3, 256), tcfg)
    assert torch.equal(s.est, want) and not torch.equal(s.est, before)


def test_factorize_refuses_keys_outside_the_counter_range():
    _, tcfg = _cfgs(noise_std=0.3)
    cbs = tfz.make_codebooks(0, tcfg, device="cpu")
    rs = tfz.make_resonator(cbs, tcfg)
    with pytest.raises(ValueError, match="2\\^62"):
        rs.init(cbs[0, :1], torch.tensor([[-1, 3]]))
    with pytest.raises(ValueError, match="max_iters"):
        tfz.make_resonator(cbs, dataclasses.replace(tcfg, max_iters=1 << 20))


def test_model_axis_is_refused():
    _, tcfg = _cfgs()
    cbs = tfz.make_codebooks(torch.Generator(), tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="sharded engine"):
        tfz.make_resonator(cbs, tcfg, model_axis="model")


def test_well_conditioned_rows_survive_another_summation_order():
    """The card's similarity kernel applies each row's scale after its sum;
    the plain version scales the codebook first.  The rows that converge
    within 5 sweeps (the paper's regime) must decode the same with either
    order -- the contract ``chip_smoke.py`` holds the card to against the
    CPU -- while a row that hovers longer may go another way."""
    from repro_torch.kernels.similarity import ops as sim_ops

    cfg = tfz.FactorizerConfig(vsa=tv.VSAConfig(1024, 4), num_factors=3,
                               codebook_size=10, algebra="unitary",
                               activation="abs", max_iters=100,
                               conv_threshold=0.55, codebook_fmt="int8")
    cbs = tfz.make_codebooks(1, cfg, device="cpu")
    idx = np.random.default_rng(7).integers(0, 10, (256, 3))
    qs = tfz.bind_combo(cbs, torch.from_numpy(idx), cfg.vsa)
    qt = tfz.quantize_codebooks(cbs, "int8")
    plain = tfz.factorize_batch(qs, qt, 0, cfg, device="cpu")
    real = sim_ops._ref.similarity_int8_ref
    sim_ops._ref.similarity_int8_ref = \
        lambda q, w, s: (q @ w.to(torch.float32).T) * s[:, 0]
    try:
        other = tfz.factorize_batch(qs, qt, 0, cfg, device="cpu")
    finally:
        sim_ops._ref.similarity_int8_ref = real
    fast = plain.iterations <= 5
    assert fast.float().mean() >= 0.95
    assert torch.equal(other.indices[fast], plain.indices[fast])
    assert torch.equal(other.converged[fast], plain.converged[fast])
    assert (other.iterations - plain.iterations)[fast].abs().max() <= 1
