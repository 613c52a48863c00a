"""The port's sharded serving against the reference, on a logical CPU mesh.

Contracts (the reference's own, tests/test_engine_sharded.py):
  * the local fused step's plain version equals the reference's local
    Pallas kernel (interpret mode) BITWISE, and two shards' padded scores
    and partial projections, summed, masked and saturated, equal the
    reference's masked oracle;
  * ``codebook_placement="replicated"`` and ``"rows"`` on bipolar LVRF rows
    are bit-identical to the reference's single-device ``Engine``: the
    packed reduction adds integers;
  * rows placement on a unitary (real) algebra follows the port's own
    ``Engine`` trajectory (indices, iterations, converged), with scores
    within a few ulps: the projection's sum is reassociated;
  * per sweep, rows placement issues F packed model reductions plus one
    one-hot convergence gather (2F + 1 with score noise or softmax), and
    the burst one data-axis live count; a fused rows spec makes one local
    launch per shard and no dense or masked one.

A 4 x 2 mesh of logical shards on the CPU (``make_host_mesh(4, 2,
device="cpu")``) stands in for the reference's eight fake host devices.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as R
from repro.core import vsa as rv
from repro.kernels.resonator_step import kernel as rsk
from repro.kernels.resonator_step import ref as rsr
from repro.models import lvrf as rl
from repro_torch import convert, obs
from repro_torch import engine as P
from repro_torch.core import factorizer as tfz
from repro_torch.core import vsa as tv
from repro_torch.device import disable_tf32
from repro_torch.kernels.resonator_step import kernel as tk
from repro_torch.kernels.resonator_step import ops as tops
from repro_torch.kernels.resonator_step import ref as tref
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lvrf as tl

D = 256


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread is faster, and keeps parallel test
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh():
    return make_host_mesh(4, 2, device="cpu")


# -- the local fused step ----------------------------------------------------

def _bipolar(rng, shape):
    return np.where(rng.random(shape) < 0.5, 1.0, -1.0).astype(np.float32)


@pytest.mark.parametrize("n", [1, 7, 130])
@pytest.mark.parametrize("act", ["identity", "abs"])
def test_local_step_bit_equals_reference_kernel_and_gathers_to_masked(n, act):
    """Port of tests/test_kernels.py's local-kernel test, F, M, D = 3, 12,
    256 over two model shards."""
    disable_tf32()
    rng = np.random.default_rng(n + 50)
    F, M = 3, 12
    cbs, qs, est = (_bipolar(rng, (F, M, D)), _bipolar(rng, (n, D)),
                    _bipolar(rng, (n, F, D)))
    mask = np.stack([np.arange(M) < m for m in (5, 12, 7)])
    M2 = M // 2
    acc_a, acc_p = torch.zeros((n, F, M)), torch.zeros((n, F, D))
    for s in range(2):  # one pass per model shard
        blk, mk = cbs[:, s * M2:(s + 1) * M2], mask[:, s * M2:(s + 1) * M2]
        a_r, p_r = rsk.resonator_step_batch_local(
            jnp.asarray(qs), jnp.asarray(est), jnp.asarray(blk),
            jnp.asarray(mk), activation=act, interpret=True)
        a_t, p_t = tops.fused_resonator_step_batch_local(
            torch.from_numpy(qs), torch.from_numpy(est), torch.from_numpy(blk),
            torch.from_numpy(mk), act)
        np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_r))
        np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_r))
        padded = torch.zeros((n, F, M))
        padded[..., s * M2:(s + 1) * M2] = a_t
        assert not bool(((acc_a != 0) & (padded != 0)).any())  # disjoint
        acc_a, acc_p = acc_a + padded, acc_p + p_t
    a_full = torch.where(torch.from_numpy(mask)[None], acc_a, -1e9)
    e_full = torch.where(acc_p >= 0, 1.0, -1.0)
    a_r, e_r = rsr.resonator_step_batch_masked_ref(
        jnp.asarray(qs), jnp.asarray(est), jnp.asarray(cbs),
        jnp.asarray(mask), activation=act)
    np.testing.assert_array_equal(a_full.numpy(), np.asarray(a_r))
    np.testing.assert_array_equal(e_full.numpy(), np.asarray(e_r))


def test_local_step_without_a_mask_is_all_rows_valid():
    rng = np.random.default_rng(3)
    cbs, qs, est = (torch.from_numpy(_bipolar(rng, (3, 5, D))),
                    torch.from_numpy(_bipolar(rng, (4, D))),
                    torch.from_numpy(_bipolar(rng, (4, 3, D))))
    got = tref.resonator_step_batch_local_ref(qs, est, cbs, None, "abs")
    want = tref.resonator_step_batch_local_ref(
        qs, est, cbs, torch.ones((3, 5), dtype=torch.bool), "abs")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("m_loc", [1, 5])
def test_launch_geometry_takes_a_shards_row_block(m_loc):
    """The serving shape's local block (64 rows a shard, F = 3, M_loc = 5,
    D = 2048) and a one-row block: clusters of 8 blocks over D, 2 rows a
    cluster, so 256 blocks fill the 132 SMs; each block's slice of the row
    block stays resident (one chunk), within the shared-memory budget, and
    M_loc is one exact score tile."""
    g = tk.launch_geometry(64, 3, m_loc, 2048, 128, 132)
    assert (g.rows, g.clusters, g.csize, g.ds, g.dc, g.mt) == \
        (2, 32, 8, 256, 256, m_loc)
    assert g.smem == 4 * tk.smem_floats(3, m_loc, 2, 256)
    assert g.smem <= tk.SMEM_BUDGET


# -- ShardedEngine against the reference Engine ------------------------------

@pytest.fixture(scope="module")
def lvrf_setup():
    disable_tf32()
    cfg_r = rl.LVRFConfig(vsa=rv.VSAConfig(D, D))
    atoms_r = rl.init_atoms(jax.random.split(jax.random.PRNGKey(0))[0], cfg_r)
    atoms_t = convert.lvrf_atoms_from_reference(
        {k: np.asarray(v) for k, v in atoms_r.items()}, device="cpu")
    cfg_t = tl.LVRFConfig(vsa=tv.VSAConfig(D, D))
    rng = np.random.default_rng(0)
    vals = rng.integers(0, cfg_r.n_values, (8, 3))
    good = np.asarray(rl.encode_row(atoms_r, jnp.asarray(vals), cfg_r))
    junk = rng.normal(size=(2, D)).astype(np.float32)
    qs = np.concatenate([good, junk])
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(42), 10))
    specs = {}
    for fused in (True, False):
        spec_r = R.registry.build("lvrf_rows", jax.random.PRNGKey(0),
                                  cfg=cfg_r, fused_step=fused)
        spec_t = P.registry.build("lvrf_rows", 0, cfg=cfg_t, fused_step=fused,
                                  atoms=atoms_t, device="cpu")
        specs[fused] = (spec_r, spec_t)
    return specs, qs, keys, vals


def _serve(eng, qs, keys):
    ids = [eng.submit(qs[i], keys=keys[i][None]) for i in range(len(qs))]
    done = {r.id: r for r in eng.drain()}
    return [done[i] for i in ids], eng


_REFERENCE_RUNS: dict = {}


def _reference_run(lvrf_setup, fused):
    if fused not in _REFERENCE_RUNS:
        specs, qs, keys, _ = lvrf_setup
        _REFERENCE_RUNS[fused] = _serve(
            R.Engine(specs[fused][0], slots=4, sweeps_per_step=3), qs, keys)
    return _REFERENCE_RUNS[fused]


def _assert_same(ref, got):
    a, b = ref.factorization, got.factorization
    np.testing.assert_array_equal(b.indices, np.asarray(a.indices))
    np.testing.assert_array_equal(b.iterations, np.asarray(a.iterations))
    np.testing.assert_array_equal(b.converged, np.asarray(a.converged))
    np.testing.assert_array_equal(b.scores, np.asarray(a.scores))
    np.testing.assert_allclose(b.reconstruction_sim,
                               np.asarray(a.reconstruction_sim), rtol=1e-6)


@pytest.mark.parametrize("placement", ["replicated", "rows"])
@pytest.mark.parametrize("fused", [True, False])
def test_sharded_engine_bit_equals_reference_engine_lvrf(lvrf_setup, fused,
                                                         placement):
    """10 requests (8 rows, 2 never-converging junk rows recycling slots
    across shards) through the reference's single-device Engine and the
    port's ShardedEngine on a 4 x 2 mesh: the 8 rows bit for bit, the junk
    rows retired unconverged at max_iters by both (Gaussian sums run in
    another order in the two frameworks)."""
    specs, qs, keys, vals = lvrf_setup
    base, eng_r = _reference_run(lvrf_setup, fused)
    got, eng = _serve(P.ShardedEngine(
        specs[fused][1], mesh=_mesh(), codebook_placement=placement, slots=4,
        sweeps_per_step=3), qs, keys)
    for i in range(8):
        _assert_same(base[i], got[i])
        assert got[i].result["values"].tolist() == \
            np.asarray(base[i].result["values"]).tolist()
    for r_ref, r_t in zip(base[8:], got[8:]):
        for r in (r_ref, r_t):
            assert not bool(np.asarray(r.factorization.converged)[0])
            assert int(np.asarray(r.iterations)[0]) == specs[fused][1].cfg.max_iters
    assert eng.sweeps_total == eng_r.sweeps_total
    assert eng.steps_total == eng_r.steps_total


def _tab7_fp32(n=32):
    """The paper's Tab. VII "2x2Grid" factorizer at fp32: unitary block
    codes, D = 1024, B = 4, F = 4, M = 10, Gauss-Seidel, |alpha|, score noise
    0.3, restarts every 20 sweeps; ``n`` problems."""
    cfg = tfz.FactorizerConfig(
        vsa=tv.VSAConfig(1024, 4), num_factors=4, codebook_size=10,
        algebra="unitary", activation="abs", noise_std=0.3, restart_every=20,
        max_iters=100, conv_threshold=0.55)
    cbs = tfz.make_codebooks(1, cfg, device="cpu")
    idx = np.random.default_rng(4).integers(0, 10, (n, 4))
    qs = tfz.bind_combo(cbs, torch.from_numpy(idx), cfg.vsa)
    return P.ServeSpec("tab07_2x2grid_fp32", codebooks=cbs, cfg=cfg), qs, idx


@pytest.mark.parametrize("variant", ["noise", "noise_free", "softmax"])
def test_one_model_shard_is_the_dense_resonator(variant):
    """The model-sharded resonator on a 1 x 1 mesh (one block holding every
    row: padding, packing, reductions and the one-hot gather, with no
    reassociated sum) equals the dense resonator bit for bit over 40 sweeps
    of Tab. VII at fp32, with score noise and restarts (two reductions per
    factor), without (one packed reduction), and with softmax."""
    spec, qs, _ = _tab7_fp32(8)
    cfg = {"noise": spec.cfg,
           "noise_free": dataclasses.replace(spec.cfg, noise_std=0.0),
           "softmax": dataclasses.replace(spec.cfg, activation="softmax")
           }[variant]
    cb, keys = spec.codebooks, tfz.draw_keys(5, len(qs))
    rs = tfz.make_resonator(cb, cfg)
    prs = tfz.make_resonator([cb], cfg,
                             model_axis=make_host_mesh(1, 1, "cpu").axis(
                                 "model"),
                             full_rows=10,
                             init_est=tfz.superposition_init(cb, cfg))
    s, (ss,) = rs.init(qs, keys), prs.init([qs], [keys])
    for _ in range(40):
        s, (ss,) = rs.sweep(qs, s), prs.sweep([qs], [ss])
    for a, b in zip(s[:-1], ss[:-1]):
        assert torch.equal(a, b)
    for a, b in zip(rs.decode(qs, s), prs.decode([qs], [ss])[0]):
        assert torch.equal(a, b)


def test_rows_placement_follows_the_unitary_stochastic_trajectory():
    """Rows placement on Tab. VII at fp32 (32 problems) against the port's
    own Engine with the same keys.  The projection's sum over the two model
    shards is reassociated, which moves the estimates by an ulp in the first
    sweep, and each sweep's unit-spectrum projection amplifies that about
    30-fold on a row that has not settled.  So a row the Engine converges
    within 5 sweeps must decode the same indices, converged flag and
    iteration count, and within 2 sweeps its scores must be within 64 ulps
    of the row's largest score; a row that hovers longer may settle at
    another sweep or on another answer.  Accuracy over the 32 must agree
    within one row."""
    spec, qs, idx = _tab7_fp32()
    keys = tfz.draw_keys(5, len(qs))
    base, _ = _serve(P.Engine(spec, slots=16, sweeps_per_step=4,
                              device="cpu"), qs, keys)
    got, eng = _serve(P.ShardedEngine(spec, mesh=_mesh(),
                                      codebook_placement="rows", slots=16,
                                      sweeps_per_step=4), qs, keys)
    assert eng._psums_per_sweep() == 2 * 4 + 2  # two per factor with noise
    fast = 0
    for a, b in zip(base, got):
        fa, fb = a.factorization, b.factorization
        if fa.iterations[0] <= 5:
            fast += 1
            for name in ("indices", "converged", "iterations"):
                np.testing.assert_array_equal(getattr(fb, name),
                                              getattr(fa, name))
        if fa.iterations[0] <= 2:
            ulp = np.spacing(np.abs(fa.scores).max(axis=-1, keepdims=True))
            assert (np.abs(fb.scores - fa.scores) <= 64 * ulp).all()
    assert fast >= len(qs) // 2
    right = [sum(bool((r.factorization.indices[0] == i).all())
                 for r, i in zip(run, idx)) for run in (base, got)]
    assert right[0] >= 0.9 * len(qs) and abs(right[0] - right[1]) <= 1


# -- resize, recover, preempt on the mesh ------------------------------------

@pytest.mark.parametrize("placement", ["replicated", "rows"])
def test_resize_warm_handoff_and_recover_on_the_mesh(lvrf_setup, placement):
    """Grow 8 -> 16 and shrink -> 4 global slots mid-flight (junk rows in
    flight both times), with a preemption and a recovery between: every
    row's result equals the uninterrupted single-device run's (bit for bit;
    the junk rows retire unconverged at max_iters), and a slot count the
    data axis does not divide is refused."""
    specs, qs, keys, _ = lvrf_setup
    spec = specs[False][1]
    clean, _ = _serve(P.Engine(spec, slots=4, sweeps_per_step=2,
                               device="cpu"), qs, keys)
    eng = P.ShardedEngine(spec, mesh=_mesh(), codebook_placement=placement,
                          slots=8, sweeps_per_step=2)
    ids = [eng.submit(qs[i], keys=keys[i][None]) for i in range(len(qs))]
    fin = list(eng.step())
    eng.resize(16)
    fin += eng.step()
    assert eng.preempt(ids[9]) == 1
    with pytest.raises(ValueError, match="data axis"):
        eng.resize(6)
    eng.resize(4)
    fin += eng.step()
    assert eng.recover() >= 1
    fin += eng.drain()
    done = {r.id: r for r in fin}
    assert len(done) == len(qs)
    assert eng.resizes_total == 2 and eng.recoveries_total == 1
    for i, rid in enumerate(ids[:8]):
        _assert_same(clean[i], done[rid])
    for rid in ids[8:]:  # junk: Gaussian sums, reassociated under rows
        assert not done[rid].factorization.converged[0]
        assert done[rid].iterations[0] == spec.cfg.max_iters


# -- collectives and launches per sweep --------------------------------------

def _counting(monkeypatch):
    """Count the calls of the plain versions (what the CPU runs in place of
    each kernel launch)."""
    calls = {"dense": 0, "masked": 0, "local": 0}
    for name, fn in (("dense", "resonator_step_batch_ref"),
                     ("masked", "resonator_step_batch_masked_ref"),
                     ("local", "resonator_step_batch_local_ref")):
        orig = getattr(tref, fn)

        def wrapped(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(tref, fn, wrapped)
    return calls


@pytest.mark.parametrize("case,placement,model_per_sweep,local_per_sweep", [
    ("fused", "rows", 3 + 1, 8),
    ("jacobi", "rows", 3 + 1, 0),
    ("fused", "replicated", 0, 0),
    ("stochastic", "rows", 2 * 3 + 1, 0),
    ("softmax", "rows", 2 * 3 + 1, 0),
])
def test_collectives_and_launches_per_sweep(lvrf_setup, monkeypatch, case,
                                            placement, model_per_sweep,
                                            local_per_sweep):
    specs, qs, keys, _ = lvrf_setup
    spec = specs[case == "fused"][1]
    if case != "fused":
        cfg = dataclasses.replace(spec.cfg, synchronous=True)
        if case == "stochastic":
            cfg = dataclasses.replace(cfg, noise_std=0.3)
        elif case == "softmax":
            cfg = dataclasses.replace(cfg, activation="softmax")
        spec = dataclasses.replace(spec, cfg=cfg)
    mesh = _mesh()
    eng = P.ShardedEngine(spec, mesh=mesh, codebook_placement=placement,
                          slots=8)
    for i in range(8):
        eng.submit(qs[i], keys=keys[i][None])
    eng._fill()
    calls = _counting(monkeypatch)
    before = dict(mesh.reductions)
    eng.state, n = eng._sweeps(eng.qs, eng.state, 3)
    assert n == 3  # no LVRF row converges within 2 sweeps at D = 256
    assert mesh.reductions["model"] - before["model"] == model_per_sweep * n
    assert mesh.reductions["data"] - before["data"] == n + 1  # + the first
    assert calls["local"] == local_per_sweep * n
    assert calls["masked"] == 0
    assert calls["dense"] == (4 * n if placement == "replicated" else 0)
    assert eng._psums_per_sweep() == model_per_sweep + 1
    assert eng.kernel_launches_per_sweep == (
        {"rows": 8, "replicated": 4}[placement] if case == "fused" else 0)


def test_gauges_and_snapshot_on_the_mesh(lvrf_setup):
    specs, qs, keys, _ = lvrf_setup
    rec = obs.Recorder()
    eng = P.ShardedEngine(specs[True][1], mesh=_mesh(),
                          codebook_placement="rows", slots=8, obs=rec)
    for i in range(4):
        eng.submit(qs[i], keys=keys[i][None])
    eng.drain()
    snap = eng.snapshot()
    assert snap["engine_kind"] == "sharded_factorizer"
    assert snap["mesh"] == {"data": 4, "model": 2}
    assert snap["codebook_placement"] == "rows"
    assert snap["slots_per_shard"] == 2 and snap["completed"] == 4
    flat = repr(rec.metrics.snapshot())
    assert "psums_per_sweep" in flat and "kernel_launches_per_sweep" in flat
    assert eng.decodes_total >= 1


# -- argument checks ---------------------------------------------------------

def test_argument_checks_raise_as_in_the_reference(lvrf_setup):
    specs, *_ = lvrf_setup
    spec = specs[True][1]
    with pytest.raises(ValueError, match="divide the codebook rows"):
        P.ShardedEngine(spec, mesh=make_host_mesh(2, 3, device="cpu"),
                        codebook_placement="rows", slots=4)
    with pytest.raises(ValueError, match="must divide slots"):
        P.ShardedEngine(spec, mesh=_mesh(), slots=6)
    qt = tfz.quantize_codebooks(spec.codebooks, "int8")
    with pytest.raises(ValueError, match="dense codebooks"):
        P.ShardedEngine(dataclasses.replace(spec, codebooks=qt), mesh=_mesh(),
                        codebook_placement="rows", slots=8)
    with pytest.raises(ValueError, match="codebook_placement"):
        P.ShardedEngine(spec, mesh=_mesh(), codebook_placement="cols",
                        slots=8)
    eng = P.ShardedEngine(spec, mesh=_mesh(), slots=8)
    with pytest.raises(ValueError, match="data axis"):
        eng.resize(10)


def test_a_cuda_mesh_without_a_gpu_raises(lvrf_setup):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    specs, *_ = lvrf_setup
    with pytest.raises(RuntimeError, match="cuda"):
        make_host_mesh(4, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        P.ShardedEngine(specs[True][1], slots=8)


def test_autotuned_slots_tile_the_data_axis(lvrf_setup):
    specs, *_ = lvrf_setup
    eng = P.ShardedEngine(specs[True][1], mesh=_mesh(),
                          codebook_placement="rows", arrival_rps=1e9)
    assert eng.slots % 4 == 0
    assert eng.slots // 4 == P.choose_slots(
        specs[True][1], arrival_rps=1e9, data_shards=4, model_shards=2)
