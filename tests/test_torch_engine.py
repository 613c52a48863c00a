"""The whole slice: LVRF row decoding through the port's ``Engine`` against the
reference ``Engine``, on the same converted atoms and codebooks.

Contracts (bipolar, +-1 queries): per-request indices, iterations, converged
flags and scores BITWISE, ``reconstruction_sim`` at rtol 1e-6, and equal
``sweeps_total`` and derived ``sweeps_per_step`` — across mid-run resizes,
preemption, cancellation and recovery.  Gaussian "junk" queries sum in
another order in the two frameworks, so for them both engines must only
retire the row unconverged at ``max_iters``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as R
from repro.core.scheduler import schedule
from repro.core import vsa as rv
from repro.models import lvrf as rl
from repro_torch import convert, obs
from repro_torch import engine as P
from repro_torch.core import vsa as tv
from repro_torch.device import disable_tf32
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


@pytest.fixture(scope="module")
def lvrf_pair():
    disable_tf32()
    cfg_r = rl.LVRFConfig(vsa=rv.VSAConfig(D, D))
    spec_r = R.registry.build("lvrf_rows", jax.random.PRNGKey(0), cfg=cfg_r,
                              fused_step=True)
    atoms_r = rl.init_atoms(jax.random.split(jax.random.PRNGKey(0))[0], cfg_r)
    atoms_t = convert.lvrf_atoms_from_reference(
        {k: np.asarray(v) for k, v in atoms_r.items()}, device="cpu")
    cfg_t = tl.LVRFConfig(vsa=tv.VSAConfig(D, D))
    spec_t = P.registry.build("lvrf_rows", 0, cfg=cfg_t, fused_step=True,
                              atoms=atoms_t, device="cpu")
    return spec_r, spec_t, atoms_r, atoms_t, cfg_r, cfg_t


def _queries(atoms_r, cfg_r, n_good, n_junk, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, cfg_r.n_values, (n_good, 3))
    good = np.asarray(rl.encode_row(atoms_r, jnp.asarray(vals), cfg_r))
    junk = rng.normal(size=(n_junk, D)).astype(np.float32)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(seed),
                                       n_good + n_junk))
    return np.concatenate([good, junk]), keys, vals


def _serve(E, spec, qs, keys, *, slots=4, sweeps=3, resizes=(), **kw):
    eng = E.Engine(spec, slots=slots, sweeps_per_step=sweeps, **kw)
    ids = [eng.submit(qs[i], keys=keys[i][None]) for i in range(len(qs))]
    fin = list(eng.step())
    for s in resizes:
        eng.resize(s)
        fin += eng.step()
    fin += eng.drain()
    done = {r.id: r for r in fin}
    return [done[i] for i in ids], eng


def _assert_same(ref, got):
    a, b = ref.factorization, got.factorization
    np.testing.assert_array_equal(b.indices, np.asarray(a.indices))
    np.testing.assert_array_equal(b.iterations, np.asarray(a.iterations))
    np.testing.assert_array_equal(b.converged, np.asarray(a.converged))
    np.testing.assert_array_equal(b.scores, np.asarray(a.scores))
    np.testing.assert_allclose(b.reconstruction_sim,
                               np.asarray(a.reconstruction_sim), rtol=1e-6)


def test_spec_carries_the_reference_codebooks(lvrf_pair):
    spec_r, spec_t, *_ = lvrf_pair
    cbs, mask = convert.spec_arrays_from_reference(
        np.asarray(spec_r.codebooks), spec_r.valid_mask, device="cpu")
    assert mask is None and spec_t.valid_mask is None
    assert torch.equal(spec_t.codebooks, cbs)
    assert spec_t.cfg.fused_step and spec_t.cfg.synchronous
    assert spec_t.cfg.max_iters == spec_r.cfg.max_iters


def test_engine_bit_equals_reference_across_resizes(lvrf_pair):
    spec_r, spec_t, atoms_r, _, cfg_r, _ = lvrf_pair
    qs, keys, vals = _queries(atoms_r, cfg_r, 7, 3, seed=4)
    got_r, eng_r = _serve(R, spec_r, qs, keys, resizes=(6, 2, 8))
    got_t, eng_t = _serve(P, spec_t, qs, keys, resizes=(6, 2, 8),
                          device="cpu")
    assert eng_t.resizes_total == eng_r.resizes_total == 3
    for i in range(7):
        _assert_same(got_r[i], got_t[i])
        assert got_t[i].result["values"].tolist() == \
            np.asarray(got_r[i].result["values"]).tolist()
    assert any(r.factorization.converged[0] for r in got_t[:7])
    for r_ref, r_t in zip(got_r[7:], got_t[7:]):  # junk rows
        for r in (r_ref, r_t):
            assert not bool(np.asarray(r.factorization.converged)[0])
            assert int(np.asarray(r.iterations)[0]) == spec_t.cfg.max_iters
    assert eng_t.sweeps_total == eng_r.sweeps_total
    assert eng_t.steps_total == eng_r.steps_total


@pytest.mark.parametrize("slots", [2, 4, 32, 256])
def test_derived_sweeps_per_step_and_step_cost_equal_reference(lvrf_pair,
                                                               slots):
    spec_r, spec_t, *_ = lvrf_pair
    assert (P.derive_sweeps_per_step(spec_t, slots)
            == R.derive_sweeps_per_step(spec_r, slots))
    eng = P.Engine(spec_t, slots=slots, device="cpu")
    assert eng.sweeps_per_step == P.derive_sweeps_per_step(spec_t, slots)
    t_unit = schedule(R.step_unit_ops(spec_r, slots), eng.hw).makespan
    assert eng.step_cost_s() == eng.sweeps_per_step * t_unit / eng.hw.freq_hz


def _disturbed(E, spec, qs, keys, **kw):
    """preempt request 1, cancel request 2, then recover, mid-run."""
    eng = E.Engine(spec, slots=4, sweeps_per_step=1, **kw)
    ids = [eng.submit(qs[i], keys=keys[i][None]) for i in range(len(qs))]
    fin = list(eng.step())  # one sweep: no LVRF row converges that fast
    assert eng.preempt(ids[1]) == 1
    assert eng.cancel(ids[2])
    fin += eng.step()
    assert eng.recover() >= 1
    fin += eng.drain()
    return ids, {r.id: r for r in fin}, eng


def test_preempt_cancel_recover_replays_bit_equal(lvrf_pair):
    spec_r, spec_t, atoms_r, _, cfg_r, _ = lvrf_pair
    qs, keys, _ = _queries(atoms_r, cfg_r, 6, 0, seed=11)
    ids_r, done_r, eng_r = _disturbed(R, spec_r, qs, keys)
    ids_t, done_t, eng_t = _disturbed(P, spec_t, qs, keys, device="cpu")
    clean_t, _ = _serve(P, spec_t, qs, keys, slots=4, sweeps=1, device="cpu")
    assert ids_r[2] not in done_r and ids_t[2] not in done_t  # cancelled
    assert eng_t.recoveries_total == eng_r.recoveries_total == 1
    for i, (rid, tid) in enumerate(zip(ids_r, ids_t)):
        if i == 2:
            continue
        _assert_same(done_r[rid], done_t[tid])
        np.testing.assert_array_equal(done_t[tid].factorization.indices,
                                      clean_t[i].factorization.indices)
        np.testing.assert_array_equal(done_t[tid].iterations,
                                      clean_t[i].iterations)
    assert eng_t.sweeps_total == eng_r.sweeps_total


def test_health_check_flags_non_finite_rows_and_recover_clears_them(lvrf_pair):
    _, spec_t, atoms_r, _, cfg_r, _ = lvrf_pair
    qs, keys, _ = _queries(atoms_r, cfg_r, 3, 0, seed=2)
    eng = P.Engine(spec_t, slots=4, sweeps_per_step=1, device="cpu")
    for i in range(3):
        eng.submit(qs[i], keys=keys[i][None])
    eng.step()
    assert eng.health_check() is None
    live = [s for s in range(4) if eng._owner[s] is not None]
    est = eng.state.est.clone()
    est[live[0], 0, 5] = float("nan")
    eng.state = eng.state._replace(est=est)
    assert f"slot rows [{live[0]}]" in eng.health_check()
    assert eng.recover() == len(live)
    clean, _ = _serve(P, spec_t, qs[:3], keys[:3], slots=4, sweeps=1,
                      device="cpu")
    done = {r.id: r for r in eng.completed.values()}
    done.update({r.id: r for r in eng.drain()})
    for i in range(3):
        np.testing.assert_array_equal(done[i].factorization.scores,
                                      clean[i].factorization.scores)


def test_snapshot_schema_and_observability(lvrf_pair):
    spec_r, spec_t, atoms_r, _, cfg_r, _ = lvrf_pair
    qs, keys, _ = _queries(atoms_r, cfg_r, 4, 0, seed=5)
    rec = obs.Recorder()
    eng = P.Engine(spec_t, slots=4, sweeps_per_step=3, obs=rec, device="cpu")
    for i in range(4):
        eng.submit(qs[i], keys=keys[i][None])
    eng.drain()
    snap = eng.snapshot()
    assert snap["completed"] == 4 and snap["window_completed"] == 4
    assert snap["sweeps_total"] == snap["units_total"] > 0
    assert set(snap) == {  # the reference Engine.snapshot schema
        "engine_kind", "slots", "units_per_step", "units_total",
        "sweeps_per_step", "steps", "sweeps_total", "completed", "resizes",
        "recoveries", "window_completed", "latency_p50_ms", "latency_p99_ms",
        "latency_mean_all_ms"}
    assert eng.stats()["window_completed"] == 4
    assert eng.snapshot()["window_completed"] == 0
    metrics = rec.metrics.snapshot()
    flat = repr(metrics)
    assert "kernel_launches_per_sweep" in flat and "sweeps" in flat
    assert eng.kernel_launches_per_sweep == 1
    names = {s.name for s in rec.spans.snapshot()}
    assert {"step", "sweep-burst", "retire", "fill"} <= names


def test_lvrf_model_functions_equal_reference(lvrf_pair):
    spec_r, spec_t, atoms_r, atoms_t, cfg_r, cfg_t = lvrf_pair
    rows_np = tl.make_rule_examples(np.random.default_rng(0),
                                    ["constant", "progression_p1",
                                     "arithmetic_plus", "distribute_three"],
                                    10, 16)
    np.testing.assert_array_equal(
        rows_np, rl.make_rule_examples(np.random.default_rng(0),
                                       ["constant", "progression_p1",
                                        "arithmetic_plus", "distribute_three"],
                                       10, 16))
    rules_r = rl.learn_rules(atoms_r, jnp.asarray(rows_np), cfg_r)
    rules_t = tl.learn_rules(atoms_t, rows_np, cfg_t)
    np.testing.assert_array_equal(rules_t.numpy(), np.asarray(rules_r))
    obs_rows = rows_np[:, :3]  # [R, 3 rows, 3]
    ab_r = rl.abduce(atoms_r, rules_r, jnp.asarray(obs_rows), cfg_r)
    ab_t = tl.abduce(atoms_t, rules_t, obs_rows, cfg_t)
    np.testing.assert_array_equal(ab_t["ood"].numpy(), np.asarray(ab_r["ood"]))
    np.testing.assert_allclose(ab_t["posterior"].numpy(),
                               np.asarray(ab_r["posterior"]), rtol=1e-5,
                               atol=1e-6)
    prefix = rows_np[:, 0, :2]
    np.testing.assert_allclose(
        tl.execute(atoms_t, rules_t, ab_t["posterior"], prefix, cfg_t).numpy(),
        np.asarray(rl.execute(atoms_r, rules_r, ab_r["posterior"],
                              jnp.asarray(prefix), cfg_r)),
        rtol=1e-5, atol=1e-6)
    # the spec's stage graph runs its encode -> abduce stages end to end
    xs = {"rows": rows_np[:2, :2], "prefix": rows_np[:2, 2, :2]}
    enc_t = spec_t.graph.stages[0].fn(xs, None)
    enc_r = spec_r.graph.stages[0].fn(
        {k: jnp.asarray(v) for k, v in xs.items()}, None)
    np.testing.assert_array_equal(enc_t[0].numpy(), np.asarray(enc_r[0]))
    np.testing.assert_allclose(
        spec_t.graph.stages[1].fn(enc_t, None).numpy(),
        np.asarray(spec_r.graph.stages[1].fn(enc_r, None)), rtol=1e-5,
        atol=1e-6)


def test_registry_builds_by_name_and_rejects_unknown_names():
    assert "lvrf_rows" in P.registry.available()
    with pytest.raises(KeyError, match="unknown pipeline"):
        P.registry.build("nope", 0)
    with pytest.raises(ValueError, match="already registered"):
        P.registry.register("lvrf_rows")(lambda g: None)


def test_entry_points_default_to_cuda_and_raise_without_a_gpu(lvrf_pair):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    _, spec_t, *_ = lvrf_pair
    with pytest.raises(RuntimeError, match="cuda"):
        P.Engine(spec_t)
    with pytest.raises(RuntimeError, match="cuda"):
        P.registry.build("lvrf_rows", 0)
    with pytest.raises(TypeError, match="FusedConfig"):
        P.Engine(spec_t, fused=True, device="cpu")


def test_from_numpy_keeps_the_tree_and_dtypes():
    tree = {"w": (np.arange(6, dtype=np.float32).reshape(2, 3),
                  [np.array([1, 2], np.int32)]),
            "b": np.array([True, False])}
    got = convert.from_numpy(tree, device="cpu")
    assert isinstance(got["w"], tuple) and isinstance(got["w"][1], list)
    assert got["w"][0].dtype == torch.float32 and got["w"][0].shape == (2, 3)
    assert got["w"][1][0].dtype == torch.int32
    assert torch.equal(got["b"], torch.tensor([True, False]))


# -- quantized and stochastic specs ------------------------------------------

def _stochastic_spec(kind):
    """A stochastic spec and its problems: bipolar Gauss-Seidel with dense
    codebooks, or the unitary int8 QTensor path of Tab. IX."""
    from repro_torch.core import factorizer as tfz

    if kind == "bipolar":
        cfg = tfz.FactorizerConfig(vsa=tv.VSAConfig(256, 256), num_factors=3,
                                   codebook_size=10, noise_std=0.3,
                                   proj_noise_std=0.1, restart_every=4,
                                   max_iters=30, conv_threshold=0.95)
        cbs = tfz.make_codebooks(3, cfg, device="cpu")
        dense = cbs
    else:
        cfg = tfz.FactorizerConfig(vsa=tv.VSAConfig(512, 4), num_factors=3,
                                   codebook_size=10, algebra="unitary",
                                   activation="abs", noise_std=0.3,
                                   restart_every=4, max_iters=30,
                                   conv_threshold=0.8, codebook_fmt="int8")
        dense = tfz.make_codebooks(3, cfg, device="cpu")
        cbs = tfz.quantize_codebooks(dense, "int8")
    rng = np.random.default_rng(8)
    qs = tfz.bind_combo(dense, torch.from_numpy(rng.integers(0, 10, (7, 3))),
                        cfg.vsa)
    noise = torch.from_numpy(rng.standard_normal(tuple(qs.shape))
                             .astype(np.float32))
    if kind == "bipolar":  # flipped signs keep the queries +-1
        qs = torch.where(noise > 0.7, -qs, qs)
    else:
        qs = qs + 0.6 * qs.std() * noise
    keys = tfz.draw_keys(9, 7)
    return P.ServeSpec("stochastic_" + kind, codebooks=cbs, cfg=cfg), qs, keys


def _solo(spec, q, key):
    from repro_torch.core import factorizer as tfz

    return tfz._factorize_batched(q[None], spec.codebooks, key[None],
                                  spec.cfg, None)


@pytest.mark.parametrize("kind", ["bipolar", "int8_unitary"])
@pytest.mark.parametrize("run", ["batched_with_resizes", "disturbed", "solo"])
def test_stochastic_rows_through_the_engine_equal_solo_runs(kind, run):
    """A stochastic row's noise comes from its pinned key and its own sweep
    index, so in a batch, across resizes, after preemption, cancellation and
    recovery, or alone in one slot it follows the solo trajectory: bit for
    bit on +-1 operands (bipolar).  The unitary algebra's FFTs and fp32
    matmuls are not batch-size invariant in their last bits on the CPU, so
    there the unitary contract holds: equal indices and converged flags,
    iterations within +-1, scores within 1e-4."""
    spec, qs, keys = _stochastic_spec(kind)
    if run == "batched_with_resizes":
        got, eng = _serve(P, spec, qs, keys, slots=4, sweeps=2,
                          resizes=(6, 2, 8), device="cpu")
        done, rows = {i: r for i, r in enumerate(got)}, range(len(qs))
        assert eng.resizes_total == 3
    elif run == "disturbed":  # preempt one live request, cancel another
        eng = P.Engine(spec, slots=4, sweeps_per_step=1, device="cpu")
        ids = [eng.submit(qs[i], keys=keys[i][None]) for i in range(len(qs))]
        fin = list(eng.step())
        live = sorted(eng.live_requests())
        assert eng.preempt(live[0]) == 1 and eng.cancel(live[1])
        fin += eng.step()
        assert eng.recover() >= 1
        fin += eng.drain()
        done = {ids.index(r.id): r for r in fin}
        rows = [i for i in range(len(qs)) if ids[i] != live[1]]
        assert sorted(done) == rows and eng.recoveries_total == 1
    else:
        got, _ = _serve(P, spec, qs, keys, slots=1, sweeps=3, device="cpu")
        done, rows = {i: r for i, r in enumerate(got)}, range(len(qs))
    exact = kind == "bipolar"
    for i in rows:
        want = _solo(spec, qs[i], keys[i])
        f = done[i].factorization
        for name in ("indices", "converged") + (
                ("iterations", "scores", "reconstruction_sim") if exact
                else ()):
            np.testing.assert_array_equal(getattr(f, name),
                                          getattr(want, name).numpy(),
                                          err_msg=f"row {i} {name}")
        if not exact:
            assert abs(int(f.iterations[0]) - int(want.iterations[0])) <= 1
            np.testing.assert_allclose(f.scores, want.scores.numpy(),
                                       atol=1e-4)
    iters = np.array([int(done[i].iterations[0]) for i in rows])
    assert (iters > 4).any()  # restarts were reached


def test_quantized_spec_serves_like_the_reference_engine():
    """A hand-built ServeSpec with int8 QTensor codebooks through both
    engines: equal indices and converged flags, iterations within +-1 (the
    unitary contract)."""
    from repro.core import factorizer as rfz
    from repro_torch.core import factorizer as tfz

    kw = dict(num_factors=3, codebook_size=9, algebra="unitary",
              activation="abs", max_iters=30, conv_threshold=0.55,
              codebook_fmt="int8")
    rcfg = rfz.FactorizerConfig(vsa=rv.VSAConfig(512, 4), **kw)
    tcfg = tfz.FactorizerConfig(vsa=tv.VSAConfig(512, 4), **kw)
    qt = rfz.quantize_codebooks(rfz.make_codebooks(jax.random.PRNGKey(1),
                                                   rcfg), "int8")
    idx = jax.random.randint(jax.random.PRNGKey(3), (6, 3), 0, 9)
    qs = np.array(rfz.bind_combo(qt.dequantize(), idx, rcfg.vsa))
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(4), 6))
    spec_r = R.ServeSpec("int8", codebooks=qt, cfg=rcfg)
    spec_t = P.ServeSpec("int8", codebooks=convert.qtensor_from_reference(
        qt, device="cpu"), cfg=tcfg)
    assert spec_t.dim == spec_r.dim == 512
    got_r, _ = _serve(R, spec_r, qs, keys, slots=4, sweeps=2)
    got_t, eng_t = _serve(P, spec_t, qs, keys, slots=4, sweeps=2,
                          device="cpu")
    for a, b in zip(got_r, got_t):
        np.testing.assert_array_equal(b.factorization.indices,
                                      np.asarray(a.factorization.indices))
        np.testing.assert_array_equal(b.factorization.converged,
                                      np.asarray(a.factorization.converged))
        assert abs(int(b.iterations[0]) - int(np.asarray(a.iterations)[0])) <= 1
    assert all(r.factorization.converged[0] for r in got_t)
    np.testing.assert_array_equal(
        np.stack([r.factorization.indices[0] for r in got_t]), np.asarray(idx))
    assert eng_t.kernel_launches_per_sweep == 3


def test_kernel_launches_per_sweep_by_spec(lvrf_pair):
    from repro_torch.core import factorizer as tfz

    _, spec_t, *_ = lvrf_pair
    assert P.Engine(spec_t, slots=2, device="cpu").kernel_launches_per_sweep == 1
    unfused = P.ServeSpec("dense", codebooks=spec_t.codebooks,
                          cfg=dataclasses.replace(spec_t.cfg,
                                                  fused_step=False))
    assert P.Engine(unfused, slots=2,
                    device="cpu").kernel_launches_per_sweep == 0
    for fmt, launches in (("int8", 3), ("fp8_e4m3", 0)):
        cfg = dataclasses.replace(spec_t.cfg, codebook_fmt=fmt)
        spec = P.ServeSpec(fmt, codebooks=tfz.quantize_codebooks(
            spec_t.codebooks, fmt), cfg=cfg)
        eng = P.Engine(spec, slots=2, device="cpu")
        assert eng.kernel_launches_per_sweep == launches
        assert isinstance(eng.spec.codebooks, type(spec.codebooks))
        assert eng.spec.dim == spec_t.dim == D
    assert P.ServeSpec("none").codebooks is None
