"""The port's supervised online runtime (``repro_torch.runtime``) against the
reference's: the ports of ``tests/test_runtime.py``'s tests (EWMA estimator
convergence, drift-triggered re-tuning, warm-handoff bit-equality, async
futures, cost-weighted stepping, mixed NVSA + LVRF + LM traffic) on the
port's engines on the CPU, plus parity with the reference package.

Contracts:

  * LVRF (bipolar): indices, iterations and converged flags bitwise equal to
    a solo run with the same key, and to the same rows through the
    reference's ``Runtime``; decoded values equal;
  * NVSA (unitary FFT algebra, not batch-layout invariant on the CPU):
    indices and converged flags equal, iterations equal on the rows that
    settle within 5 sweeps;
  * LM: tokens equal to a solo ``ServeEngine`` greedy decode;
  * telemetry and ``retune_slots``: equal floats and decisions on the same
    inputs.

Every blocking wait carries a timeout: these tests drive a background
stepper thread and must fail instead of hanging.
"""
import sys
import threading
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as R
from repro import runtime as rrt
from repro.engine.sharding.autotune import retune_slots as r_retune_slots
from repro.models import lvrf as rl
from repro_torch import convert
from repro_torch import engine
from repro_torch import runtime as rt
from repro_torch.configs import registry
from repro_torch.core import factorizer as fz
from repro_torch.device import disable_tf32, generator
from repro_torch.engine.sharding.autotune import retune_slots
from repro_torch.launch.serve import ServeEngine
from repro_torch.models import lvrf, nvsa
from repro_torch.nn import transformer as T

RESULT_TIMEOUT_S = 300.0  # generous per-request wait
FAST = 5  # unitary contract: iterations compared on rows settled this fast


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread is faster, and keeps parallel test
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Telemetry: the EWMA arrival estimator and the drift trigger
# ---------------------------------------------------------------------------

def _poisson_times(rate: float, n: int, seed: int, t0: float = 0.0):
    gaps = np.random.default_rng(seed).exponential(1.0 / rate, n)
    return t0 + np.cumsum(gaps)


def _converged_rate(est, times) -> float:
    """Feed arrivals; return the estimate time-averaged over the 2nd half
    (a single end-point EWMA read keeps ~sqrt(alpha) relative noise)."""
    samples = []
    for i, t in enumerate(times):
        est.observe(t)
        if i >= len(times) // 2:
            samples.append(est.rate(t))
    return float(np.mean(samples))


def test_ewma_converges_to_poisson_rate():
    est = rt.ArrivalEstimator(alpha=0.05)
    times = _poisson_times(50.0, 4000, seed=0)
    assert _converged_rate(est, times) == pytest.approx(50.0, rel=0.12)
    # tracks a rate change: the same estimator re-converges to 200 rps
    times2 = _poisson_times(200.0, 4000, seed=1, t0=times[-1])
    assert _converged_rate(est, times2) == pytest.approx(200.0, rel=0.12)


def test_ewma_idle_decay():
    est = rt.ArrivalEstimator(alpha=0.1)
    times = _poisson_times(10.0, 500, seed=2)
    for t in times:
        est.observe(t)
    busy = est.rate(times[-1])
    assert 5.0 < busy < 20.0  # in the right regime (end-point read is noisy)
    # 100 s of silence: the still-open gap must drag the estimate down
    assert est.rate(times[-1] + 100.0) < 0.2 * busy


def test_should_retune_triggers_exactly_at_threshold():
    assert not rt.should_retune(5.0, None, 2.0)
    assert not rt.should_retune(0.0, 5.0, 2.0)
    assert not rt.should_retune(1.999, 1.0, 2.0)
    assert not rt.should_retune(1.0 / 1.999, 1.0, 2.0)
    assert rt.should_retune(2.0, 1.0, 2.0)
    assert rt.should_retune(7.3, 1.0, 2.0)
    assert rt.should_retune(0.5, 1.0, 2.0)
    with pytest.raises(ValueError):
        rt.should_retune(1.0, 1.0, 1.0)


def test_telemetry_step_cost_ewma_units_and_idle_steps():
    """The step-time EWMA is wall seconds PER STEP UNIT (sweep), and idle
    steps (zero units) must not dilute it."""
    t = rt.EngineTelemetry()
    assert t.step_unit_s() is None
    t.on_step(1.0, 4, step_s=0.4, units=4)  # 0.1 s / sweep
    assert t.step_unit_s() == pytest.approx(0.1)
    before = t.step_unit_s()
    t.on_step(0.0, 0)
    t.on_step(0.0, 0, step_s=0.5, units=0)
    assert t.step_unit_s() == before
    t.on_step(1.0, 4, step_s=0.8, units=4)
    assert before < t.step_unit_s() < 0.2
    assert t.snapshot()["step_unit_s"] == t.step_unit_s()


@pytest.mark.parametrize("alpha", [0.05, 0.1, 0.5])
def test_estimator_and_drift_trigger_equal_the_reference(alpha):
    """The same arrivals, bursts and silences give the same EWMA floats and
    the same drift decisions in both packages."""
    rng = np.random.default_rng(int(alpha * 100))
    times = np.cumsum(rng.exponential(0.01, 300))
    ns = rng.integers(1, 4, 300)
    a, b = rt.ArrivalEstimator(alpha), rrt.ArrivalEstimator(alpha)
    ta, tb = rt.EngineTelemetry(), rrt.EngineTelemetry()
    for t, n in zip(times, ns):
        a.observe(float(t), n=int(n))
        b.observe(float(t), n=int(n))
        assert a.rate(float(t) + 0.05) == b.rate(float(t) + 0.05)
        busy, units = float(rng.random()), int(rng.integers(0, 3))
        step_s = float(rng.random()) * 1e-3
        ta.on_step(busy, int(n), step_s=step_s, units=units,
                   modeled_unit_s=2e-4)
        tb.on_step(busy, int(n), step_s=step_s, units=units,
                   modeled_unit_s=2e-4)
    assert a.rate() > 0 and a.observed == b.observed
    assert ta.utilization == tb.utilization
    assert ta.step_unit_s() == tb.step_unit_s()
    assert ta.plan_drift_ratio() == tb.plan_drift_ratio()
    for rate in (0.0, 0.5, 1.0, 1.49, 1.5, 3.0, 100.0):
        for tuned in (None, 0.0, 1.0, 2.0):
            for thr in (1.5, 2.0):
                assert rt.should_retune(rate, tuned, thr) == \
                    rrt.should_retune(rate, tuned, thr)


# ---------------------------------------------------------------------------
# Engines: LVRF at its published width (D = 2048), converted when paired
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lvrf_setup():
    disable_tf32()
    cfg = lvrf.LVRFConfig()
    atoms = lvrf.init_atoms(generator(0), cfg, device="cpu")
    spec = engine.registry.build("lvrf_rows", 0, fused_step=True, atoms=atoms,
                                 device="cpu")
    return spec, cfg, atoms


def _lvrf_queries(cfg, atoms, n_good: int, n_junk: int, seed: int):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, cfg.n_values, (n_good, 3))
    good = lvrf.encode_row(atoms, vals, cfg)
    junk = torch.from_numpy(
        rng.normal(size=(n_junk, cfg.vsa.dim)).astype(np.float32))
    return vals, good, junk


def _solo(spec, q, key):
    return fz._factorize_batched(q[None], spec.codebooks, key[None], spec.cfg,
                                 spec.valid_mask)


def _assert_bit_equal_solo(req, q, key, spec, row=0):
    solo = _solo(spec, q, key)
    assert int(req.iterations[row]) == int(solo.iterations[0])
    np.testing.assert_array_equal(req.factorization.indices[row],
                                  solo.indices[0].numpy())
    np.testing.assert_array_equal(req.factorization.converged[row],
                                  solo.converged[0].numpy())
    np.testing.assert_allclose(req.factorization.reconstruction_sim[row],
                               float(solo.reconstruction_sim[0]), rtol=1e-6)


def _lm_smoke():
    cfg = registry.get("llama3.2-3b").smoke()
    return cfg, T.init(cfg, 0, "cpu")


def _solo_tokens(cfg, model, prompt, n):
    ref = ServeEngine(cfg, model, 1, 32, device="cpu")
    ref.add_request(0, prompt)
    for _ in range(n):
        ref.step()
    return ref.generated[0][1:n + 1]


def test_runtime_records_wall_clock_step_cost(lvrf_setup):
    """A served runtime leaves a positive measured step-cost estimate, and
    the first busy step of a program generation (one-time warm-up) is kept
    out of it."""
    spec, cfg, atoms = lvrf_setup
    _, good, junk = _lvrf_queries(cfg, atoms, n_good=4, n_junk=2, seed=11)
    r = rt.Runtime()
    r.register("lvrf", engine.Engine(spec, slots=2, sweeps_per_step=2,
                                     device="cpu"))
    with r:
        gids = [r.submit("lvrf", good[i]) for i in range(4)]
        for j in range(2):
            r.submit("lvrf", junk[j])
        for g in gids:
            r.result(g, timeout=RESULT_TIMEOUT_S)
        r.drain(timeout=RESULT_TIMEOUT_S)
    t = r.telemetry["lvrf"]
    assert t.step_unit_s() is not None and 0 < t.step_unit_s() < 1.0


# ---------------------------------------------------------------------------
# Warm-handoff resize (the re-tune mechanism) on the port's engine
# ---------------------------------------------------------------------------

def test_resize_warm_handoff_bit_equal(lvrf_setup):
    """Grow AND shrink mid-flight (junk rows keep slots busy at max_iters):
    every request stays bit-equal to a solo run and to an untouched engine
    serving the same submissions."""
    spec, cfg, atoms = lvrf_setup
    vals, good, junk = _lvrf_queries(cfg, atoms, n_good=6, n_junk=3, seed=11)
    keys = fz.draw_keys(42, 6)

    def serve(resizes):
        eng = engine.Engine(spec, slots=4, sweeps_per_step=2, device="cpu")
        ids = [eng.submit(good[i], keys=keys[i][None]) for i in range(6)]
        for j in range(3):
            eng.submit(junk[j])
        fin = []
        for slots in resizes:
            fin += eng.step()
            before = eng.in_flight
            eng.resize(slots)
            assert eng.in_flight == before
            assert eng.slots == slots
        fin += eng.drain()
        return eng, ids, {r.id: r for r in fin}

    eng, ids, done = serve(resizes=(8, 2))
    assert eng.resizes_total == 2
    _, ref_ids, ref_done = serve(resizes=())
    for i in range(6):
        for req in (done[ids[i]], ref_done[ref_ids[i]]):
            _assert_bit_equal_solo(req, good[i], keys[i], spec)
            assert req.result["values"][0].tolist() == vals[i].tolist()


def test_resize_rederives_burst_unless_pinned(lvrf_setup):
    spec, _, _ = lvrf_setup
    eng = engine.Engine(spec, slots=4, device="cpu")
    derived16 = engine.derive_sweeps_per_step(spec, 16)
    eng.resize(16)
    assert eng.sweeps_per_step == derived16
    pinned = engine.Engine(spec, slots=4, sweeps_per_step=3, device="cpu")
    pinned.resize(16)
    assert pinned.sweeps_per_step == 3


def test_retune_slots_entry_point(lvrf_setup):
    spec, _, _ = lvrf_setup
    eng = engine.Engine(spec, slots=4, device="cpu")
    assert retune_slots(eng, 5.0, candidates=(8,)) == 8
    assert retune_slots(eng, 5.0, candidates=(4,)) is None
    assert retune_slots(
        types.SimpleNamespace(spec=types.SimpleNamespace(cfg=None), slots=4),
        5.0) is None
    # the measured basis times a real sweep on the engine's device
    assert retune_slots(eng, 5.0, candidates=(8,),
                        measured_sweep_s=True) == 8


@pytest.fixture(scope="module")
def lvrf_pair():
    """The reference's LVRF spec and the port's on the same converted atoms
    (D = 2048)."""
    disable_tf32()
    cfg_r = rl.LVRFConfig()
    spec_r = R.registry.build("lvrf_rows", jax.random.PRNGKey(0),
                              fused_step=True)
    atoms_r = rl.init_atoms(jax.random.split(jax.random.PRNGKey(0))[0], cfg_r)
    atoms_t = convert.lvrf_atoms_from_reference(
        {k: np.asarray(v) for k, v in atoms_r.items()}, device="cpu")
    spec_t = engine.registry.build("lvrf_rows", 0, fused_step=True,
                                   atoms=atoms_t, device="cpu")
    return spec_r, spec_t, atoms_r, cfg_r


@pytest.mark.parametrize("arrival", [0.5, 5.0, 50.0, 5e3])
@pytest.mark.parametrize("unit_s", [None, 1e-4, 1e-2])
def test_retune_slots_decisions_equal_the_reference(lvrf_pair, arrival,
                                                    unit_s):
    spec_r, spec_t, _, _ = lvrf_pair
    for slots in (4, 32):
        eng_r = R.Engine(spec_r, slots=slots)
        eng_t = engine.Engine(spec_t, slots=slots, device="cpu")
        for cands in ((4, 8, 16, 32, 64, 128, 256), (8,), (4, 32)):
            assert retune_slots(eng_t, arrival, candidates=cands,
                                measured_step_unit_s=unit_s) == \
                r_retune_slots(eng_r, arrival, candidates=cands,
                               measured_step_unit_s=unit_s)


def test_runtime_lvrf_bit_equal_to_the_reference_runtime(lvrf_pair):
    """The same bipolar LVRF rows with the same keys through the reference's
    Runtime and the port's, each with a mid-run re-tune: indices,
    iterations and converged flags bitwise equal, values equal."""
    spec_r, spec_t, atoms_r, cfg_r = lvrf_pair
    rng = np.random.default_rng(17)
    vals = rng.integers(0, cfg_r.n_values, (8, 3))
    good = np.array(rl.encode_row(atoms_r, jnp.asarray(vals), cfg_r))
    keys = np.array(jax.random.split(jax.random.PRNGKey(17), 8))
    policy = dict(threshold=2.0, check_every=1, baseline_rps=1e-3,
                  candidates=(8,))

    def serve(pkg, eng):
        r = pkg.Runtime()
        r.register("lvrf", eng, retune=pkg.RetunePolicy(**policy))
        with r:
            gids = [r.submit("lvrf", good[i], keys=keys[i][None])
                    for i in range(8)]
            reqs = [r.result(g, timeout=RESULT_TIMEOUT_S) for g in gids]
        assert r.telemetry["lvrf"].retunes >= 1 and eng.slots == 8
        return reqs

    ref = serve(rrt, R.Engine(spec_r, slots=4, sweeps_per_step=2))
    got = serve(rt, engine.Engine(spec_t, slots=4, sweeps_per_step=2,
                                  device="cpu"))
    for i, (a, b) in enumerate(zip(ref, got)):
        fa, fb = a.factorization, b.factorization
        for name in ("indices", "iterations", "converged"):
            np.testing.assert_array_equal(getattr(fb, name),
                                          np.asarray(getattr(fa, name)),
                                          err_msg=f"row {i} {name}")
        assert b.result["values"].tolist() == \
            np.asarray(a.result["values"]).tolist() == [vals[i].tolist()]


# ---------------------------------------------------------------------------
# Engine.stats(): rolling percentile window
# ---------------------------------------------------------------------------

def test_engine_stats_rolling_window(lvrf_setup):
    spec, cfg, atoms = lvrf_setup
    _, good, _ = _lvrf_queries(cfg, atoms, n_good=5, n_junk=0, seed=3)
    eng = engine.Engine(spec, slots=4, device="cpu")
    for i in range(3):
        eng.submit(good[i])
    eng.drain()
    st = eng.stats()
    assert st["completed"] == 3 and st["window_completed"] == 3
    assert st["latency_p50_ms"] is not None
    for i in range(3, 5):
        eng.submit(good[i])
    eng.drain()
    st = eng.stats()
    assert st["completed"] == 5 and st["window_completed"] == 2
    st = eng.stats()
    assert st["completed"] == 5 and st["window_completed"] == 0
    assert st["latency_p50_ms"] is None
    assert st["latency_mean_all_ms"] is not None


# ---------------------------------------------------------------------------
# Runtime: async submit/result, error isolation, cost-weighted stepping
# ---------------------------------------------------------------------------

def test_runtime_async_submit_futures(lvrf_setup):
    spec, cfg, atoms = lvrf_setup
    vals, good, _ = _lvrf_queries(cfg, atoms, n_good=6, n_junk=0, seed=5)
    r = rt.Runtime()
    r.register("lvrf", engine.Engine(spec, slots=4, device="cpu"))
    with pytest.raises(KeyError):
        r.submit("nope", good[0])
    with r:
        gids = [r.submit("lvrf", good[i]) for i in range(6)]
        reqs = [r.result(g, timeout=RESULT_TIMEOUT_S) for g in gids]
    got = np.stack([q.result["values"][0] for q in reqs])
    np.testing.assert_array_equal(got, vals)
    with pytest.raises(KeyError):
        r.result(10_000)
    st = r.stats()["lvrf"]
    assert st["completed"] == 6
    assert st["telemetry"]["submitted"] == 6
    assert st["telemetry"]["arrival_rate_rps"] > 0


def test_runtime_bad_request_fails_only_its_future(lvrf_setup):
    spec, cfg, atoms = lvrf_setup
    vals, good, _ = _lvrf_queries(cfg, atoms, n_good=1, n_junk=0, seed=6)
    cfg_lm, model = _lm_smoke()
    r = rt.Runtime()
    r.register("lvrf", engine.Engine(spec, slots=2, device="cpu"))
    r.register("lm", rt.LMEngine(cfg_lm, model, slots=2, max_len=8,
                                 device="cpu"))
    with r:
        bad = r.submit("lm", np.arange(20, dtype=np.int32))  # > max_len
        ok = r.submit("lvrf", good[0])
        with pytest.raises(ValueError):
            r.result(bad, timeout=RESULT_TIMEOUT_S)
        req = r.result(ok, timeout=RESULT_TIMEOUT_S)
    assert req.result["values"][0].tolist() == vals[0].tolist()


def test_runtime_stop_fails_unfinished_and_restarts_clean(lvrf_setup):
    spec, cfg, atoms = lvrf_setup
    vals, good, junk = _lvrf_queries(cfg, atoms, n_good=1, n_junk=1, seed=13)
    r = rt.Runtime()
    r.register("lvrf", engine.Engine(spec, slots=2, sweeps_per_step=1,
                                     device="cpu"))
    r.start()
    gid = r.submit("lvrf", junk[0])  # max_iters row: in flight for a while
    r.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        r.result(gid, timeout=10)
    with pytest.raises(RuntimeError, match="stopped"):
        r.submit("lvrf", good[0])
    r.start()
    g2 = r.submit("lvrf", good[0])
    req = r.result(g2, timeout=RESULT_TIMEOUT_S)
    r.stop()
    assert req.result["values"][0].tolist() == vals[0].tolist()


class _StubRequest:
    def __init__(self, rid):
        self.id, self.result, self.latency_s = rid, rid, 0.0


class _StubEngine:
    """Deterministic Steppable: one request retired per step, fixed modeled
    step cost (no tensors; proves the protocol is structural)."""

    def __init__(self, cost_s: float, log: list, tag: str):
        self._cost, self._log, self._tag = cost_s, log, tag
        self._queue: list = []
        self._next = 0
        self.slots = 1

    def submit(self, payload, **kw):
        rid = self._next
        self._next += 1
        self._queue.append(rid)
        return rid

    def step(self):
        self._log.append(self._tag)
        return [_StubRequest(self._queue.pop(0))] if self._queue else []

    def drain(self):
        out = []
        while self._queue:
            out += self.step()
        return out

    @property
    def in_flight(self):
        return len(self._queue)

    def step_cost_s(self):
        return self._cost

    def stats(self):
        return {"completed": self._next - len(self._queue)}


def test_runtime_cost_weighted_stepping_no_starvation():
    log: list = []
    cheap = _StubEngine(1e-6, log, "cheap")
    costly = _StubEngine(1e-3, log, "costly")
    assert isinstance(cheap, rt.Steppable)
    r = rt.Runtime()
    r.register("cheap", cheap)
    r.register("costly", costly)
    with r:
        gids = [r.submit("cheap", None) for _ in range(50)]
        gids += [r.submit("costly", None) for _ in range(50)]
        for g in gids:
            r.result(g, timeout=RESULT_TIMEOUT_S)
    last_cheap = max(i for i, t in enumerate(log) if t == "cheap")
    costly_before = sum(1 for t in log[:last_cheap] if t == "costly")
    assert costly_before <= 5, (costly_before, log[:60])


# ---------------------------------------------------------------------------
# EWMA-driven re-tune through the runtime + the mixed-traffic acceptance bar
# ---------------------------------------------------------------------------

def test_runtime_ewma_drift_triggers_retune(lvrf_setup):
    """A submit burst far above the policy baseline re-tunes the engine
    (EWMA drift -> choose_slots on the measured sweep -> warm resize) while
    results stay exact."""
    spec, cfg, atoms = lvrf_setup
    vals, good, junk = _lvrf_queries(cfg, atoms, n_good=8, n_junk=4, seed=7)
    eng = engine.Engine(spec, slots=4, sweeps_per_step=2, device="cpu")
    r = rt.Runtime()
    r.register("lvrf", eng, retune=rt.RetunePolicy(
        threshold=2.0, check_every=1, baseline_rps=1e-3, candidates=(8,),
        use_measured_cost=True))
    with r:
        gids = [r.submit("lvrf", good[i]) for i in range(8)]
        for j in range(4):
            r.submit("lvrf", junk[j])
        reqs = [r.result(g, timeout=RESULT_TIMEOUT_S) for g in gids]
        r.drain(timeout=RESULT_TIMEOUT_S)
    assert r.telemetry["lvrf"].retunes >= 1
    assert eng.slots == 8 and eng.resizes_total >= 1
    got = np.stack([q.result["values"][0] for q in reqs])
    np.testing.assert_array_equal(got, vals)


def test_runtime_mixed_traffic_acceptance(lvrf_setup):
    """One Runtime serves concurrent nvsa_abduction + lvrf_rows + LM traffic
    from its background thread across a mid-run EWMA re-tune: LVRF bit-equal
    to solo runs with the same keys, NVSA to the unitary contract against
    solo runs, LM tokens equal to a solo ServeEngine."""
    spec_l, cfg_l, atoms = lvrf_setup
    cfg_n = nvsa.NVSAConfig()
    spec_n = engine.registry.build("nvsa_abduction", 0, cfg=cfg_n,
                                   device="cpu")
    cfg_lm, model = _lm_smoke()

    rng = np.random.default_rng(0)
    attrs = torch.from_numpy(rng.integers(0, (5, 6, 10), (8, 3)))
    ctx = nvsa.target_query(spec_n.codebooks, attrs, cfg_n)
    nkeys = fz.draw_keys(5, 8)
    vals, good, junk = _lvrf_queries(cfg_l, atoms, n_good=6, n_junk=3, seed=9)
    lkeys = fz.draw_keys(6, 6)
    prompts = [np.random.default_rng(i).integers(0, cfg_lm.vocab, 4 + i)
               for i in range(2)]

    lvrf_eng = engine.Engine(spec_l, slots=4, sweeps_per_step=2, device="cpu")
    r = rt.Runtime()
    r.register("nvsa", engine.Engine(spec_n, slots=4, device="cpu"))
    r.register("lvrf", lvrf_eng, retune=rt.RetunePolicy(
        threshold=2.0, check_every=1, baseline_rps=1e-3, candidates=(8,)))
    r.register("lm", rt.LMEngine(cfg_lm, model, slots=2, max_len=32,
                                 device="cpu"))
    with r:
        g_n = r.submit("nvsa", ctx, keys=nkeys)
        g_l = [r.submit("lvrf", good[i], keys=lkeys[i][None])
               for i in range(6)]
        for j in range(3):
            r.submit("lvrf", junk[j])
        g_t = [r.submit("lm", p, max_new_tokens=5) for p in prompts]
        req_n = r.result(g_n, timeout=RESULT_TIMEOUT_S)
        req_l = [r.result(g, timeout=RESULT_TIMEOUT_S) for g in g_l]
        req_t = [r.result(g, timeout=RESULT_TIMEOUT_S) for g in g_t]
        r.drain(timeout=RESULT_TIMEOUT_S)

    assert r.telemetry["lvrf"].retunes >= 1 and lvrf_eng.slots == 8
    solo = fz._factorize_batched(ctx, spec_n.codebooks, nkeys, spec_n.cfg,
                                 spec_n.valid_mask)
    np.testing.assert_array_equal(req_n.factorization.indices,
                                  solo.indices.numpy())
    np.testing.assert_array_equal(req_n.factorization.converged,
                                  solo.converged.numpy())
    fast = solo.iterations.numpy() <= FAST
    assert fast.any()
    np.testing.assert_array_equal(req_n.iterations[fast],
                                  solo.iterations.numpy()[fast])
    for i in range(6):
        _assert_bit_equal_solo(req_l[i], good[i], lkeys[i], spec_l)
        assert req_l[i].result["values"][0].tolist() == vals[i].tolist()
    for p, req in zip(prompts, req_t):
        assert req.result["tokens"] == _solo_tokens(cfg_lm, model, p, 5)
    st = r.stats()
    assert set(st) == {"nvsa", "lvrf", "lm", "slo"}
    assert st["lm"]["tokens_total"] == 10
    assert st["lvrf"]["telemetry"]["retunes"] >= 1
    assert st["slo"]["lm"]["completed"] == 2


def test_runtime_engines_default_to_cuda(lvrf_setup):
    """Engines built without device= run on the card, and raise on a machine
    without one: the runtime adds no device fallback."""
    spec, _, _ = lvrf_setup
    if torch.cuda.is_available():
        assert engine.Engine(spec, slots=2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            engine.Engine(spec, slots=2)


# ---------------------------------------------------------------------------
# The kernel loader under threads (the stepper launches kernels too)
# ---------------------------------------------------------------------------

def _race(fn, n=8):
    """Call ``fn`` from ``n`` threads released together, with a short switch
    interval so that they interleave inside it."""
    barrier = threading.Barrier(n)
    out = [None] * n

    def worker(i):
        barrier.wait()
        out[i] = fn()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    return out


def test_kernel_loader_loads_once_from_many_threads(monkeypatch, tmp_path):
    """Threads at a kernel's first use build it once and share one loaded
    library (a stub build and a stub library: no nvcc needed)."""
    from repro_torch.kernels import _build

    builds, loads = [], []

    def slow_build(names):
        builds.append(list(names))
        time.sleep(0.05)  # a slow nvcc widens the race
        return {n: tmp_path / f"{n}.so" for n in names}

    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "build_all", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: loads.append(path) or object())
    libs = _race(lambda: _build.load("stub_kernel"))
    assert all(lib is libs[0] for lib in libs)
    assert builds == [["stub_kernel"]] and len(loads) == 1
    assert _build.load("stub_kernel") is libs[0]  # cached: no new build


def test_kernel_builds_once_from_many_threads(monkeypatch, tmp_path):
    """Threads asking build_all for the same missing library start one
    compiler process, not several onto the same temporary file."""
    from repro_torch.kernels import _build

    src = tmp_path / "stub" / "csrc" / "stub.cu"
    src.parent.mkdir(parents=True)
    src.write_text("// stub\n")
    started = []

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            started.append(cmd)
            self.out = Path(cmd[cmd.index("-o") + 1])
            self.returncode = 0

        def communicate(self):
            time.sleep(0.05)
            self.out.write_bytes(b"\x7fELF")
            return "", None

    monkeypatch.setattr(_build, "sources", lambda: {"stub": src})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeNvcc)
    out = _race(lambda: _build.build_all(["stub"]))
    assert all(o == out[0] for o in out)
    assert out[0]["stub"].exists() and len(started) == 1
