"""The port's fault model and supervision (``repro_torch.runtime.faults`` and
the ``Runtime``'s quarantine, replay, deadlines, shedding and watchdog):
the ports of ``tests/test_runtime_faults.py``'s tests, plus parity with the
reference's chaos harness.

The invariant: under any seeded FaultPlan every submitted future resolves —
a result or a structured FaultError, never a hang — and replayed requests
equal a fault-free run (bitwise on LVRF's +-1 rows and on LM greedy tokens;
NVSA's unitary rows to the unitary contract: indices and converged flags
equal, iterations equal on rows that settle within 5 sweeps).  The fault
schedule is a pure function of (plan, call index) and equal to the
reference's on the same call sequence; the NaN poke is a functional update
of the state on its device, as the reference's ``.at[row].set``.

Every blocking wait carries a timeout.
"""
import time
import warnings

import numpy as np
import pytest
import torch

from repro.runtime import faults as rflt
from repro_torch import engine
from repro_torch import runtime as rt
from repro_torch.configs import registry
from repro_torch.core import factorizer as fz
from repro_torch.device import disable_tf32, generator
from repro_torch.launch.serve import ServeEngine
from repro_torch.models import lvrf, nvsa
from repro_torch.nn import transformer as T
from repro_torch.runtime import faults as flt

RESULT_TIMEOUT_S = 300.0
FAST = 5  # unitary contract: iterations compared on rows settled this fast

FAST_FAILURE = rt.FailurePolicy(max_restarts=50, backoff_initial_s=0.01,
                                backoff_max_s=0.05, health_check_every=2)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Stub engine: deterministic Steppable with scriptable faults (no tensors)
# ---------------------------------------------------------------------------

class _StubRequest:
    def __init__(self, rid):
        self.id, self.result, self.latency_s = rid, rid, 0.0


class _StubEngine:
    """One request retired per step; faults scripted by step index."""

    def __init__(self, fail_on=(), recoverable=True, step_sleep=0.0):
        self._queue: list = []
        self._next = 0
        self.slots = 4
        self.steps = 0
        self.fail_on = set(fail_on)
        self.step_sleep = step_sleep
        self.recoveries_total = 0
        if not recoverable:
            self.recover = None  # not callable -> supervisor kills on fault

    def submit(self, payload, **kw):
        rid = self._next
        self._next += 1
        self._queue.append(rid)
        return rid

    def step(self):
        self.steps += 1
        if self.step_sleep:
            time.sleep(self.step_sleep)
        if self.steps in self.fail_on:
            raise ValueError(f"scripted fault at step {self.steps}")
        return [_StubRequest(self._queue.pop(0))] if self._queue else []

    def recover(self):
        self.recoveries_total += 1
        return len(self._queue)

    def cancel(self, rid):
        if rid in self._queue:
            self._queue.remove(rid)
            return True
        return False

    def drain(self):
        out = []
        while self._queue:
            out += self.step()
        return out

    @property
    def in_flight(self):
        return len(self._queue)

    def stats(self):
        return {"completed": self._next - len(self._queue)}


# ---------------------------------------------------------------------------
# FaultPlan / ChaosEngine: validation, determinism, transparency, parity
# ---------------------------------------------------------------------------

def test_fault_plan_validates():
    with pytest.raises(ValueError):
        flt.FaultPlan(step_error_rate=1.5)
    with pytest.raises(ValueError):
        flt.FaultPlan(corrupt_rate=-0.1)
    with pytest.raises(ValueError):
        flt.FaultPlan(hang_rate=0.5)
    flt.FaultPlan(hang_rate=0.5, hang_s=0.01)


def _step_schedule(mod, plan, n_steps, submit_every):
    """Drive a wrapped stub; return the per-step (error?, hang?) schedule
    and the per-submit rejections."""
    ce = mod.ChaosEngine(_StubEngine(), plan, sleep=lambda s: None)
    sched, rejects = [], []
    for k in range(n_steps):
        if submit_every and k % submit_every == 0:
            try:
                ce.submit(None)
                rejects.append(0)
            except mod.InjectedFault:
                rejects.append(1)
        before = dict(ce.injected)
        try:
            ce.step()
        except mod.InjectedFault:
            pass
        sched.append((ce.injected["step_error"] - before["step_error"],
                      ce.injected["hang"] - before["hang"]))
    return sched, rejects, dict(ce.injected)


def test_chaos_schedule_is_pure_function_of_seed():
    plan = flt.FaultPlan(seed=3, step_error_rate=0.3, hang_rate=0.2,
                         hang_s=1e-4, submit_reject_rate=0.5)
    a, _, _ = _step_schedule(flt, plan, 60, submit_every=1)
    b, _, _ = _step_schedule(flt, plan, 60, submit_every=7)
    assert a == b and sum(e for e, _ in a) > 0 and sum(h for _, h in a) > 0
    capped, _, _ = _step_schedule(
        flt, flt.FaultPlan(seed=3, step_error_rate=0.3, hang_rate=0.2,
                           hang_s=1e-4, submit_reject_rate=0.5, max_faults=2),
        60, 1)
    fired = 0
    for (e, h), (ce_, ch) in zip(a, capped):
        if fired >= 2:
            assert (ce_, ch) == (0, 0)
        fired += e + h


PLANS = [
    dict(seed=3, step_error_rate=0.3, hang_rate=0.2, hang_s=1e-4,
         submit_reject_rate=0.5),
    dict(seed=3, step_error_rate=0.3, hang_rate=0.2, hang_s=1e-4,
         submit_reject_rate=0.5, max_faults=4),
    dict(seed=101, step_error_rate=0.12, corrupt_rate=0.08, max_faults=3),
    dict(seed=303, step_error_rate=0.1, submit_reject_rate=0.3, max_faults=3),
    dict(seed=7, storm_rate=0.4, storm_burst=2, submit_reject_rate=0.2),
]


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("submit_every", [1, 3])
def test_fault_schedule_equals_the_reference(plan, submit_every):
    """The same FaultPlan over the same stub call sequence injects the same
    faults at the same calls in both packages."""
    got = _step_schedule(flt, flt.FaultPlan(**plan), 80, submit_every)
    want = _step_schedule(rflt, rflt.FaultPlan(**plan), 80, submit_every)
    assert got == want
    assert sum(got[2].values()) > 0


def test_chaos_zero_rates_transparent():
    inner = _StubEngine()
    ce = flt.ChaosEngine(inner, flt.FaultPlan(seed=0))
    assert isinstance(ce, rt.Steppable)
    assert rt.supports_recover(ce) and rt.supports_cancel(ce)
    assert ce.slots == 4
    ids = [ce.submit(None) for _ in range(5)]
    out = []
    while ce.in_flight:
        out += ce.step()
    assert [r.id for r in out] == ids
    assert ce.stats()["chaos"] == {"step_error": 0, "hang": 0,
                                   "submit_reject": 0, "corrupt": 0,
                                   "storm": 0}


def test_maybe_chaos_wrap_env_gated(monkeypatch):
    eng = _StubEngine()
    monkeypatch.delenv("REPRO_CHAOS_WRAP", raising=False)
    assert flt.maybe_chaos_wrap(eng) is eng
    monkeypatch.setenv("REPRO_CHAOS_WRAP", "1")
    wrapped = flt.maybe_chaos_wrap(eng)
    assert isinstance(wrapped, flt.ChaosEngine) and wrapped.inner is eng
    assert wrapped.plan == flt.FaultPlan(seed=0)
    assert flt.maybe_chaos_wrap(wrapped) is wrapped


# ---------------------------------------------------------------------------
# Supervision control flow on stubs: quarantine, budget, isolation
# ---------------------------------------------------------------------------

def test_quarantine_recovers_and_other_engines_keep_serving():
    r = rt.Runtime(failure=rt.FailurePolicy(backoff_initial_s=0.01))
    flaky, healthy = _StubEngine(fail_on=(2,)), _StubEngine()
    r.register("flaky", flaky)
    r.register("ok", healthy)
    with r:
        gids = [r.submit("flaky", None) for _ in range(5)]
        hids = [r.submit("ok", None) for _ in range(5)]
        for g in gids + hids:
            r.result(g, timeout=30)
    st = r.stats()
    assert st["flaky"]["supervision"]["state"] == "serving"
    assert st["flaky"]["supervision"]["restarts"] == 1
    assert st["flaky"]["telemetry"]["faults"] == 1
    assert st["flaky"]["telemetry"]["recoveries"] == 1
    assert flaky.recoveries_total == 1
    assert st["ok"]["supervision"]["restarts"] == 0
    tags = [tag for _, tag in st["flaky"]["supervision"]["events"]]
    assert any(t.startswith("fault") for t in tags)
    assert any(t.startswith("quarantined") for t in tags)
    assert any(t.startswith("recovered") for t in tags)


def test_unrecoverable_engine_dies_others_serve():
    r = rt.Runtime()
    r.register("dies", _StubEngine(fail_on=(1,), recoverable=False))
    r.register("ok", _StubEngine())
    with r:
        g1 = r.submit("dies", None)
        g2 = r.submit("ok", None)
        with pytest.raises(flt.EngineDeadError) as ei:
            r.result(g1, timeout=30)
        assert ei.value.engine == "dies" and ei.value.kind == "dead"
        assert r.result(g2, timeout=30).result == 0
        with pytest.raises(flt.EngineDeadError):
            r.submit("dies", None)
    assert r.stats()["dies"]["supervision"]["state"] == "dead"


def test_restart_budget_exhaustion_kills():
    r = rt.Runtime(failure=rt.FailurePolicy(max_restarts=2,
                                            backoff_initial_s=0.005))
    r.register("flappy", _StubEngine(fail_on=set(range(1, 40))))
    with r:
        g = r.submit("flappy", None)
        with pytest.raises(flt.EngineDeadError):
            r.result(g, timeout=30)
    st = r.stats()["flappy"]["supervision"]
    assert st["state"] == "dead" and st["restarts"] == 2


def test_deadline_expires_and_sheds_are_structured():
    r = rt.Runtime(max_pending=2)
    stuck = _StubEngine(step_sleep=0.01)
    stuck.step = lambda: (time.sleep(0.01), [])[1]  # never retires
    r.register("s", stuck)
    shed = 0
    with r:
        gids = []
        for _ in range(50):
            try:
                gids.append(r.submit("s", None, deadline_s=0.2))
            except flt.ShedError as e:
                assert e.kind == "shed" and e.engine == "s"
                shed += 1
        out = r.drain(timeout=30, return_exceptions=True)
    assert shed > 0 and len(out) == len(gids)
    assert all(isinstance(o, flt.DeadlineExceededError) for o in out)
    t = r.telemetry["s"]
    assert t.shed == shed and t.deadline_misses == len(gids)
    assert t.submitted == t.arrivals.observed == len(gids)


def test_watchdog_takeover_isolates_wedged_engine():
    r = rt.Runtime(watchdog_s=0.2)
    wedge, ok = _StubEngine(), _StubEngine()
    wedge.step = lambda: time.sleep(60)
    r.register("wedge", wedge)
    r.register("ok", ok)
    r.start()
    try:
        gw = r.submit("wedge", None)
        with pytest.raises(flt.WedgedError) as ei:
            r.result(gw, timeout=30)
        assert ei.value.engine == "wedge"
        go = r.submit("ok", None)  # the REPLACEMENT stepper serves this
        assert r.result(go, timeout=30).result == 0
        assert r.stats()["wedge"]["supervision"]["state"] == "dead"
    finally:
        r.stop(timeout=5)


def test_stop_detects_wedged_join():
    r = rt.Runtime(watchdog_s=None)
    wedge = _StubEngine()
    wedge.step = lambda: time.sleep(1.0)
    r.register("w", wedge)
    r.start()
    g = r.submit("w", None)
    time.sleep(0.1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        r.stop(timeout=0.1)
    assert any("could not join" in str(w.message) for w in caught)
    with pytest.raises(flt.WedgedError):
        r.result(g, timeout=5)
    with pytest.raises(RuntimeError, match="wedged"):
        r.start()
    deadline = time.monotonic() + 30
    while r._thread.is_alive() and time.monotonic() < deadline:
        time.sleep(0.05)
    wedge.step = lambda: []
    r.start()
    r.stop()


# ---------------------------------------------------------------------------
# Port engines' recovery seams: replay bit-equality, cancel, health checks
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


def _assert_bit_equal_solo(req, q, key, spec):
    solo = fz._factorize_batched(q[None], spec.codebooks, key[None], spec.cfg,
                                 spec.valid_mask)
    assert int(req.iterations[0]) == int(solo.iterations[0])
    np.testing.assert_array_equal(req.factorization.indices[0],
                                  solo.indices[0].numpy())
    np.testing.assert_array_equal(req.factorization.converged[0],
                                  solo.converged[0].numpy())
    np.testing.assert_allclose(req.factorization.reconstruction_sim[0],
                               float(solo.reconstruction_sim[0]), rtol=1e-6)


def _poison(eng, row):
    """Silent corruption as the chaos harness injects it: a NaN row in a
    clone of the state (a functional update)."""
    est = eng.state.est.clone()
    est[row] = float("nan")
    eng.state = eng.state._replace(est=est)


def test_engine_recover_replays_bit_equal(lvrf_setup):
    """recover() mid-flight, from NaN-corrupted state, replays every live
    row from its pinned key: results identical to a solo run.  Junk queries
    hold the slots mid-trajectory when the fault lands."""
    spec, cfg, atoms = lvrf_setup
    _, good, junk = _lvrf_queries(cfg, atoms, n_good=2, n_junk=2, seed=21)
    qs = list(junk) + list(good)
    keys = fz.draw_keys(7, 4)
    eng = engine.Engine(spec, slots=2, sweeps_per_step=2, device="cpu")
    ids = [eng.submit(qs[i], keys=keys[i][None]) for i in range(4)]
    eng.step()
    inflight_before = eng.in_flight
    _poison(eng, 0)
    assert eng.health_check() is not None
    replayed = eng.recover()
    assert replayed == 2 and eng.recoveries_total == 1
    assert eng.in_flight == inflight_before
    assert eng.health_check() is None
    done = {r.id: r for r in eng.drain()}
    for i in range(4):
        _assert_bit_equal_solo(done[ids[i]], qs[i], keys[i], spec)


def test_chaos_corruption_replays_to_the_fault_free_decodes(lvrf_setup,
                                                           monkeypatch):
    """The chaos harness's NaN poke into a port Engine's live state, caught
    by the runtime's health check and replayed: every decode bitwise equal
    to a fault-free run of the same rows and keys, and the state the poke
    replaced was not written in place."""
    spec, cfg, atoms = lvrf_setup
    _, good, junk = _lvrf_queries(cfg, atoms, n_good=4, n_junk=2, seed=27)
    qs = list(junk) + list(good)
    keys = fz.draw_keys(8, 6)

    def run(plan):
        inner = engine.Engine(spec, slots=2, sweeps_per_step=2, device="cpu")
        chaos = flt.ChaosEngine(inner, plan)
        r = rt.Runtime(failure=FAST_FAILURE)
        r.register("lvrf", chaos)
        with r:
            gids = [r.submit("lvrf", qs[i], keys=keys[i][None])
                    for i in range(6)]
            out = [r.result(g, timeout=RESULT_TIMEOUT_S) for g in gids]
        return out, chaos, r

    seen = []
    orig = flt.ChaosEngine._corrupt_state

    def spy(self):
        before = self.inner.state.est
        ok = orig(self)
        if ok:
            seen.append(bool(torch.isfinite(before).all())
                        and not bool(torch.isfinite(self.inner.state.est)
                                     .all()))
        return ok

    monkeypatch.setattr(flt.ChaosEngine, "_corrupt_state", spy)
    got, chaos, r = run(flt.FaultPlan(seed=5, corrupt_rate=1.0,
                                      max_faults=2))
    want, _, _ = run(flt.FaultPlan(seed=5))
    assert chaos.injected["corrupt"] == 2 and seen == [True, True]
    t = r.telemetry["lvrf"]
    assert t.faults >= 1 and t.recoveries >= 1 and t.replayed >= 1
    tags = [tag for _, tag in r.stats()["lvrf"]["supervision"]["events"]]
    assert "fault fault" in tags  # the health check's structured fault
    for a, b in zip(got, want):
        fa, fb = a.factorization, b.factorization
        for name in ("indices", "iterations", "converged", "scores"):
            np.testing.assert_array_equal(getattr(fa, name),
                                          getattr(fb, name))
    for i in range(6):
        _assert_bit_equal_solo(got[i], qs[i], keys[i], spec)


def test_engine_cancel_reclaims_slots_and_queue(lvrf_setup):
    spec, cfg, atoms = lvrf_setup
    vals, good, junk = _lvrf_queries(cfg, atoms, n_good=1, n_junk=3, seed=22)
    eng = engine.Engine(spec, slots=2, sweeps_per_step=2, device="cpu")
    jids = [eng.submit(junk[i]) for i in range(3)]
    eng.step()
    assert eng.cancel(jids[0]) and eng.cancel(jids[2])
    assert not eng.cancel(999)
    assert eng.in_flight == 1
    gid = eng.submit(good[0])
    done = {r.id: r for r in eng.drain()}
    assert set(done) == {jids[1], gid}
    assert done[gid].result["values"][0].tolist() == vals[0].tolist()


def test_engine_health_check_flags_only_live_rows(lvrf_setup):
    spec, cfg, atoms = lvrf_setup
    _, _, junk = _lvrf_queries(cfg, atoms, n_good=0, n_junk=2, seed=23)
    eng = engine.Engine(spec, slots=2, sweeps_per_step=1, device="cpu")
    assert eng.health_check() is None
    eng.submit(junk[0])
    eng.step()
    assert eng.health_check() is None
    _poison(eng, 0)
    msg = eng.health_check()
    assert msg is not None and "non-finite" in msg


@pytest.fixture(scope="module")
def lm_smoke():
    cfg = registry.get("llama3.2-3b").smoke()
    return cfg, T.init(cfg, 0, "cpu")


def _prompts(cfg, n):
    return [np.random.default_rng(i).integers(0, cfg.vocab, 4 + i)
            for i in range(n)]


def _solo_tokens(cfg, model, prompt, n):
    ref = ServeEngine(cfg, model, 1, 32, device="cpu")
    ref.add_request(0, prompt)
    for _ in range(n):
        ref.step()
    return ref.generated[0][1:n + 1]


def test_lm_engine_recover_replays_bit_equal(lm_smoke):
    cfg, model = lm_smoke
    prompts = _prompts(cfg, 2)
    eng = rt.LMEngine(cfg, model, slots=2, max_len=32, device="cpu")
    ids = [eng.submit(p, max_new_tokens=5) for p in prompts]
    eng.step()
    assert eng.recover() == 2 and eng.recoveries_total == 1
    done = {r.id: r for r in eng.drain()}
    for p, rid in zip(prompts, ids):
        assert done[rid].result["tokens"] == _solo_tokens(cfg, model, p, 5)


def test_engine_preempt_replays_bit_equal(lvrf_setup):
    spec, cfg, atoms = lvrf_setup
    _, good, junk = _lvrf_queries(cfg, atoms, n_good=2, n_junk=2, seed=21)
    keys = fz.draw_keys(13, 4)
    eng = engine.Engine(spec, slots=2, sweeps_per_step=2, device="cpu")
    jids = [eng.submit(junk[i], keys=keys[i][None], priority=2)
            for i in range(2)]
    eng.step()
    assert set(eng.live_requests()) == set(jids)
    gids = [eng.submit(good[i], keys=keys[2 + i][None], priority=0)
            for i in range(2)]
    inflight_before = eng.in_flight
    assert eng.preempt(jids[0]) == 1
    assert eng.preempt(999) == 0
    assert eng.in_flight == inflight_before
    assert jids[0] in eng.queued_requests()
    done = {r.id: r for r in eng.drain()}
    qs = list(junk) + list(good)
    for i, rid in enumerate(jids + gids):
        _assert_bit_equal_solo(done[rid], qs[i], keys[i], spec)


def test_lm_engine_preempt_replays_bit_equal(lm_smoke):
    cfg, model = lm_smoke
    prompts = _prompts(cfg, 2)
    eng = rt.LMEngine(cfg, model, slots=2, max_len=32, device="cpu")
    ids = [eng.submit(p, max_new_tokens=5, priority=i)
           for i, p in enumerate(prompts)]
    eng.step()
    assert eng.preempt(ids[1]) == 1
    assert eng.preempt(999) == 0
    done = {r.id: r for r in eng.drain()}
    for p, rid in zip(prompts, ids):
        assert done[rid].result["tokens"] == _solo_tokens(cfg, model, p, 5)


class _FailOnStep:
    """Minimal deterministic fault wrapper (independent of ChaosEngine)."""

    def __init__(self, inner, fail_steps):
        self.inner, self.fail_steps, self.steps = inner, set(fail_steps), 0

    def step(self):
        self.steps += 1
        if self.steps in self.fail_steps:
            raise flt.InjectedFault("scripted step fault")
        return self.inner.step()

    def __getattr__(self, name):
        return getattr(self.inner, name)


def test_runtime_quarantine_replay_bit_equal(lvrf_setup):
    spec, cfg, atoms = lvrf_setup
    _, good, junk = _lvrf_queries(cfg, atoms, n_good=4, n_junk=2, seed=24)
    keys = fz.draw_keys(11, 6)
    inner = engine.Engine(spec, slots=4, sweeps_per_step=2, device="cpu")
    r = rt.Runtime(failure=FAST_FAILURE)
    r.register("lvrf", _FailOnStep(inner, fail_steps=(3,)))
    with r:
        gids = [r.submit("lvrf", good[i], keys=keys[i][None])
                for i in range(4)]
        jids = [r.submit("lvrf", junk[j], keys=keys[4 + j][None])
                for j in range(2)]
        reqs = [r.result(g, timeout=RESULT_TIMEOUT_S) for g in gids]
        jreqs = [r.result(g, timeout=RESULT_TIMEOUT_S) for g in jids]
    t = r.telemetry["lvrf"]
    assert t.faults == 1 and t.recoveries == 1 and t.replayed >= 1
    assert inner.recoveries_total == 1
    for i in range(4):
        _assert_bit_equal_solo(reqs[i], good[i], keys[i], spec)
    for j in range(2):
        _assert_bit_equal_solo(jreqs[j], junk[j], keys[4 + j], spec)


def test_runtime_deadline_zero_expires_and_engine_keeps_serving(lvrf_setup):
    spec, cfg, atoms = lvrf_setup
    vals, good, junk = _lvrf_queries(cfg, atoms, n_good=1, n_junk=1, seed=25)
    r = rt.Runtime()
    r.register("lvrf", engine.Engine(spec, slots=2, sweeps_per_step=2,
                                     device="cpu"))
    with r:
        doomed = r.submit("lvrf", junk[0], deadline_s=0.0)
        ok = r.submit("lvrf", good[0])
        with pytest.raises(flt.DeadlineExceededError):
            r.result(doomed, timeout=RESULT_TIMEOUT_S)
        req = r.result(ok, timeout=RESULT_TIMEOUT_S)
        left = r.drain(timeout=RESULT_TIMEOUT_S, return_exceptions=True)
        assert all(isinstance(o, flt.DeadlineExceededError) for o in left)
    assert req.result["values"][0].tolist() == vals[0].tolist()
    assert r.telemetry["lvrf"].deadline_misses == 1


# ---------------------------------------------------------------------------
# The headline chaos run: seeded faults over mixed nvsa + lvrf + lm traffic
# ---------------------------------------------------------------------------

def test_chaos_mixed_traffic_every_future_resolves(lvrf_setup, lm_smoke):
    """The reference test's plans (LVRF seed 101: step errors + NaN state
    corruption; NVSA seed 202; LM seed 303 with submit rejections) over
    concurrent traffic: every future resolves to a result or a structured
    FaultError, the engines stay serving, and the survivors equal fault-free
    solo runs (LVRF bitwise, NVSA to the unitary contract, LM tokens)."""
    spec_l, cfg_l, atoms = lvrf_setup
    cfg_n = nvsa.NVSAConfig()
    spec_n = engine.registry.build("nvsa_abduction", 0, cfg=cfg_n,
                                   device="cpu")
    cfg_lm, model = lm_smoke

    rng = np.random.default_rng(0)
    attrs = torch.from_numpy(rng.integers(0, (5, 6, 10), (8, 3)))
    ctx = nvsa.target_query(spec_n.codebooks, attrs, cfg_n)
    nkeys = fz.draw_keys(5, 8)
    vals, good, junk = _lvrf_queries(cfg_l, atoms, n_good=6, n_junk=3, seed=9)
    lkeys = fz.draw_keys(6, 9)
    prompts = _prompts(cfg_lm, 4)

    lvrf_chaos = flt.ChaosEngine(
        engine.Engine(spec_l, slots=4, sweeps_per_step=2, device="cpu"),
        flt.FaultPlan(seed=101, step_error_rate=0.12, corrupt_rate=0.08,
                      max_faults=3))
    nvsa_chaos = flt.ChaosEngine(
        engine.Engine(spec_n, slots=4, device="cpu"),
        flt.FaultPlan(seed=202, step_error_rate=0.15, max_faults=2))
    lm_chaos = flt.ChaosEngine(
        rt.LMEngine(cfg_lm, model, slots=2, max_len=32, device="cpu"),
        flt.FaultPlan(seed=303, step_error_rate=0.1, submit_reject_rate=0.3,
                      max_faults=3))

    r = rt.Runtime(failure=FAST_FAILURE)
    r.register("nvsa", nvsa_chaos)
    r.register("lvrf", lvrf_chaos)
    r.register("lm", lm_chaos)
    with r:
        g_n = r.submit("nvsa", ctx, keys=nkeys)
        g_l = [r.submit("lvrf", good[i], keys=lkeys[i][None])
               for i in range(6)]
        g_junk = [r.submit("lvrf", junk[j], keys=lkeys[6 + j][None])
                  for j in range(3)]
        g_dead = r.submit("lvrf", junk[0], deadline_s=0.0)
        g_t = [r.submit("lm", p, max_new_tokens=5) for p in prompts]
        gids = [g_n] + g_l + g_junk + [g_dead] + g_t
        out = r.drain(timeout=RESULT_TIMEOUT_S, return_exceptions=True)

    assert len(out) == len(gids)
    by_gid = dict(zip(sorted(gids), out))
    for gid, o in by_gid.items():
        if isinstance(o, Exception):
            assert isinstance(o, flt.FaultError), (gid, o)
    assert isinstance(by_gid[g_dead], flt.DeadlineExceededError)
    st = r.stats()
    assert all(st[n]["supervision"]["state"] == "serving"
               for n in ("nvsa", "lvrf", "lm"))
    injected = sum(sum(e.injected.values())
                   for e in (lvrf_chaos, nvsa_chaos, lm_chaos))
    assert injected > 0
    assert sum(st[n]["telemetry"]["recoveries"]
               for n in ("nvsa", "lvrf", "lm")) > 0

    req_n = by_gid[g_n]
    assert not isinstance(req_n, Exception)
    solo = fz._factorize_batched(ctx, spec_n.codebooks, nkeys, spec_n.cfg,
                                 spec_n.valid_mask)
    np.testing.assert_array_equal(req_n.factorization.indices,
                                  solo.indices.numpy())
    np.testing.assert_array_equal(req_n.factorization.converged,
                                  solo.converged.numpy())
    fast = solo.iterations.numpy() <= FAST
    np.testing.assert_array_equal(req_n.iterations[fast],
                                  solo.iterations.numpy()[fast])
    for i, g in enumerate(g_l):
        req = by_gid[g]
        assert not isinstance(req, Exception)
        _assert_bit_equal_solo(req, good[i], lkeys[i], spec_l)
        assert req.result["values"][0].tolist() == vals[i].tolist()
    for j, g in enumerate(g_junk):
        req = by_gid[g]
        assert not isinstance(req, Exception)
        _assert_bit_equal_solo(req, junk[j], lkeys[6 + j], spec_l)
    lm_rejects = 0
    for p, g in zip(prompts, g_t):
        o = by_gid[g]
        if isinstance(o, flt.InjectedFault):
            lm_rejects += 1
            continue
        assert o.result["tokens"] == _solo_tokens(cfg_lm, model, p, 5)
    assert lm_rejects == lm_chaos.injected["submit_reject"]

