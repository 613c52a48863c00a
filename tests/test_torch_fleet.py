"""The port's fleet controller (``repro_torch.runtime.fleet``) and its
runtime integration: the ports of ``tests/test_fleet.py``'s tests, plus
parity with the reference's controller.

The controller's decisions are host arithmetic over injected callables, so
the unit half runs on fake engines, deterministic and thread-free, and the
same fakes fed to the reference's ``FleetController`` must give equal
admission decisions, preemption victims, brownout transitions and rebalance
moves.  The integration half drives the threaded port ``Runtime`` over the
port's LVRF ``Engine`` on the CPU: structured sheds in the SLO tracker's
shed column, degraded admissions as ``DegradedResult`` markers, and the
mixed-priority overload where interactive attainment holds >= 0.9 under
the policy and drops below it without one.

Every blocking wait carries a timeout.
"""
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro import runtime as rrt
from repro_torch import engine, obs
from repro_torch import runtime as rt
from repro_torch.core import factorizer as fz
from repro_torch.device import disable_tf32, generator
from repro_torch.models import lvrf

RESULT_TIMEOUT_S = 300.0

FAST_FAILURE = rt.FailurePolicy(max_restarts=3, backoff_initial_s=0.01,
                                backoff_max_s=0.05, health_check_every=2)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Fake engine: injectable slots/backlog/priorities, no tensors
# ---------------------------------------------------------------------------

class _FakeEngine:
    """Steppable-shaped stand-in exposing exactly the seams the controller
    reads: slots, units-per-step, live/queued priority views, preempt, and
    resize (scriptable to fail, for the rollback test)."""

    engine_kind = "factorizer"

    def __init__(self, slots=4, units=2, max_iters=40):
        self.slots = slots
        self.sweeps_per_step = units
        self.in_flight = 0
        self.spec = SimpleNamespace(cfg=SimpleNamespace(max_iters=max_iters))
        self.live: dict = {}
        self.queued: dict = {}
        self.preempts: list = []
        self.resizes: list = []
        self.fail_resize = False

    def submit(self, payload, **kw):
        return 0

    def step(self):
        return []

    def drain(self):
        return []

    def stats(self):
        return {"slots": self.slots}

    def live_requests(self):
        return dict(self.live)

    def queued_requests(self):
        return dict(self.queued)

    def preempt(self, rid):
        self.preempts.append(rid)
        info = self.live.pop(rid, None)
        return 0 if info is None else info["rows"]

    def resize(self, n):
        if self.fail_resize:
            raise RuntimeError("scripted resize failure")
        self.resizes.append(n)
        self.slots = n


def _bound(policy, engines, backlog, unit_s=0.05, **kw):
    """Controller over fakes with an injected mutable backlog dict."""
    ctrl = rt.FleetController(policy)
    return ctrl.bind(engines, unit_s_fn=lambda n: unit_s,
                     backlog_fn=lambda n: backlog.get(n, 0), **kw)


TWO_CLASS = rt.FleetPolicy(
    classes=(
        rt.PriorityClass("gold", priority=0),
        rt.PriorityClass("be", priority=5, admit_wait_s=1.0,
                         degrade_wait_s=0.5, preemptible=True,
                         degradable=True),
    ),
    default_class="be", rebalance_every=0)


# ---------------------------------------------------------------------------
# Policy validation
# ---------------------------------------------------------------------------

def test_policy_validates():
    with pytest.raises(ValueError):
        rt.PriorityClass("x", admit_wait_s=-1.0)
    with pytest.raises(ValueError):
        rt.BrownoutPolicy(enter_wait_s=0.0)
    with pytest.raises(ValueError):
        rt.BrownoutPolicy(enter_wait_s=1.0, exit_wait_s=2.0)  # hysteresis
    with pytest.raises(ValueError):
        rt.BrownoutPolicy(enter_wait_s=1.0, max_iters_factor=0.0)
    with pytest.raises(ValueError):  # duplicate class names
        rt.FleetPolicy(classes=(rt.PriorityClass("a"), rt.PriorityClass("a")))
    with pytest.raises(ValueError):  # default must be declared
        rt.FleetPolicy(classes=(rt.PriorityClass("a"),), default_class="b")
    with pytest.raises(ValueError):
        rt.FleetPolicy(rebalance_ratio=0.5)


# ---------------------------------------------------------------------------
# Admission: est-wait math, class thresholds, trims, counters
# ---------------------------------------------------------------------------

def test_est_wait_prices_backlog_over_slots():
    eng = _FakeEngine(slots=4, units=2)
    backlog = {"e": 0}
    ctrl = _bound(TWO_CLASS, {"e": eng}, backlog, unit_s=0.05)
    assert ctrl.est_wait_s("e") == 0.0
    backlog["e"] = 8  # 0.05 s/unit x 2 units/step x 8 rows / 4 slots
    assert ctrl.est_wait_s("e") == pytest.approx(0.2)
    assert ctrl.est_wait_s("missing") == 0.0


def test_admission_thresholds_and_counters():
    eng = _FakeEngine(slots=4, units=2)
    backlog = {"e": 10}  # wait 0.25: under both thresholds
    ctrl = _bound(TWO_CLASS, {"e": eng}, backlog)
    assert ctrl.admit("e", "be").action == "admit"
    backlog["e"] = 30  # wait 0.75: degrade band
    d = ctrl.admit("e", "be")
    assert d.action == "degrade" and d.mode == "overload"
    assert d.trims == {"max_iters": 10}  # 0.25 x the engine's 40
    backlog["e"] = 50  # wait 1.25: shed band
    s = ctrl.admit("e", "be")
    assert s.action == "shed" and "admit_wait_s" in s.reason
    # gold has no thresholds: never shed, never degraded, priority 0
    g = ctrl.admit("e", "gold")
    assert g.action == "admit" and g.priority == 0
    assert ctrl.admitted == {"be": 1, "gold": 1}
    assert ctrl.degraded == {"be": 1} and ctrl.shed == {"be": 1}
    snap = ctrl.snapshot()
    assert snap["shed"] == {"be": 1} and snap["mode"] == "normal"


def test_admission_default_class_and_priority_override():
    ctrl = _bound(TWO_CLASS, {"e": _FakeEngine()}, {})
    d = ctrl.admit("e", "unheard_of")  # falls back to default_class "be"
    assert d.action == "admit" and d.priority == 5
    assert ctrl.admit("e", "gold", priority=9).priority == 9  # override


def test_decision_apply_never_loosens_caller_budget():
    d = rt.AdmissionDecision("degrade", "be", 5, 0.7,
                             trims={"max_iters": 10})
    assert d.apply({}) == {"max_iters": 10}
    assert d.apply({"max_iters": 30}) == {"max_iters": 10}
    assert d.apply({"max_iters": 4}) == {"max_iters": 4}  # tighter wins


def test_lm_trims_cap_tokens():
    eng = _FakeEngine()
    eng.engine_kind = "lm"
    backlog = {"lm": 30}
    ctrl = _bound(TWO_CLASS, {"lm": eng}, backlog)
    d = ctrl.admit("lm", "be")
    assert d.action == "degrade" and d.trims == {"max_new_tokens": 8}


# ---------------------------------------------------------------------------
# Preemption: victim choice, need-sized budget, thrash-freedom
# ---------------------------------------------------------------------------

def test_preempt_clears_worst_priority_newest_first():
    eng = _FakeEngine(slots=3)
    eng.live = {1: {"priority": 5, "rows": 1}, 2: {"priority": 5, "rows": 1},
                3: {"priority": 0, "rows": 1}}  # gold row: never a victim
    eng.queued = {10: {"priority": 0, "rows": 2}}
    ctrl = _bound(TWO_CLASS, {"e": eng}, {},
                  class_of=lambda n, rid: "gold" if rid == 3 else "be")
    ctrl.control(now=0.0)
    # need = 2 queued gold rows - 0 free; victims among prio-5, newest first
    assert eng.preempts == [2, 1]
    assert ctrl.preempted == {"be": 2}
    # thrash-freedom: nothing preemptible left; a second tick is a no-op
    ctrl.control(now=1.0)
    assert eng.preempts == [2, 1]


def test_preempt_budget_stops_at_need():
    eng = _FakeEngine(slots=8)
    eng.live = {i: {"priority": 5, "rows": 1} for i in range(4)}
    eng.queued = {10: {"priority": 0, "rows": 1}}
    ctrl = _bound(TWO_CLASS, {"e": eng}, {},
                  class_of=lambda n, rid: "be")
    ctrl.control(now=0.0)
    # 8 slots, 4 live -> 4 free >= 1 queued row: nothing needs preempting
    assert eng.preempts == []
    eng.live = {i: {"priority": 5, "rows": 1} for i in range(8)}
    ctrl.control(now=1.0)
    assert len(eng.preempts) == 1  # exactly the one row the queue needs


def test_preempt_respects_non_preemptible_class():
    eng = _FakeEngine(slots=1)
    eng.live = {1: {"priority": 5, "rows": 1}}
    eng.queued = {2: {"priority": 0, "rows": 1}}
    ctrl = _bound(TWO_CLASS, {"e": eng}, {},
                  class_of=lambda n, rid: "gold")  # gold is not preemptible
    ctrl.control(now=0.0)
    assert eng.preempts == []


# ---------------------------------------------------------------------------
# Brownout state machine
# ---------------------------------------------------------------------------

def test_brownout_debounced_entry_exit_and_degrade_mode():
    pol = rt.FleetPolicy(
        classes=TWO_CLASS.classes, default_class="be", rebalance_every=0,
        brownout=rt.BrownoutPolicy(enter_wait_s=0.2, exit_wait_s=0.1,
                                   enter_ticks=2, exit_ticks=2,
                                   max_iters_factor=0.5, lm_token_cap=3))
    eng = _FakeEngine(slots=4, units=2)
    backlog = {"e": 10}  # wait 0.25 > enter threshold
    ctrl = _bound(pol, {"e": eng}, backlog)
    ctrl.control(now=0.0)
    assert ctrl.mode == "normal"  # one hot tick is not sustained overload
    ctrl.control(now=1.0)
    assert ctrl.mode == "brownout" and ctrl.brownouts == 1
    # while browned out every degradable admission is trimmed, even at a
    # wait below its own degrade threshold
    backlog["e"] = 1
    d = ctrl.admit("e", "be")
    assert d.action == "degrade" and d.mode == "brownout"
    assert d.trims == {"max_iters": 20}  # 0.5 x 40
    assert ctrl.admit("e", "gold").action == "admit"  # gold untouched
    ctrl.control(now=2.0)  # wait now 0.025 < exit threshold: cooling
    assert ctrl.mode == "brownout"
    ctrl.control(now=3.0)
    assert ctrl.mode == "normal" and ctrl.brownouts == 1


# ---------------------------------------------------------------------------
# Global slot budget
# ---------------------------------------------------------------------------

def test_rebalance_moves_slot_and_conserves_total():
    pol = rt.FleetPolicy(classes=TWO_CLASS.classes, default_class="be",
                         rebalance_every=1, rebalance_ratio=2.0,
                         min_slots=1, preempt=False)
    a, b = _FakeEngine(slots=4), _FakeEngine(slots=4)
    backlog = {"a": 0, "b": 40}
    ctrl = _bound(pol, {"a": a, "b": b}, backlog)
    ctrl.control(now=0.0)
    assert ctrl.rebalances == 1
    assert (a.slots, b.slots) == (3, 5)  # total conserved
    assert ctrl.slot_moves == {"a": -1, "b": 1}


def test_rebalance_rolls_back_when_receiver_fails():
    pol = rt.FleetPolicy(classes=TWO_CLASS.classes, default_class="be",
                         rebalance_every=1, preempt=False)
    a, b = _FakeEngine(slots=4), _FakeEngine(slots=4)
    b.fail_resize = True
    ctrl = _bound(pol, {"a": a, "b": b}, {"a": 0, "b": 40})
    ctrl.control(now=0.0)
    assert ctrl.rebalances == 0
    assert (a.slots, b.slots) == (4, 4)  # donor refunded: total conserved
    assert a.resizes == [3, 4]


def test_rebalance_donor_floor_blocks_move():
    pol = rt.FleetPolicy(classes=TWO_CLASS.classes, default_class="be",
                         rebalance_every=1, min_slots=4, preempt=False)
    a, b = _FakeEngine(slots=4), _FakeEngine(slots=4)
    ctrl = _bound(pol, {"a": a, "b": b}, {"a": 0, "b": 40})
    ctrl.control(now=0.0)
    assert ctrl.rebalances == 0 and (a.slots, b.slots) == (4, 4)


def test_rebalance_attainment_floor_steers_receiver():
    pol = rt.FleetPolicy(classes=TWO_CLASS.classes, default_class="be",
                         rebalance_every=1, attainment_floor=0.9,
                         preempt=False)
    a, b = _FakeEngine(slots=4), _FakeEngine(slots=4)
    ctrl = _bound(pol, {"a": a, "b": b}, {"a": 0, "b": 0},
                  slo_fn=lambda: {"gold": {"attainment": 0.5}})
    ctrl.admit("a", "gold")  # binds class gold -> engine a
    ctrl.control(now=0.0)
    # raw pressure is flat, but gold is missing its SLO on engine a:
    # a is forced to the front of the receiver line
    assert (a.slots, b.slots) == (5, 3)


# ---------------------------------------------------------------------------
# Submit-storm chaos mode feeds the admission signal
# ---------------------------------------------------------------------------

def test_fault_plan_storm_validates():
    with pytest.raises(ValueError):
        rt.FaultPlan(storm_rate=0.5)  # burst required
    with pytest.raises(ValueError):
        rt.FaultPlan(storm_rate=1.5, storm_burst=2)


class _StormStub:
    """Counts submissions; backlog == everything ever submitted."""

    engine_kind = "factorizer"
    slots = 2
    sweeps_per_step = 2

    def __init__(self):
        self.submits = 0

    def submit(self, payload, **kw):
        self.submits += 1
        return self.submits

    def step(self):
        return []

    @property
    def in_flight(self):
        return self.submits


def test_submit_storm_inflates_backlog_and_sheds():
    eng = _StormStub()
    chaos = rt.ChaosEngine(eng, rt.FaultPlan(seed=3, storm_rate=1.0,
                                             storm_burst=3))
    ctrl = rt.FleetController(rt.FleetPolicy(classes=(
        rt.PriorityClass("be", priority=1, admit_wait_s=0.0),),
        default_class="be", rebalance_every=0))
    ctrl.bind({"e": chaos}, unit_s_fn=lambda n: 0.05)  # backlog: in_flight
    assert ctrl.admit("e", "be").action == "admit"  # idle: nothing queued
    chaos.submit(None)  # one caller submit fans into 1 + 3 phantoms
    assert chaos.injected["storm"] == 1 and eng.submits == 4
    assert ctrl.admit("e", "be").action == "shed"  # phantoms price the wait


# ---------------------------------------------------------------------------
# Parity: the same fakes through both packages' controllers
# ---------------------------------------------------------------------------

def _fleet_trace(pkg, seed: int) -> list:
    """A seeded script of admissions and control ticks over two fakes with
    moving backlogs and live/queued priority views; returns every decision
    the controller made, in order."""
    rng = np.random.default_rng(seed)
    pol = pkg.FleetPolicy(
        classes=(pkg.PriorityClass("gold", priority=0),
                 pkg.PriorityClass("be", priority=5, admit_wait_s=1.0,
                                   degrade_wait_s=0.5, preemptible=True,
                                   degradable=True)),
        default_class="be", rebalance_every=2, rebalance_ratio=2.0,
        min_slots=1, max_preempt_per_tick=3, attainment_floor=0.9,
        brownout=pkg.BrownoutPolicy(enter_wait_s=0.2, exit_wait_s=0.1,
                                    enter_ticks=2, exit_ticks=2,
                                    max_iters_factor=0.5, lm_token_cap=3))
    a, b = _FakeEngine(slots=4, units=2), _FakeEngine(slots=6, units=1)
    b.engine_kind = "lm"
    engines, backlog = {"a": a, "b": b}, {"a": 0, "b": 0}
    gold = {}
    ctrl = pkg.FleetController(pol).bind(
        engines, unit_s_fn=lambda n: 0.05 if n == "a" else 0.02,
        backlog_fn=lambda n: backlog[n],
        class_of=lambda n, rid: gold.get((n, rid), "be"),
        slo_fn=lambda: {"gold": {"attainment": float(rng.random())}})
    trace = []
    for tick in range(40):
        backlog["a"] = int(rng.integers(0, 60))
        backlog["b"] = int(rng.integers(0, 60))
        for name, eng in engines.items():
            eng.live = {i: {"priority": int(rng.choice([0, 5])), "rows": 1}
                        for i in range(int(rng.integers(0, eng.slots + 1)))}
            eng.queued = {100 + i: {"priority": int(rng.choice([0, 5])),
                                    "rows": int(rng.integers(1, 3))}
                          for i in range(int(rng.integers(0, 4)))}
            for rid in eng.live:
                if rng.random() < 0.2:
                    gold[(name, rid)] = "gold"
        b.fail_resize = bool(rng.random() < 0.1)
        for _ in range(3):
            name = str(rng.choice(["a", "b"]))
            cls = str(rng.choice(["gold", "be", "unknown"]))
            d = ctrl.admit(name, cls, now=float(tick))
            trace.append(("admit", name, d.action, d.class_, d.priority,
                          d.est_wait_s, d.reason, d.mode, dict(d.trims)))
        ctrl.control(now=float(tick))
        trace.append(("tick", ctrl.mode, list(a.preempts), list(b.preempts),
                      a.slots, b.slots, list(a.resizes), list(b.resizes)))
    trace.append(("snapshot", ctrl.snapshot()))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fleet_decisions_equal_the_reference(seed):
    got, want = _fleet_trace(rt, seed), _fleet_trace(rrt, seed)
    assert got == want
    kinds = {t[2] for t in got if t[0] == "admit"}
    assert {"admit", "degrade", "shed"} <= kinds  # every verdict exercised
    snap = got[-1][1]
    assert sum(snap["preempted_rows"].values()) > 0
    assert snap["rebalances"] > 0 and snap["brownouts"] > 0


# ---------------------------------------------------------------------------
# Runtime integration: structured sheds, SLO routing, degraded results
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lvrf_setup():
    disable_tf32()
    cfg = lvrf.LVRFConfig()
    atoms = lvrf.init_atoms(generator(0), cfg, device="cpu")
    spec = engine.registry.build("lvrf_rows", 0, fused_step=True, atoms=atoms,
                                 device="cpu")
    return spec, cfg, atoms


def _queries(cfg, atoms, n_good, n_junk, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, cfg.n_values, (max(n_good, 1), 3))
    good = lvrf.encode_row(atoms, vals, cfg)
    junk = torch.from_numpy(rng.normal(size=(max(n_junk, 1), cfg.vsa.dim))
                            .astype(np.float32))
    return good, junk


def _engine(spec):
    return engine.Engine(spec, slots=2, sweeps_per_step=2, device="cpu")


def test_register_reserves_fleet_name():
    r = rt.Runtime()
    with pytest.raises(ValueError):
        r.register("fleet", _FakeEngine())


def test_runtime_admission_shed_is_structured_and_counted(lvrf_setup):
    spec, cfg, atoms = lvrf_setup
    _, junk = _queries(cfg, atoms, 0, 2, seed=51)
    pol = rt.FleetPolicy(classes=(
        rt.PriorityClass("be", priority=1, admit_wait_s=0.0),),
        default_class="be", rebalance_every=0)
    r = rt.Runtime(fleet=pol)
    r.register("lvrf", _engine(spec))
    with r:
        g0 = r.submit("lvrf", junk[0], class_="be")
        with pytest.raises(rt.ShedError):
            r.submit("lvrf", junk[1], class_="be")
        req = r.result(g0, timeout=RESULT_TIMEOUT_S)
        assert req.result is not None
        snap = r.stats()
    assert snap["slo"]["be"]["shed"] == 1
    assert snap["slo"]["be"]["submitted"] == 1
    assert snap["slo"]["be"]["failed"] == 0
    assert snap["lvrf"]["telemetry"]["shed"] == 1
    assert snap["fleet"]["admitted"] == {"be": 1}
    assert snap["fleet"]["shed"] == {"be": 1}


def test_runtime_degraded_admission_wraps_result(lvrf_setup):
    spec, cfg, atoms = lvrf_setup
    _, junk = _queries(cfg, atoms, 0, 2, seed=52)
    pol = rt.FleetPolicy(classes=(
        rt.PriorityClass("be", priority=1, degrade_wait_s=0.0,
                         degradable=True),),
        default_class="be", rebalance_every=0)
    r = rt.Runtime(fleet=pol)
    r.register("lvrf", _engine(spec))
    with r:
        g0 = r.submit("lvrf", junk[0], class_="be")
        g1 = r.submit("lvrf", junk[1], class_="be")
        req0 = r.result(g0, timeout=RESULT_TIMEOUT_S)
        req1 = r.result(g1, timeout=RESULT_TIMEOUT_S)
        snap = r.stats()
    assert not isinstance(req0.result, rt.DegradedResult)
    assert int(req0.iterations[0]) == spec.cfg.max_iters
    marked = req1.result
    assert isinstance(marked, rt.DegradedResult)
    assert marked.class_ == "be" and marked.mode == "overload"
    assert marked.trims == {"max_iters": 10}
    assert marked.result is not None
    assert int(req1.iterations[0]) <= 10 + 1
    assert snap["lvrf"]["telemetry"]["degraded"] == 1
    assert snap["fleet"]["degraded"] == {"be": 1}


def test_runtime_ingest_rejections_land_in_shed_column(lvrf_setup):
    spec, cfg, atoms = lvrf_setup
    _, junk = _queries(cfg, atoms, 0, 2, seed=53)
    eng = rt.ChaosEngine(_engine(spec),
                         rt.FaultPlan(seed=0, submit_reject_rate=1.0))
    r = rt.Runtime()
    r.register("lvrf", eng)
    with r:
        gids = [r.submit("lvrf", junk[i], class_="be") for i in range(2)]
        for g in gids:
            with pytest.raises(rt.InjectedFault):
                r.result(g, timeout=RESULT_TIMEOUT_S)
        snap = r.stats()
    assert snap["slo"]["be"]["shed"] == 2
    assert snap["slo"]["be"]["submitted"] == 0
    assert snap["slo"]["be"]["failed"] == 0
    assert snap["slo"]["be"]["shed_rate"] == 1.0
    assert snap["lvrf"]["telemetry"]["shed"] == 2


def test_runtime_dead_engine_fast_fail_counts_as_shed():
    class _DoomedStub(_FakeEngine):
        def submit(self, payload, **kw):
            self.in_flight += 1
            return self.in_flight

        def step(self):
            raise ValueError("scripted fault")
    doomed = _DoomedStub()
    doomed.recover = None
    r = rt.Runtime(failure=FAST_FAILURE)
    r.register("bad", doomed)
    with r:
        g = r.submit("bad", None, class_="be")
        with pytest.raises(rt.EngineDeadError):
            r.result(g, timeout=RESULT_TIMEOUT_S)
        deadline = time.monotonic() + RESULT_TIMEOUT_S
        while time.monotonic() < deadline:
            if r.stats()["bad"]["supervision"]["state"] == "dead":
                break
            time.sleep(0.01)
        with pytest.raises(rt.EngineDeadError):
            r.submit("bad", None, class_="be")
        snap = r.stats()
    assert snap["slo"]["be"]["shed"] == 1
    assert snap["slo"]["be"]["failed"] == 1


# ---------------------------------------------------------------------------
# Acceptance: overload with mixed priorities
# ---------------------------------------------------------------------------

N_JUNK, N_GOOD = 24, 10


def _overload_run(spec, good, junk, gkeys, jkeys, fleet, target_s):
    """24 slot-hogging best-effort requests, then, once they hold the
    engine, 10 interactive ones; returns the stats and every result."""
    eng = engine.Engine(spec, slots=4, sweeps_per_step=2, device="cpu")
    w = [eng.submit(junk[i], keys=jkeys[i][None], priority=3)
         for i in range(2)]
    eng.step()
    eng.preempt(w[0])
    eng.submit(good[0], keys=gkeys[0][None], priority=0)
    eng.drain()
    r = rt.Runtime(slo={"interactive": obs.SLOTarget(target_s),
                        "best_effort": obs.SLOTarget(target_s)},
                   fleet=fleet)
    r.register("lvrf", eng)
    with r:
        jids = [r.submit("lvrf", junk[i], keys=jkeys[i][None],
                         class_="best_effort") for i in range(N_JUNK)]
        deadline = time.monotonic() + RESULT_TIMEOUT_S
        while time.monotonic() < deadline:
            live = sum(i["rows"] for i in eng.live_requests().values())
            if live == 4 and eng.in_flight == N_JUNK:
                break
            time.sleep(0.002)
        else:
            pytest.fail("junk never occupied the engine")
        gids = [r.submit("lvrf", good[i], keys=gkeys[i][None],
                         class_="interactive") for i in range(N_GOOD)]
        reqs = [r.result(g, timeout=RESULT_TIMEOUT_S) for g in jids + gids]
        snap = r.stats()
    return snap, reqs


def test_overload_high_priority_attainment_holds(lvrf_setup):
    """Sustained load far past capacity (24 requests x 20 steps on a 4-slot
    engine), interactive minority behind the best-effort bulk: attainment
    >= 0.9 under the fleet policy, below 0.9 without it, every request
    resolved, and the preemptions that paid for it counted."""
    spec, cfg, atoms = lvrf_setup
    good, junk = _queries(cfg, atoms, N_GOOD, N_JUNK, seed=61)
    gkeys, jkeys = fz.draw_keys(3, N_GOOD), fz.draw_keys(4, N_JUNK)
    eng = engine.Engine(spec, slots=4, sweeps_per_step=2, device="cpu")
    eng.submit(junk[0], keys=jkeys[0][None])
    eng.drain()
    t0 = time.perf_counter()
    eng.submit(junk[1], keys=jkeys[1][None])
    steps0 = eng.steps_total
    eng.drain()
    t_step = (time.perf_counter() - t0) / max(1, eng.steps_total - steps0)
    target_s = 30.0 * t_step + 0.008

    pol = rt.FleetPolicy(classes=(
        rt.PriorityClass("interactive", priority=0),
        rt.PriorityClass("best_effort", priority=3, preemptible=True),),
        default_class="best_effort", max_preempt_per_tick=4,
        rebalance_every=0)
    snap_p, reqs_p = _overload_run(spec, good, junk, gkeys, jkeys, pol,
                                   target_s)
    snap_b, reqs_b = _overload_run(spec, good, junk, gkeys, jkeys, None,
                                   target_s)

    att_p = snap_p["slo"]["interactive"]["attainment"]
    att_b = snap_b["slo"]["interactive"]["attainment"]
    assert att_p is not None and att_p >= 0.9, \
        f"policy attainment {att_p} (target {target_s:.3f}s)"
    assert att_b is not None and att_b < 0.9, \
        f"baseline attainment {att_b} should miss (target {target_s:.3f}s)"
    for reqs in (reqs_p, reqs_b):
        assert len(reqs) == N_JUNK + N_GOOD
        assert all(req.result is not None for req in reqs)
    assert sum(snap_p["fleet"]["preempted_rows"].values()) > 0
    assert snap_p["lvrf"]["telemetry"]["preempted"] > 0
    assert sum(snap_p["fleet"]["admitted"].values()) == N_JUNK + N_GOOD
