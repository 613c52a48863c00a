"""The port's observability layer (``repro_torch.obs``) and its use through
the threaded ``Runtime``: the ports of ``tests/test_obs.py`` (spans,
metrics, Chrome export, the ``maybe_obs`` seam, the NULL recorder,
telemetry, ``plan_drift_ratio``) and ``tests/test_obs_runtime.py`` (one
recorder, one clock and one trace for the whole stack; the fault cycle in
the trace; request classes in spans, metrics and the SLO tracker), plus
parity with the reference: the same span sequence gives an equal Chrome
trace, and the same telemetry ticks give equal EWMA floats.

The NULL path is a behavioral no-op: serving the same workload with tracing
on and off makes the same device-program calls the same number of times
and returns bit-equal results (recording happens on the host, around the
launches).

Every blocking wait carries a timeout.
"""
import json

import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.runtime.telemetry import EngineTelemetry as REngineTelemetry
from repro_torch import engine, obs
from repro_torch import runtime as rt
from repro_torch.core import factorizer as fz
from repro_torch.device import disable_tf32, generator
from repro_torch.models import lvrf
from repro_torch.runtime import faults as flt
from repro_torch.runtime.telemetry import EngineTelemetry

RESULT_TIMEOUT_S = 300.0

FAST_FAILURE = rt.FailurePolicy(max_restarts=50, backoff_initial_s=0.01,
                                backoff_max_s=0.05, health_check_every=2)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def tick(self, dt: float) -> None:
        self.t += dt


# ---------------------------------------------------------------------------
# Span store semantics
# ---------------------------------------------------------------------------

def test_span_nesting_parents_on_same_track():
    clk = FakeClock()
    rec = obs.Recorder(clock=clk)
    with rec.span("outer", track="a") as outer:
        clk.tick(1.0)
        with rec.span("inner", track="a") as inner:
            clk.tick(0.5)
            inner.args["k"] = 1
        clk.tick(0.25)
    spans = rec.spans.snapshot()
    by = {s.name: s for s in spans}
    assert by["inner"].parent == by["outer"].sid
    assert by["outer"].parent is None
    assert by["outer"].t0 <= by["inner"].t0
    assert by["inner"].t1 <= by["outer"].t1
    assert by["inner"].args == {"k": 1}
    assert outer.duration == pytest.approx(1.75)
    assert obs.validate(spans) == []


def test_span_tracks_are_independent_stacks():
    clk = FakeClock()
    rec = obs.Recorder(clock=clk)
    with rec.span("a-outer", track="a"):
        with rec.span("b-top", track="b"):
            clk.tick(0.1)
    by = {s.name: s for s in rec.spans.snapshot()}
    assert by["b-top"].parent is None  # other track's stack doesn't parent


def test_begin_end_explicit_parent_and_instants():
    clk = FakeClock()
    rec = obs.Recorder(clock=clk)
    sid = rec.begin("cycle", track="sup", args={"n": 1})
    clk.tick(0.2)
    rec.instant("mark", track="sup", parent=sid)
    clk.tick(0.2)
    rec.end(sid, args={"outcome": "ok"})
    rec.end(None)  # NULL-style sid must be a silent no-op
    spans = rec.spans.snapshot()
    cyc = next(s for s in spans if s.name == "cycle")
    mark = next(s for s in spans if s.name == "mark")
    assert mark.instant and mark.parent == cyc.sid
    assert cyc.args == {"n": 1, "outcome": "ok"}
    assert cyc.duration == pytest.approx(0.4)
    assert obs.validate(spans) == []


def test_end_clamps_backwards_clock():
    clk = FakeClock()
    rec = obs.Recorder(clock=clk)
    sid = rec.begin("s", track="t")
    clk.t -= 5.0  # a hostile clock must not produce negative durations
    rec.end(sid)
    sp = rec.spans.get(sid)
    assert sp.duration == 0.0
    assert obs.validate(rec.spans.snapshot()) == []


def test_validate_flags_malformed_trees():
    clk = FakeClock()
    rec = obs.Recorder(clock=clk)
    sid = rec.begin("parent", track="t")
    clk.tick(1.0)
    rec.end(sid)
    child = rec.begin("child", track="t", parent=sid)  # starts after parent
    clk.tick(1.0)                                      # closed -> ends after
    rec.end(child)
    orphan = rec.begin("orphan", track="t", parent=10_000)
    rec.end(orphan)
    errs = obs.validate(rec.spans.snapshot())
    assert any("unknown parent" in e for e in errs)
    assert any("after" in e for e in errs)


def test_unbalanced_context_exit_unwinds_stack():
    rec = obs.Recorder(clock=FakeClock())
    with pytest.raises(RuntimeError):
        with rec.span("outer", track="a"):
            with rec.span("inner", track="a"):
                raise RuntimeError("boom")
    # both spans closed despite the exception; a fresh span parents cleanly
    with rec.span("next", track="a"):
        pass
    by = {s.name: s for s in rec.spans.snapshot()}
    assert by["next"].parent is None
    assert all(not s.open for s in rec.spans.snapshot())


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

def test_metrics_counters_gauges_labels_snapshot_nondestructive():
    m = obs.MetricsRegistry()
    m.counter("reqs", engine="a").add(2)
    m.counter("reqs", engine="a").add(1)
    m.counter("reqs", engine="b").add(5)
    m.gauge("slots", engine="a").set(16)
    s1 = m.snapshot()
    s2 = m.snapshot()  # non-destructive: identical back-to-back reads
    assert s1 == s2
    assert s1["reqs"] == {"engine=a": 3, "engine=b": 5}
    assert s1["slots"] == {"engine=a": 16}


def test_metrics_kind_mismatch_raises():
    m = obs.MetricsRegistry()
    m.counter("x")
    with pytest.raises(TypeError):
        m.gauge("x")


def test_histogram_summary_percentiles():
    m = obs.MetricsRegistry()
    h = m.histogram("lat")
    for v in [0.001, 0.002, 0.004, 0.008, 0.1]:
        h.observe(v)
    s = h.summary()
    assert s["count"] == 5
    # percentiles interpolate within log buckets: monotone, and bounded by
    # one bucket edge (10^(1/4) with 4 buckets/decade) above the true max
    assert s["min"] <= s["p50"] <= s["p99"] <= s["max"] * 10 ** 0.25
    assert s["mean"] == pytest.approx(np.mean([0.001, 0.002, 0.004,
                                               0.008, 0.1]))


# ---------------------------------------------------------------------------
# maybe_obs env seam + NULL recorder
# ---------------------------------------------------------------------------

def test_maybe_obs_resolution(monkeypatch):
    monkeypatch.delenv("REPRO_OBS", raising=False)
    assert obs.maybe_obs(None) is obs.NULL
    rec = obs.Recorder()
    assert obs.maybe_obs(rec) is rec
    monkeypatch.setenv("REPRO_OBS", "1")
    auto = obs.maybe_obs(None)
    assert isinstance(auto, obs.Recorder) and auto.enabled


def test_null_recorder_is_free_and_inert():
    n = obs.NULL
    assert not n.enabled
    # ONE shared context-manager singleton: the whole disabled span cost
    assert n.span("x") is n.span("y", track="z")
    with n.span("x") as sp:
        assert sp is None
    assert n.begin("a", track="t") is None
    n.end(None)
    n.instant("i", track="t")
    n.count("c")
    n.gauge("g", 1)
    n.observe("h", 0.5)
    assert isinstance(n.now(), float)


# ---------------------------------------------------------------------------
# Engine integration: zero overhead, bit-equality, identical calls
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lvrf_setup():
    disable_tf32()
    cfg = lvrf.LVRFConfig()
    atoms = lvrf.init_atoms(generator(0), cfg, device="cpu")
    spec = engine.registry.build("lvrf_rows", 0, fused_step=True, atoms=atoms,
                                 device="cpu")
    return spec, cfg, atoms


def _four_rows(setup):
    spec, cfg, atoms = setup
    vals = np.random.default_rng(7).integers(0, cfg.n_values, (4, 3))
    return spec, lvrf.encode_row(atoms, vals, cfg), fz.draw_keys(42, 4)


def _count_dispatches(eng) -> dict:
    """Wrap the engine's three device programs with call counters."""
    counts = {"sweeps": 0, "refill": 0, "decode": 0}
    sweeps, refill, decode = eng._sweeps, eng._refill_many, eng._decode

    def w(tag, fn):
        def wrapped(*a, **k):
            counts[tag] += 1
            return fn(*a, **k)
        return wrapped

    eng._sweeps = w("sweeps", sweeps)
    eng._refill_many = w("refill", refill)
    eng._decode = w("decode", decode)
    return counts


def _serve(eng, queries, keys):
    for i in range(queries.shape[0]):
        eng.submit(queries[i], keys=keys[i][None])
    return eng.drain()


def test_tracing_is_zero_overhead_bit_equal(lvrf_setup):
    """With a live Recorder vs the NULL default, the same workload makes the
    same device-program calls the same number of times, and every result is
    bit-equal: recording stays on the host."""
    spec, queries, keys = _four_rows(lvrf_setup)
    rec = obs.Recorder()
    eng_on = engine.Engine(spec, slots=2, sweeps_per_step=2, obs=rec,
                           device="cpu")
    eng_off = engine.Engine(spec, slots=2, sweeps_per_step=2, device="cpu")
    assert eng_on.obs is rec and eng_off.obs is obs.NULL
    c_on, c_off = _count_dispatches(eng_on), _count_dispatches(eng_off)
    done_on = _serve(eng_on, queries, keys)
    done_off = _serve(eng_off, queries, keys)
    assert c_on == c_off and c_on["sweeps"] > 0
    assert len(done_on) == len(done_off) == queries.shape[0]
    for a, b in zip(done_on, done_off):
        for x, y in zip(a.factorization, b.factorization):
            np.testing.assert_array_equal(x, y)
    names = {s.name for s in rec.spans.snapshot()}
    assert {"step", "sweep-burst", "retire", "fill"} <= names
    snap = rec.metrics.snapshot()
    assert snap["submitted"]["engine=lvrf_rows"] == queries.shape[0]
    assert snap["sweeps"]["engine=lvrf_rows"] >= 1
    assert obs.validate(rec.spans.snapshot()) == []


def test_engine_snapshot_nondestructive_stats_drains(lvrf_setup):
    spec, queries, keys = _four_rows(lvrf_setup)
    eng = engine.Engine(spec, slots=2, sweeps_per_step=2, device="cpu")
    _serve(eng, queries, keys)
    s1 = eng.snapshot()
    s2 = eng.snapshot()
    assert s1 == s2
    assert s1["engine_kind"] == "factorizer"
    assert s1["units_total"] == s1["sweeps_total"] > 0
    assert s1["window_completed"] == queries.shape[0]
    assert s1["latency_p50_ms"] is not None
    drained = eng.stats()
    assert drained["window_completed"] == queries.shape[0]
    assert eng.snapshot()["window_completed"] == 0
    assert eng.snapshot()["completed"] == queries.shape[0]


def test_engine_adopts_recorder_clock(lvrf_setup):
    spec, _, _ = lvrf_setup
    clk = FakeClock()
    rec = obs.Recorder(clock=clk)
    eng = engine.Engine(spec, slots=2, obs=rec, device="cpu")
    assert eng._clock is clk
    explicit = lambda: 0.0
    eng2 = engine.Engine(spec, slots=2, obs=rec, clock=explicit, device="cpu")
    assert eng2._clock is explicit
    eng2.bind_obs(rec)
    assert eng2._clock is explicit


# ---------------------------------------------------------------------------
# Chrome trace export schema
# ---------------------------------------------------------------------------

def test_chrome_trace_schema_loads():
    clk = FakeClock()
    rec = obs.Recorder(clock=clk)
    with rec.span("step", track="eng", cat="engine"):
        clk.tick(0.25)
    rec.instant("mark", track="sup")
    open_sid = rec.begin("open", track="sup")
    rec.count("reqs", 3, engine="eng")
    trace = json.loads(json.dumps(rec.to_chrome_trace(), default=str))
    evs = trace["traceEvents"]
    tracks = {e["args"]["name"] for e in evs if e["name"] == "thread_name"}
    assert tracks == {"eng", "sup"}
    x = next(e for e in evs if e.get("ph") == "X")
    assert x["name"] == "step" and x["dur"] == pytest.approx(0.25e6)
    assert x["ts"] >= 0 and x["cat"] == "engine"
    i = next(e for e in evs if e.get("ph") == "i")
    assert i["name"] == "mark" and i["s"] == "t"
    b = next(e for e in evs if e.get("ph") == "B")  # still-open span exports
    assert b["name"] == "open" and b["args"]["_span_id"] == open_sid
    assert all(("pid" in e and "tid" in e and "name" in e) for e in evs)
    assert trace["otherData"]["metrics"]["reqs"] == {"engine=eng": 3}


def test_write_chrome_trace_roundtrip(tmp_path):
    rec = obs.Recorder(clock=FakeClock())
    with rec.span("s", track="t"):
        pass
    path = tmp_path / "trace.json"
    rec.write_chrome_trace(str(path))
    loaded = json.loads(path.read_text())
    assert any(e["name"] == "s" for e in loaded["traceEvents"])


# ---------------------------------------------------------------------------
# Planner drift telemetry
# ---------------------------------------------------------------------------

def test_plan_drift_ratio():
    t = EngineTelemetry()
    assert t.plan_drift_ratio() is None
    t.on_step(0.5, 2, step_s=0.4, units=2, modeled_unit_s=0.1)
    # measured 0.2 s/unit vs modeled 0.1 s/unit -> plan is 2x optimistic
    assert t.plan_drift_ratio() == pytest.approx(2.0)
    snap = t.snapshot(now=1.0)
    assert snap["plan_drift_ratio"] == pytest.approx(2.0)
    assert snap["modeled_unit_s"] == pytest.approx(0.1)
    t.on_step(0.5, 2, step_s=0.0, units=0)  # idle step: drift unchanged
    assert t.plan_drift_ratio() == pytest.approx(2.0)


# ---------------------------------------------------------------------------
# Through the threaded Runtime: one recorder, one clock, one trace
# ---------------------------------------------------------------------------

def _lvrf_queries(cfg, atoms, n_good: int, n_junk: int, seed: int):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, cfg.n_values, (n_good, 3))
    good = lvrf.encode_row(atoms, vals, cfg)
    junk = torch.from_numpy(
        rng.normal(size=(n_junk, cfg.vsa.dim)).astype(np.float32))
    return vals, good, junk


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_runtime_binds_engines_onto_one_recorder(lvrf_setup):
    """register() adopts default-built engines into the runtime's recorder
    (obs + clock + track=registered name); request spans open at submit and
    close with the outcome; the whole run exports as one Chrome trace."""
    spec, cfg, atoms = lvrf_setup
    _, good, _ = _lvrf_queries(cfg, atoms, n_good=3, n_junk=0, seed=31)
    keys = fz.draw_keys(5, 3)
    rec = obs.Recorder()
    eng = engine.Engine(spec, slots=2, sweeps_per_step=2,
                           device="cpu")
    assert eng.obs is obs.NULL  # default-built: nothing recorded yet
    r = rt.Runtime(obs=rec, failure=FAST_FAILURE)
    r.register("lvrf", eng)
    assert eng.obs is rec  # rebound at registration...
    assert eng.obs_track == "lvrf"  # ...under the registered name
    assert eng._clock is rec.clock  # ...on the recorder's clock
    assert r._clock is rec.clock  # the runtime itself steps the same clock
    with r:
        gids = [r.submit("lvrf", good[i], keys=keys[i][None])
                for i in range(3)]
        reqs = [r.result(g, timeout=RESULT_TIMEOUT_S) for g in gids]
        # non-destructive stats: two scrapes see the same rolling window
        s1, s2 = r.stats()["lvrf"], r.stats()["lvrf"]
        assert s1["window_completed"] == s2["window_completed"] == 3
        assert s1["engine_kind"] == "factorizer"
        assert "plan_drift_ratio" in s1["telemetry"]
        assert s1["telemetry"]["modeled_unit_s"] is not None
    assert all(req.result is not None for req in reqs)
    spans = rec.spans.snapshot()
    assert obs.validate(spans) == []
    by = _by_name(spans)
    # one request span per submit, all closed, all resolved ok
    reqs_spans = by["request"]
    assert len(reqs_spans) == 3
    assert all(not s.open and s.args["outcome"] == "ok" for s in reqs_spans)
    # admit instants ride as children of their request span
    req_sids = {s.sid for s in reqs_spans}
    admits = by["admit"]
    assert len(admits) == 3
    assert all(a.instant and a.parent in req_sids for a in admits)
    # engine internals landed on the engine's registered track
    assert {s.track for s in by["step"]} == {"lvrf"}
    assert {"sweep-burst", "retire"} <= set(by)
    # engine steps are framed by the request lifecycle on the shared clock
    t_open = min(s.t0 for s in reqs_spans)
    t_close = max(s.t1 for s in reqs_spans)
    assert any(t_open <= s.t0 and s.t1 <= t_close for s in by["step"])
    snap = rec.metrics.snapshot()
    # resolved counters carry the request class; unlabeled submits default
    # to the engine kind
    assert snap["resolved"] == {"class=factorizer,outcome=ok": 3}
    assert snap["submitted"]["engine=lvrf"] == 3
    # planner drift is surfaced continuously as gauges, not only at retunes
    assert "plan_drift" in snap and "engine=lvrf" in snap["plan_drift"]
    assert snap["modeled_unit_s"]["engine=lvrf"] > 0
    # per-class latency histogram feeds snapshot-side quantiles
    lat = snap["request_latency_s"]["class=factorizer"]
    assert lat["count"] == 3
    assert obs.quantile(lat, 95) is not None
    # and it all exports as ONE trace: every track present, JSON-clean
    evs = rec.to_chrome_trace()["traceEvents"]
    tracks = {e["args"]["name"] for e in evs if e["name"] == "thread_name"}
    assert {"requests", "lvrf"} <= tracks


def test_chaos_run_traces_the_fault_cycle(lvrf_setup):
    """The chaos story in one trace: chaos-inject on the engine track, then
    a supervisor fault-cycle span with fault/quarantined/recovered child
    instants, the engine's recover span, and every request span closed."""
    spec, cfg, atoms = lvrf_setup
    _, good, junk = _lvrf_queries(cfg, atoms, n_good=2, n_junk=2, seed=33)
    keys = fz.draw_keys(13, 4)
    rec = obs.Recorder()
    inner = engine.Engine(spec, slots=2, sweeps_per_step=2,
                           device="cpu")
    # seed 1 draws (0.51, 0.95, 0.14, ...) at rate 0.4: the fault fires on
    # the THIRD step — after the junk rows are live mid-trajectory, so
    # recovery has rows to replay
    chaos = flt.ChaosEngine(inner, flt.FaultPlan(
        seed=1, step_error_rate=0.4, max_faults=1))
    r = rt.Runtime(obs=rec, failure=FAST_FAILURE)
    r.register("lvrf", chaos)  # bind_obs resolves through the wrapper...
    assert inner.obs is rec  # ...onto the wrapped engine
    with r:
        # junk first: they hold the slots mid-trajectory when the fault
        # lands, so recovery has live rows to replay
        jids = [r.submit("lvrf", junk[j], keys=keys[j][None])
                for j in range(2)]
        gids = [r.submit("lvrf", good[i], keys=keys[2 + i][None])
                for i in range(2)]
        out = r.drain(timeout=RESULT_TIMEOUT_S, return_exceptions=True)
    assert len(out) == 4 and all(not isinstance(o, Exception) for o in out)
    assert chaos.injected["step_error"] == 1
    spans = rec.spans.snapshot()
    assert obs.validate(spans) == []
    by = _by_name(spans)
    # the injection is visible on the ENGINE's track, stamped by the harness
    inj = by["chaos-inject"]
    assert len(inj) == 1 and inj[0].track == "lvrf"
    assert inj[0].args["kind"] == "step_error"
    # one fault-cycle span on the supervisor track, closed by recovery
    cycles = by["fault-cycle"]
    assert len(cycles) == 1
    cyc = cycles[0]
    assert cyc.track == "supervisor" and not cyc.open
    assert cyc.args["engine"] == "lvrf"
    assert cyc.args["outcome"] == "recovered"
    # its children narrate the episode in order on the one shared clock
    kids = {s.name: s for s in spans if s.parent == cyc.sid}
    assert {"fault", "quarantined", "recovered"} <= set(kids)
    assert kids["fault"].t0 <= kids["quarantined"].t0 \
        <= kids["recovered"].t0
    assert kids["fault"].args["kind"] == "injected"
    assert kids["recovered"].args["replayed"] >= 1
    # the injection precedes the fault it causes
    assert inj[0].t0 <= kids["fault"].t0
    # the engine-side recover span landed on the engine track
    recov = by["recover"]
    assert len(recov) == 1 and recov[0].track == "lvrf"
    assert recov[0].args["replayed"] == kids["recovered"].args["replayed"]
    # every request span closed ok — the chaos invariant, in trace form
    assert all(not s.open and s.args["outcome"] == "ok"
               for s in by["request"])
    snap = rec.metrics.snapshot()
    assert snap["faults"] == {"engine=lvrf": 1}
    assert snap["quarantines"] == {"engine=lvrf": 1}
    assert snap["recoveries"] == {"engine=lvrf": 1}
    assert snap["chaos_injected"] == {"kind=step_error": 1}
    # Runtime.stats reads the chaos counters through the wrapper's snapshot
    stats = r.stats()["lvrf"]
    assert stats["chaos"]["step_error"] == 1
    assert stats["recoveries"] == 1


def test_failed_requests_close_spans_with_error(lvrf_setup):
    """A future that resolves to a structured fault still closes its
    request span — with the error type as the outcome."""
    spec, cfg, atoms = lvrf_setup
    _, good, junk = _lvrf_queries(cfg, atoms, n_good=1, n_junk=1, seed=35)
    keys = fz.draw_keys(17, 2)
    rec = obs.Recorder()
    r = rt.Runtime(obs=rec, failure=FAST_FAILURE)
    r.register("lvrf", engine.Engine(spec, slots=2, sweeps_per_step=2,
                           device="cpu"))
    with r:
        doomed = r.submit("lvrf", junk[0], keys=keys[0][None],
                          deadline_s=0.0)  # guaranteed miss
        ok = r.submit("lvrf", good[0], keys=keys[1][None])
        with pytest.raises(flt.DeadlineExceededError):
            r.result(doomed, timeout=RESULT_TIMEOUT_S)
        r.result(ok, timeout=RESULT_TIMEOUT_S)
    spans = {s.args.get("gid"): s for s in rec.spans.snapshot()
             if s.name == "request"}
    assert not spans[doomed].open
    assert spans[doomed].args["outcome"] == "DeadlineExceededError"
    assert spans[ok].args["outcome"] == "ok"
    snap = rec.metrics.snapshot()
    assert snap["resolved"] == {"class=factorizer,outcome=ok": 1,
                                "class=factorizer,outcome=error": 1}
    assert obs.validate(rec.spans.snapshot()) == []
    # the SLO tracker routed both outcomes under the default class
    slo = r.stats()["slo"]["factorizer"]
    assert slo["completed"] == 1 and slo["deadline_missed"] == 1
    assert slo["deadline_miss_rate"] == 0.5


def test_request_classes_flow_into_spans_metrics_and_slo(lvrf_setup):
    """submit(class_=...) labels the request span, the resolved counter,
    the latency histogram, and the per-class SLO snapshot; unlabeled
    requests default to the engine kind."""
    spec, cfg, atoms = lvrf_setup
    _, good, _ = _lvrf_queries(cfg, atoms, n_good=3, n_junk=0, seed=41)
    keys = fz.draw_keys(19, 3)
    rec = obs.Recorder()
    r = rt.Runtime(obs=rec, failure=FAST_FAILURE,
                   slo={"interactive": obs.SLOTarget(30.0, percentile=95)})
    r.register("lvrf", engine.Engine(spec, slots=2, sweeps_per_step=2,
                           device="cpu"))
    with r:
        a = r.submit("lvrf", good[0], keys=keys[0][None],
                     class_="interactive")
        b = r.submit("lvrf", good[1], keys=keys[1][None],
                     class_="interactive")
        c = r.submit("lvrf", good[2], keys=keys[2][None])  # default class
        for g in (a, b, c):
            r.result(g, timeout=RESULT_TIMEOUT_S)
        slo = r.stats()["slo"]
    assert set(slo) == {"interactive", "factorizer"}
    assert slo["interactive"]["submitted"] == 2
    assert slo["interactive"]["completed"] == 2
    assert slo["interactive"]["latency_p95_s"] > 0
    # the generous target is attained on a healthy run
    assert slo["interactive"]["attainment"] == 1.0
    assert slo["interactive"]["attained"] is True
    # untargeted default class still reports percentiles, no attainment
    assert slo["factorizer"]["completed"] == 1
    assert slo["factorizer"]["attainment"] is None
    spans = {s.args["gid"]: s for s in rec.spans.snapshot()
             if s.name == "request"}
    assert spans[a].args["class"] == "interactive"
    assert spans[c].args["class"] == "factorizer"
    snap = rec.metrics.snapshot()
    assert snap["resolved"] == {"class=interactive,outcome=ok": 2,
                                "class=factorizer,outcome=ok": 1}
    assert snap["request_latency_s"]["class=interactive"]["count"] == 2


def test_class_labels_are_free_under_null_recorder(lvrf_setup):
    """Zero-overhead contract extended to the class-label path: with the
    NULL recorder, submitting with class_ labels records nothing, the SLO
    tracker still counts (host arithmetic, like telemetry), and results
    are bit-equal to an untraced, unlabeled run."""
    spec, cfg, atoms = lvrf_setup
    vals, good, _ = _lvrf_queries(cfg, atoms, n_good=2, n_junk=0, seed=43)
    keys = fz.draw_keys(23, 2)

    def run(class_=None, obs_rec=None):
        eng = engine.Engine(spec, slots=2, sweeps_per_step=2,
                           device="cpu")
        r = rt.Runtime(obs=obs_rec, failure=FAST_FAILURE)
        r.register("lvrf", eng)
        with r:
            gids = [r.submit("lvrf", good[i], keys=keys[i][None],
                             **({"class_": class_} if class_ else {}))
                    for i in range(2)]
            out = [r.result(g, timeout=RESULT_TIMEOUT_S) for g in gids]
        return r, [req.result for req in out]

    def assert_bit_equal(xs, ys):
        for x, y in zip(xs, ys):
            assert set(x) == set(y)
            for k in x:
                np.testing.assert_array_equal(np.asarray(x[k]),
                                              np.asarray(y[k]))

    r_plain, res_plain = run()
    r_null, res_null = run(class_="interactive")  # NULL recorder, labeled
    rec = obs.Recorder()
    r_obs, res_obs = run(class_="interactive", obs_rec=rec)
    assert_bit_equal(res_plain, res_null)
    assert_bit_equal(res_plain, res_obs)
    # NULL recorder recorded nothing, but SLO accounting still ran
    assert r_null.obs is obs.NULL
    assert r_null.stats()["slo"]["interactive"]["completed"] == 2
    assert rec.metrics.snapshot()["resolved"] == {
        "class=interactive,outcome=ok": 2}


# ---------------------------------------------------------------------------
# Parity with the reference's recorder and telemetry
# ---------------------------------------------------------------------------

def _span_script(mod, seed: int) -> dict:
    """A seeded sequence of nested spans, explicit begin/end pairs,
    instants, counters, gauges and histogram observations on a fake clock;
    returns the Chrome trace."""
    rng = np.random.default_rng(seed)
    clk = FakeClock()
    rec = mod.Recorder(clock=clk)
    open_sids = []
    for i in range(60):
        kind = int(rng.integers(0, 5))
        track = str(rng.choice(["lvrf", "lm", "supervisor", "requests"]))
        if kind == 0:
            with rec.span("step", track=track, cat="engine",
                          args={"i": i}) as sp:
                clk.tick(float(rng.random()) * 1e-3)
                with rec.span("sweep-burst", track=track, cat="engine"):
                    clk.tick(float(rng.random()) * 1e-3)
                sp.args["sweeps"] = int(rng.integers(1, 9))
        elif kind == 1:
            open_sids.append(rec.begin("request", track="requests",
                                       cat="request", args={"gid": i}))
        elif kind == 2 and open_sids:
            rec.end(open_sids.pop(int(rng.integers(len(open_sids)))),
                    args={"outcome": "ok"})
        elif kind == 3:
            rec.instant("admit", track=track, cat="request",
                        parent=open_sids[-1] if open_sids else None)
        else:
            rec.count("steps", int(rng.integers(1, 4)), engine=track)
            rec.gauge("slots", int(rng.integers(1, 256)), engine=track)
            rec.observe("request_latency_s", float(rng.random()),
                        **{"class": track})
        clk.tick(float(rng.random()) * 1e-4)
    return json.loads(json.dumps(rec.to_chrome_trace(), default=str))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chrome_trace_equals_the_reference(seed):
    """The same span sequence on the same clock gives an equal Chrome trace
    (events, track ids, metrics) in both packages."""
    got, want = _span_script(obs, seed), _span_script(robs, seed)
    assert got == want
    assert {e["ph"] for e in got["traceEvents"]} >= {"X", "i", "M"}


def test_telemetry_ticks_equal_the_reference():
    """The same telemetry ticks give equal EWMA floats and snapshots."""
    rng = np.random.default_rng(5)
    a, b = EngineTelemetry(), REngineTelemetry()
    now = 0.0
    for _ in range(200):
        now += float(rng.exponential(0.01))
        n = int(rng.integers(1, 3))
        a.on_submit(now, n=n)
        b.on_submit(now, n=n)
        busy, depth = float(rng.random()), int(rng.integers(0, 64))
        step_s, units = float(rng.random()) * 1e-3, int(rng.integers(0, 4))
        a.on_step(busy, depth, step_s=step_s, units=units,
                  modeled_unit_s=1e-4)
        b.on_step(busy, depth, step_s=step_s, units=units,
                  modeled_unit_s=1e-4)
        lat = float(rng.random())
        a.on_complete(lat)
        b.on_complete(lat)
    assert a.step_unit_s() == b.step_unit_s()
    assert a.utilization == b.utilization
    assert a.plan_drift_ratio() == b.plan_drift_ratio()
    assert a.snapshot(now + 1.0) == b.snapshot(now + 1.0)
