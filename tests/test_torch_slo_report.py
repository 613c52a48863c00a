"""SLO math and span-derived attribution of the port (``repro_torch.obs``)
— thread-free, fake clocks only: the ports of ``tests/test_slo_report.py``'s
tests (histogram buckets and the ``quantile`` helper, ``SLOTracker``
attainment against a NumPy reference, ``attribution`` on hand-built
timelines where every bucket is known in closed form), plus parity: the
same synthetic span store gives an equal ``render_json(attribution(...))``
and the same outcomes an equal SLO snapshot in both packages.
"""
import numpy as np
import pytest

from repro import obs as robs
from repro_torch import obs


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def tick(self, dt: float) -> None:
        self.t += dt


# ---------------------------------------------------------------------------
# histogram buckets + quantile helper
# ---------------------------------------------------------------------------

def test_histogram_summary_exports_consistent_buckets():
    rec = obs.Recorder(clock=FakeClock())
    for v in (0.001, 0.002, 0.004, 0.1, 0.1, 3.0):
        rec.observe("lat", v)
    snap = rec.metrics.snapshot()["lat"][""]
    assert snap["count"] == 6
    edges, buckets = snap["edges"], snap["buckets"]
    assert len(buckets) == len(edges) + 1  # underflow + per-edge overflow
    assert edges == sorted(edges)
    assert sum(buckets) == snap["count"]
    assert snap["min"] == pytest.approx(0.001)
    assert snap["max"] == pytest.approx(3.0)


def test_quantile_clamps_to_observed_extrema():
    rec = obs.Recorder(clock=FakeClock())
    for v in (0.01, 0.02, 0.05):
        rec.observe("lat", v)
    snap = rec.metrics.snapshot()["lat"][""]
    assert obs.quantile(snap, 0) == pytest.approx(0.01)
    assert obs.quantile(snap, 100) == pytest.approx(0.05)
    with pytest.raises(ValueError):
        obs.quantile(snap, 101)


def test_quantile_within_bucket_resolution():
    """Bucketed percentiles can't beat the bucket width, but they must land
    within one log-bucket (25%/decade -> ratio ~1.78) of the exact value."""
    rng = np.random.default_rng(0)
    vals = rng.lognormal(mean=-3.0, sigma=1.0, size=500)
    rec = obs.Recorder(clock=FakeClock())
    for v in vals:
        rec.observe("lat", float(v))
    snap = rec.metrics.snapshot()["lat"][""]
    for q in (50, 95, 99):
        exact = float(np.percentile(vals, q))
        est = obs.quantile(snap, q)
        assert est / exact < 10 ** 0.25 * 1.01
        assert exact / est < 10 ** 0.25 * 1.01


def test_quantile_from_span_durations_on_fake_clock():
    clk = FakeClock()
    rec = obs.Recorder(clock=clk)
    for dur in (0.010, 0.020, 0.040, 0.080):
        with rec.span("work", track="t") as sp:
            clk.tick(dur)
        rec.observe("work_s", sp.duration)
    snap = rec.metrics.snapshot()["work_s"][""]
    assert snap["count"] == 4
    assert obs.quantile(snap, 0) == pytest.approx(0.010)
    assert obs.quantile(snap, 100) == pytest.approx(0.080)
    assert obs.quantile(snap, 50) <= obs.quantile(snap, 95)


# ---------------------------------------------------------------------------
# SLOTracker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_attainment_matches_numpy_reference(seed):
    rng = np.random.default_rng(seed)
    lats = rng.exponential(0.1, size=200)
    target = float(np.percentile(lats, 60))  # mid-distribution target
    tr = obs.SLOTracker({"c": obs.SLOTarget(target, percentile=95)})
    for lat in lats:
        tr.on_submit("c")
        tr.on_complete("c", float(lat))
    snap = tr.snapshot()["c"]
    assert snap["submitted"] == snap["completed"] == 200
    assert snap["window"] == 200
    for q in (50, 95, 99):
        assert snap[f"latency_p{q}_s"] == pytest.approx(
            float(np.percentile(lats, q)))
    want = float(np.mean(lats <= target))
    assert snap["attainment"] == pytest.approx(want)
    assert snap["attained"] == (snap["latency_p95_s"] <= target)


def test_slo_rates_are_exact_fractions():
    tr = obs.SLOTracker(default_target=obs.SLOTarget(1.0))
    for _ in range(6):
        tr.on_submit("c")
    tr.on_complete("c", 0.5)
    tr.on_complete("c", 0.5)
    tr.on_deadline_miss("c")
    tr.on_failure("c")
    tr.on_shed("c")  # shed counts separately from submitted
    snap = tr.snapshot()["c"]
    assert snap["deadline_miss_rate"] == pytest.approx(1 / 4)  # of resolved
    assert snap["shed_rate"] == pytest.approx(1 / 7)  # of offered
    assert snap["attainment"] == pytest.approx(2 / 3)  # misses count against
    assert snap["attained"] is False  # any window miss fails the SLO


def test_slo_window_cap_truncates_oldest():
    tr = obs.SLOTracker(window_cap=16)
    for i in range(100):
        tr.on_submit("c")
        tr.on_complete("c", float(i))
    snap = tr.snapshot()["c"]
    assert snap["completed"] == 100  # all-time counter survives the trim
    assert snap["window"] <= 16
    assert snap["latency_p50_s"] >= 84.0  # only recent latencies remain


def test_slo_target_validation():
    with pytest.raises(ValueError):
        obs.SLOTarget(-1.0)
    with pytest.raises(ValueError):
        obs.SLOTarget(1.0, percentile=0.0)


# ---------------------------------------------------------------------------
# attribution on synthetic span timelines
# ---------------------------------------------------------------------------

def _request(rec, clk, gid, engine, cls="c"):
    sid = rec.begin("request", track="requests", cat="request",
                    args={"gid": gid, "engine": engine, "class": cls})
    return sid


def _admit(rec, sid):
    rec.instant("admit", track="requests", parent=sid)


def test_attribution_queue_wait_and_phase_split():
    clk = FakeClock()
    rec = obs.Recorder(clock=clk)
    sid = _request(rec, clk, 1, "e")
    clk.tick(2.0)           # queue wait: submit -> admit
    _admit(rec, sid)
    with rec.span("step", track="e", cat="engine"):
        clk.tick(0.5)       # host bookkeeping inside the step -> step_other
        with rec.span("fill", track="e", cat="engine"):
            clk.tick(1.0)
        with rec.span("sweep-burst", track="e", cat="engine",
                      args={"sweeps": 4}):
            clk.tick(3.0)
        with rec.span("retire", track="e", cat="engine"):
            clk.tick(0.5)
    rec.end(sid, args={"outcome": "ok"})
    rep = obs.attribution(rec)
    row = rep["requests"][0]
    assert row["queue_wait_s"] == pytest.approx(2.0)
    assert row["phases"]["fill"] == pytest.approx(1.0)
    assert row["phases"]["sweep_burst"] == pytest.approx(3.0)
    assert row["phases"]["retire"] == pytest.approx(0.5)
    assert row["phases"]["step_other"] == pytest.approx(0.5)
    assert row["phases"]["other"] == pytest.approx(0.0)
    assert row["coverage"] == pytest.approx(1.0)
    assert rep["coverage"]["min"] == pytest.approx(1.0)
    # per-engine totals integrate the same spans
    eng = rep["engines"]["e"]
    assert eng["steps"] == 1
    assert eng["burst_units"] == 4
    assert eng["measured_unit_s"] == pytest.approx(3.0 / 4)


def test_attribution_cross_engine_and_dispatch():
    clk = FakeClock()
    rec = obs.Recorder(clock=clk)
    sid = _request(rec, clk, 1, "a")
    _admit(rec, sid)
    # the stepper serves engine b first: dispatch envelope around b's step
    with rec.span("dispatch", track="runtime", cat="runtime",
                  args={"engine": "b"}):
        clk.tick(0.25)      # b's stepper host work -> still cross_engine
        with rec.span("step", track="b", cat="engine"):
            clk.tick(1.0)
    # then engine a: dispatch remainder beyond the step envelope
    with rec.span("dispatch", track="runtime", cat="runtime",
                  args={"engine": "a"}):
        with rec.span("step", track="a", cat="engine"):
            with rec.span("sweep-burst", track="a", cat="engine",
                          args={"sweeps": 1}):
                clk.tick(2.0)
        clk.tick(0.5)       # telemetry/future-resolution after the step
    rec.end(sid, args={"outcome": "ok"})
    row = obs.attribution(rec)["requests"][0]
    assert row["phases"]["cross_engine"] == pytest.approx(1.25)
    assert row["phases"]["sweep_burst"] == pytest.approx(2.0)
    assert row["phases"]["dispatch"] == pytest.approx(0.5)
    assert row["coverage"] == pytest.approx(1.0)


def test_attribution_quarantine_outranks_foreign_steps():
    clk = FakeClock()
    rec = obs.Recorder(clock=clk)
    sid = _request(rec, clk, 1, "a")
    _admit(rec, sid)
    # a's fault cycle runs while the stepper serves b: the stall must be
    # blamed on a's quarantine, not on b's (lower-priority) foreign step
    fc = rec.begin("fault-cycle", track="supervisor", cat="supervision",
                   args={"engine": "a"})
    with rec.span("step", track="b", cat="engine"):
        clk.tick(4.0)
    rec.end(fc)
    with rec.span("step", track="a", cat="engine"):
        with rec.span("sweep-burst", track="a", cat="engine",
                      args={"sweeps": 1}):
            clk.tick(1.0)
    rec.end(sid, args={"outcome": "ok"})
    row = obs.attribution(rec)["requests"][0]
    assert row["phases"]["quarantine_backoff"] == pytest.approx(4.0)
    assert "cross_engine" not in row["phases"]
    assert row["coverage"] == pytest.approx(1.0)


def test_attribution_ingest_covers_admission_gap():
    clk = FakeClock()
    rec = obs.Recorder(clock=clk)
    sid = _request(rec, clk, 1, "a")
    with rec.span("ingest", track="runtime", cat="runtime"):
        clk.tick(0.5)
        _admit(rec, sid)    # admitted mid-burst...
        clk.tick(1.5)       # ...stepper admits the REST of the burst
    with rec.span("step", track="a", cat="engine"):
        clk.tick(1.0)
    rec.end(sid, args={"outcome": "ok"})
    row = obs.attribution(rec)["requests"][0]
    assert row["queue_wait_s"] == pytest.approx(0.5)
    assert row["phases"]["ingest"] == pytest.approx(1.5)
    assert row["phases"]["step_other"] == pytest.approx(1.0)
    assert row["coverage"] == pytest.approx(1.0)


def test_attribution_never_admitted_is_pure_queue_wait():
    clk = FakeClock()
    rec = obs.Recorder(clock=clk)
    sid = _request(rec, clk, 7, "a")
    clk.tick(3.0)
    rec.end(sid, args={"outcome": "DeadlineExceededError"})
    row = obs.attribution(rec)["requests"][0]
    assert row["queue_wait_s"] == pytest.approx(3.0)
    assert row["service_s"] == 0.0
    assert row["coverage"] == pytest.approx(1.0)
    assert row["outcome"] == "DeadlineExceededError"


def test_attribution_span_drift_vs_modeled_gauge():
    clk = FakeClock()
    rec = obs.Recorder(clock=clk)
    rec.gauge("modeled_unit_s", 0.5, engine="e")
    sid = _request(rec, clk, 1, "e")
    _admit(rec, sid)
    with rec.span("step", track="e", cat="engine"):
        with rec.span("sweep-burst", track="e", cat="engine",
                      args={"sweeps": 8}):
            clk.tick(8.0)   # measured 1.0 s/unit vs modeled 0.5 -> drift 2x
    rec.end(sid, args={"outcome": "ok"})
    eng = obs.attribution(rec)["engines"]["e"]
    assert eng["modeled_unit_s"] == pytest.approx(0.5)
    assert eng["measured_unit_s"] == pytest.approx(1.0)
    assert eng["span_drift_ratio"] == pytest.approx(2.0)


def test_attribution_renders_text_and_json():
    clk = FakeClock()
    rec = obs.Recorder(clock=clk)
    sid = _request(rec, clk, 1, "e", cls="interactive")
    _admit(rec, sid)
    with rec.span("step", track="e", cat="engine"):
        clk.tick(1.0)
    rec.end(sid, args={"outcome": "ok"})
    rep = obs.attribution(rec)
    txt = obs.render_text(rep)
    assert "interactive" in txt and "coverage" in txt and "e:" in txt
    import json as _json
    assert _json.loads(obs.render_json(rep))["coverage"]["requests"] == 1


# ---------------------------------------------------------------------------
# Parity with the reference's report and tracker
# ---------------------------------------------------------------------------

def _synthetic_store(mod, seed: int, retune_rate: float = 0.0):
    """A seeded runtime-shaped timeline on a fake clock: requests of three
    classes over two engines, admitted inside ingest bursts, served by
    dispatch-wrapped steps with phase children, with fault cycles, resizes,
    replays and (at ``retune_rate``) re-tunes among them."""
    rng = np.random.default_rng(seed)
    clk = FakeClock()
    rec = mod.Recorder(clock=clk)
    rec.gauge("modeled_unit_s", 2e-4, engine="lvrf")
    rec.gauge("modeled_unit_s", 1e-3, engine="lm")
    open_reqs = []
    for i in range(40):
        eng = str(rng.choice(["lvrf", "lm"]))
        cls = str(rng.choice(["interactive", "best_effort", "factorizer"]))
        sid = rec.begin("request", track="requests", cat="request",
                        args={"gid": i, "engine": eng, "class": cls})
        open_reqs.append((sid, eng))
        clk.tick(float(rng.random()) * 1e-3)
        if rng.random() < 0.7:
            with rec.span("ingest", track="runtime", cat="runtime"):
                clk.tick(float(rng.random()) * 1e-4)
                rec.instant("admit", track="requests", parent=sid,
                            cat="request")
                clk.tick(float(rng.random()) * 1e-4)
        if rng.random() < 0.1:
            fc = rec.begin("fault-cycle", track="supervisor",
                           cat="supervision", args={"engine": eng})
            clk.tick(float(rng.random()) * 1e-3)
            rec.end(fc, args={"outcome": "recovered"})
        if rng.random() < retune_rate:
            with rec.span("retune", track="supervisor", cat="supervision",
                          args={"engine": eng}):
                clk.tick(float(rng.random()) * 1e-3)
        name = str(rng.choice(["lvrf", "lm"]))
        with rec.span("dispatch", track="runtime", cat="runtime",
                      args={"engine": name}):
            with rec.span("step", track=name, cat="engine"):
                for ph in ("fill", "sweep-burst" if name == "lvrf"
                           else "decode-burst", "retire"):
                    with rec.span(ph, track=name, cat="engine",
                                  args={"sweeps": int(rng.integers(1, 9)),
                                        "decodes": 2}):
                        clk.tick(float(rng.random()) * 1e-3)
                if rng.random() < 0.05:
                    with rec.span("resize", track=name, cat="engine"):
                        clk.tick(1e-4)
                if rng.random() < 0.05:
                    with rec.span("recover", track=name, cat="engine"):
                        clk.tick(1e-4)
            clk.tick(float(rng.random()) * 1e-4)
        while open_reqs and rng.random() < 0.5:
            sid, _ = open_reqs.pop(int(rng.integers(len(open_reqs))))
            outcome = "ok" if rng.random() < 0.9 else "DeadlineExceededError"
            rec.end(sid, args={"outcome": outcome})
            if outcome == "ok":
                rec.observe("request_latency_s", float(rng.random()),
                            **{"class": "interactive"})
    for sid, _ in open_reqs:
        rec.end(sid, args={"outcome": "ok"})
    return rec


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_attribution_report_equals_the_reference(seed):
    """Equal reports on the same spans, as long as no request waits out
    another engine's re-tune (the one place the port parts, below)."""
    got = obs.attribution(_synthetic_store(obs, seed))
    want = robs.attribution(_synthetic_store(robs, seed))
    assert obs.render_json(got) == robs.render_json(want)
    assert obs.render_text(got) == robs.render_text(want)
    assert got["coverage"]["requests"] == 40
    assert got["coverage"]["min"] >= 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_slo_snapshot_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    targets = {"interactive": 0.05, "best_effort": 0.5}
    a = obs.SLOTracker(targets, window_cap=64)
    b = robs.SLOTracker(targets, window_cap=64)
    for _ in range(300):
        cls = str(rng.choice(["interactive", "best_effort", "other"]))
        ev = int(rng.integers(0, 6))
        for t in (a, b):
            t.on_submit(cls)
        lat = float(rng.exponential(0.05))
        for t in (a, b):
            if ev < 3:
                t.on_complete(cls, lat)
            elif ev == 3:
                t.on_deadline_miss(cls)
            elif ev == 4:
                t.on_rejected(cls)
            else:
                t.on_failure(cls)
        if rng.random() < 0.1:
            for t in (a, b):
                t.on_shed(cls)
    assert a.snapshot() == b.snapshot()


def test_another_engines_retune_is_cross_engine_time():
    """A request of engine a waiting while the stepper re-tunes engine b: the
    port attributes the re-tune to ``cross_engine`` (stepper work for
    another engine, as a foreign step is) where the reference leaves it
    unattributed in ``other``; a re-tune of the request's own engine is
    ``retune`` in both."""
    def store(mod):
        clk = FakeClock()
        rec = mod.Recorder(clock=clk)
        sid = _request(rec, clk, 1, "a")
        _admit(rec, sid)
        with rec.span("step", track="b", cat="engine"):
            clk.tick(1.0)
        with rec.span("retune", track="supervisor", cat="supervision",
                      args={"engine": "b"}):
            clk.tick(2.0)
        with rec.span("retune", track="supervisor", cat="supervision",
                      args={"engine": "a"}):
            clk.tick(0.5)
        with rec.span("step", track="a", cat="engine"):
            clk.tick(1.0)
        rec.end(sid, args={"outcome": "ok"})
        return rec

    got = obs.attribution(store(obs))["requests"][0]
    want = robs.attribution(store(robs))["requests"][0]
    assert got["phases"]["cross_engine"] == pytest.approx(3.0)
    assert got["phases"]["retune"] == pytest.approx(0.5)
    assert got["phases"]["other"] == pytest.approx(0.0)
    assert got["coverage"] == pytest.approx(1.0)
    assert want["phases"]["cross_engine"] == pytest.approx(1.0)
    assert want["phases"]["other"] == pytest.approx(2.0)
    assert want["coverage"] == pytest.approx(2.5 / 4.5)
    # with the foreign re-tunes in a seeded store, the reports part exactly
    # there: the port has no `other` time the reference does not
    for seed in (0, 1, 2):
        a = obs.attribution(_synthetic_store(obs, seed, retune_rate=0.2))
        b = robs.attribution(_synthetic_store(robs, seed, retune_rate=0.2))
        assert a["engines"] == b["engines"]
        for ra, rb in zip(a["requests"], b["requests"]):
            moved = ra["phases"].get("cross_engine", 0.0) - \
                rb["phases"].get("cross_engine", 0.0)
            assert moved >= -1e-12
            assert ra["phases"]["other"] == pytest.approx(
                rb["phases"]["other"] - moved, abs=1e-12)
