"""The readers of the program's spans inside an engine step against hand
counts: a step's self time under nested and overlapping children, kernel
launches joined to spans at their exact edges, bursts that cross the
trace's edge or end past its last recorded launch left out, the share of
launches outside every span, and None where a run recorded none of a
reader's spans."""
import types

import pytest

from perfbench.tests import common  # noqa: F401  (the port on the path)
from perfbench.bench import peaks, spans as sp, spec
from perfbench.bench.trace import DeviceOp


def span(sid, name, t0, t1, parent=None, **args):
    return types.SimpleNamespace(sid=sid, name=name, t0=t0, t1=t1,
                                 parent=parent, args=args)


def launch(t, name="k"):
    return DeviceOp(name, 0.0, 0.0, t)


def readings(**kw):
    """A stand-in for ``harness.Readings`` over a window [0, 10]."""
    win = types.SimpleNamespace(t0=0.0, t1=10.0, seconds=10.0, completed=4)
    base = dict(window=win, spans=[], ops=[], trace_window=None,
                peaks=peaks.H100, setup_s=12.5)
    base.update(kw)
    r = types.SimpleNamespace(**base)
    r.within = lambda spans, lo=None, hi=None: [
        s for s in spans if s.t0 >= (win.t0 if lo is None else lo)
        and s.t1 <= (win.t1 if hi is None else hi)]
    return r


def read(metric, r):
    return spec.load_module("metrics", metric).read(r)


def test_step_self_time_under_nested_and_overlapping_children():
    spans = [span(1, "step", 0.0, 4.0),
             span(2, "slot-scan", 0.5, 1.0, parent=1),
             span(3, "fill", 0.8, 1.5, parent=1),  # overlaps the scan
             span(4, "sweep-burst", 2.0, 3.0, parent=1, sweeps=2),
             span(5, "rng", 2.2, 2.4, parent=4),  # a grandchild
             span(6, "harness", 3.5, 3.8),  # another track: not nested
             span(7, "step", 8.0, 12.0),  # past the window's end
             span(8, "retire", 9.0, 11.0, parent=7)]
    assert sp.self_seconds(spans, "step", 0.0, 10.0) == pytest.approx(2.0 + 1.0)
    assert sp.self_seconds(spans, "step", 0.0, 100.0) == pytest.approx(2.0 + 2.0)
    r = readings(spans=spans)
    for cell in ("decode", "task"):
        assert read(f"engine.step_other_share.{cell}", r) == pytest.approx(30.0)
        assert read(f"engine.scan_share.{cell}", r) == pytest.approx(5.0)


def test_rng_ms_over_the_sweeps_of_the_bursts_that_hold_draws():
    spans = [span(1, "sweep-burst", 1.0, 2.0, sweeps=2),
             span(2, "rng", 1.1, 1.2, parent=1),
             span(3, "rng", 1.5, 1.6, parent=1),
             span(4, "sweep-burst", 3.0, 4.0, sweeps=3),  # draws nothing
             span(5, "sweep-burst", 9.5, 10.5, sweeps=1),  # past the window
             span(6, "rng", 9.6, 9.7, parent=5)]
    r = readings(spans=spans)
    assert read("sweep.rng_ms.decode", r) == pytest.approx(100.0)
    assert read("sweep.rng_ms.task", r) == pytest.approx(100.0)


def test_rng_launches_join_at_span_edges_and_skip_bursts_past_the_trace():
    spans = [span(1, "sweep-burst", 0.6, 3.0, sweeps=1),
             span(2, "rng", 1.0, 2.0, parent=1),
             span(3, "sweep-burst", 4.0, 5.0, sweeps=2),
             span(4, "rng", 4.1, 4.2, parent=3),
             span(5, "rng", 4.5, 4.6, parent=3),
             span(6, "sweep-burst", 7.5, 8.5, sweeps=1),  # crosses the edge
             span(7, "rng", 7.6, 7.7, parent=6)]
    ops = [launch(0.999), launch(1.0), launch(1.5), launch(2.0),  # [t0, t1)
           launch(1.6, "Memcpy DtoH (Device -> Pageable)"),  # not a kernel
           DeviceOp("k", 0.0, 0.0, None),  # no launch call recorded
           launch(4.15), launch(4.55), launch(4.58), launch(4.7),
           launch(7.65), launch(7.66)]
    r = readings(spans=spans, ops=ops, trace_window=(0.5, 8.0))
    assert sp.launches_in(sp.launch_times(r), [(1.0, 2.0)]) == 2
    assert [s.sid for s in sp.traced_bursts(r)] == [1, 3]
    assert read("sweep.rng_launches.decode", r) == pytest.approx((2 + 3) / 3)


def test_spans_past_the_last_recorded_launch_are_left_out():
    """A trace that lost the kernel records of its last launches: the burst
    they fell in, and the postprocess after it, are not counted."""
    spans = [span(1, "sweep-burst", 1.0, 2.0, sweeps=1),
             span(2, "rng", 1.1, 1.5, parent=1),
             span(3, "sweep-burst", 3.0, 4.0, sweeps=1),
             span(4, "rng", 3.1, 3.5, parent=3),
             span(5, "postprocess", 1.6, 1.9),
             span(6, "postprocess", 4.5, 4.8)]
    ops = [launch(1.2), launch(1.3), launch(1.4), launch(1.7), launch(3.2)]
    r = readings(spans=spans, ops=ops, trace_window=(0.5, 8.0))
    assert [s.sid for s in sp.recorded(r, "sweep-burst")] == [1]
    assert read("sweep.rng_launches.decode", r) == pytest.approx(3.0)
    assert read("nvsa.postprocess_launches", r) == pytest.approx(1.0)


def test_postprocess_time_and_launches_a_task():
    spans = [span(1, "retire", 0.9, 3.1),
             span(2, "postprocess", 1.0, 1.5, parent=1),
             span(3, "postprocess", 2.0, 3.0, parent=1),  # past the trace
             span(4, "postprocess", 10.5, 11.0)]  # past the window
    ops = [launch(1.1), launch(1.2), launch(1.5), launch(2.5)]
    r = readings(spans=spans, ops=ops, trace_window=(0.5, 2.8))
    assert read("nvsa.postprocess_ms", r) == pytest.approx(750.0)
    assert read("nvsa.postprocess_launches", r) == pytest.approx(2.0)


def test_unspanned_share_of_the_traced_launches():
    spans = [span(1, "step", 1.0, 2.0), span(2, "harness", 1.5, 3.0),
             span(3, "submit", 5.0, 6.0), span(4, "retire", 5.2, 5.4)]
    ops = [launch(0.7), launch(1.0), launch(2.5), launch(3.0), launch(4.0),
           launch(5.3), launch(9.0)]  # the last past the trace
    r = readings(spans=spans, ops=ops, trace_window=(0.5, 8.0))
    for cell in ("decode", "task"):
        assert read(f"device.unspanned_launches.{cell}", r) \
            == pytest.approx(100.0 * 3 / 6)


NEW = ("engine.scan_share.decode", "engine.step_other_share.decode",
       "sweep.rng_ms.decode", "sweep.rng_launches.decode",
       "nvsa.postprocess_ms", "nvsa.postprocess_launches",
       "device.unspanned_launches.decode")


@pytest.mark.parametrize("metric", NEW)
def test_none_where_the_spans_are_absent(metric):
    assert read(metric, readings()) is None
    # a traced run of a program without the new spans: steps, bursts and
    # launches, no slot-scan, rng or postprocess
    old = [span(1, "sweep-burst", 1.0, 2.0, sweeps=2)]
    r = readings(spans=old, ops=[launch(1.5)], trace_window=(0.5, 8.0))
    if metric in ("engine.step_other_share.decode",
                  "device.unspanned_launches.decode"):
        return  # they read the spans every version records
    assert read(metric, r) is None
