"""The metric arithmetic against hand counts: percentiles over every
request, the union of device intervals, idle gaps and their labels, span
shares, the roofline's bytes and operations, and mfu's FLOPs."""
import types

import numpy as np
import pytest

from perfbench.tests import common  # noqa: F401  (the port on the path)
from perfbench.bench import counts, peaks, reduce, spec
from perfbench.bench.trace import DeviceOp, short_name


def span(name, t0, t1, **args):
    return types.SimpleNamespace(name=name, t0=t0, t1=t1, args=args)


def test_p95_is_over_every_value_not_chunks():
    v = np.arange(1, 101, dtype=float)  # 1..100
    assert reduce.percentile(v, 95) == pytest.approx(95.05)  # 95 + 0.05 (linear)
    chunks = [reduce.percentile(v[i:i + 10], 95) for i in range(0, 100, 10)]
    assert reduce.percentile(v, 95) != pytest.approx(np.median(chunks))
    with pytest.raises(ValueError):
        reduce.percentile([], 95)


def test_union_and_gaps_by_hand():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (10.0, 11.0)]
    assert reduce.union_seconds(iv, 0.0, 5.0) == pytest.approx(3.0)
    assert reduce.union_seconds(iv, 0.5, 3.5) == pytest.approx(2.0)
    assert reduce.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert reduce.gaps([], 1.0, 2.0) == [(1.0, 2.0)]


def test_innermost_span_labels_a_time():
    spans = [span("step", 0, 10), span("retire", 6, 9), span("tail", 7, 8)]
    assert reduce.innermost(spans, [1, 6.5, 7.5, 9.5, 11]) == [
        "step", "retire", "tail", "step", None]


def test_top_sums_by_name():
    assert reduce.top([("a", 1.0), ("b", 3.0), ("a", 2.5)], 1) == [["a", 3.5]]


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


def test_window_share_and_per_sweep():
    spans = [span("fill", 1, 2), span("retire", 1.5, 3), span("submit", 9, 11),
             span("sweep-burst", 3, 4, sweeps=8), span("sweep-burst", 5, 7, sweeps=2)]
    r = readings(spans=spans)
    assert reduce.window_share(r, {"fill", "retire", "submit"}) == pytest.approx(30.0)
    assert reduce.window_share(r, {"tail"}) is None
    assert reduce.per_sweep_ms(r, {"sweep-burst"}) == pytest.approx(300.0)
    host = spec.load_module("metrics", "engine.host_share.decode")
    assert host.read(r) == pytest.approx(30.0)
    r.spans.append(span("tail", 2, 2.5))
    assert spec.load_module("metrics", "engine.host_share.task").read(r) \
        == pytest.approx(25.0)


def test_idle_share_by_hand():
    ops = [DeviceOp("k", 1.0, 2.0, None), DeviceOp("k", 1.5, 3.0, None)]
    r = readings(ops=ops, trace_window=(0.0, 4.0))
    assert reduce.idle_percent(r) == pytest.approx(50.0)
    assert spec.load_module("metrics", "device.idle.decode").read(r) \
        == pytest.approx(50.0)
    assert reduce.idle_percent(readings()) is None


def test_similarity_int8_counts_by_hand():
    c = counts.similarity_int8(256, 10, 1024)
    assert c["flops"] == 2 * 256 * 10 * 1024
    # q fp32 once, codebook int8 once, one fp32 scale a row, scores fp32
    assert c["bytes"] == 256 * 1024 * 4 + 10 * 1024 + 10 * 4 + 256 * 10 * 4
    t = counts.roofline_seconds(c, peaks.H100)
    assert t == pytest.approx(c["bytes"] / 3.35e12)  # bound by bytes


def test_roofline_reader_divides_least_time_by_kernel_time():
    c = counts.similarity_int8(256, 10, 1024)
    least = counts.roofline_seconds(c, peaks.H100)
    ops = [DeviceOp("similarity_int8_kernel<4, 10>", 0.0, 2 * least, None),
           DeviceOp("similarity_int8_kernel<4, 10>", 1.0, 1.0 + 2 * least, None),
           DeviceOp("other", 0.0, 1.0, None)]
    cell = types.SimpleNamespace(config={"codebook_size": 10, "dim": 1024},
                                 traffic={"slots": 256})
    r = readings(ops=ops, trace_window=(0.0, 2.0), cell=cell)
    got = spec.load_module("metrics", "similarity_int8_roofline").read(r)
    assert got == pytest.approx(50.0)
    r.peaks = None  # no share of a peak where no peak is known
    assert spec.load_module("metrics", "similarity_int8_roofline").read(r) is None


def test_mfu_flops_by_hand():
    F, M, D = 4, 10, 1024
    assert counts.row_sweep_flops(F, M, D) == 4 * F * M * D
    rec = {"i": np.arange(4), "iterations": np.array([[2], [3], [5], [10]])}
    r = readings(records=rec,
                 system=types.SimpleNamespace(row_flops=4 * F * M * D))
    want = 100.0 * 20 * 4 * F * M * D / (10.0 * 67e12)
    assert reduce.sweep_mfu(r) == pytest.approx(want)
    assert spec.load_module("metrics", "sweep.mfu.decode").read(r) == \
        pytest.approx(want)


def test_launches_a_sweep_count_launch_calls_inside_bursts():
    spans = [span("sweep-burst", 1.0, 2.0, sweeps=2),
             span("sweep-burst", 3.0, 4.0, sweeps=1),
             span("sweep-burst", 9.0, 12.0, sweeps=5)]  # past the trace
    ops = ([DeviceOp("k", 0, 0, 1.0 + 0.1 * j) for j in range(6)]
           + [DeviceOp("k", 0, 0, 3.5), DeviceOp("k", 0, 0, 3.6),
              DeviceOp("k", 0, 0, 3.7), DeviceOp("Memcpy HtoD", 0, 0, 3.8),
              DeviceOp("k", 0, 0, 2.5)])
    r = readings(spans=spans, ops=ops, trace_window=(0.5, 8.0))
    got = spec.load_module("metrics", "sweep.launches.decode").read(r)
    assert got == pytest.approx(9 / 3)


def test_latency_readers_use_the_harness_times():
    rec = {"i": np.arange(4), "t_submit": np.array([0.0, 1.0, 2.0, 3.0]),
           "t_retire": np.array([0.1, 1.3, 2.2, 4.0])}
    r = readings(records=rec)
    lat = [100.0, 300.0, 200.0, 1000.0]
    got = spec.load_module("metrics", "engine.latency_p95_ms.decode").read(r)
    assert got == pytest.approx(np.percentile(lat, 95))
    assert spec.load_module("metrics", "decodes_per_s").read(r) == 0.4
    assert spec.load_module("metrics", "setup_s").read(r) == 12.5


def test_short_name_drops_the_plumbing():
    n = ("void at::native::vectorized_elementwise_kernel<4, at::native::"
         "BinaryFunctor<float, float, float, at::native::binary_internal::"
         "MulFunctor<float> >, std::array<char*, 3ul> >(int)")
    assert short_name(n).startswith("vectorized_elementwise_kernel<4, "
                                    "BinaryFunctor<float, float, float, MulFunctor")
