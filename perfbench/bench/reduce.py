"""Arithmetic from requests, spans and device intervals to metrics."""
from __future__ import annotations

import numpy as np


def percentile(values, q: float) -> float:
    """The q-th percentile of every value (numpy's linear interpolation
    between order statistics), not a statistic of chunks."""
    v = np.asarray(values, dtype=np.float64)
    if v.size == 0:
        raise ValueError("percentile of no values")
    return float(np.percentile(v, q))


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``(start, end)`` intervals clipped to
    ``[lo, hi]``."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The ``(start, end)`` stretches of ``[lo, hi]`` that no interval
    covers, in time order."""
    out, t = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def spans_seconds(spans, names, lo: float, hi: float) -> float:
    """Seconds of ``[lo, hi]`` inside spans named in ``names`` (the union, so
    nested or overlapping spans count once)."""
    return union_seconds([(s.t0, s.t1) for s in spans if s.name in names],
                         lo, hi)


def innermost(spans, times) -> list:
    """For each of ``times`` (ascending) the name of the shortest span open
    then, or None."""
    order = sorted(spans, key=lambda s: s.t0)
    open_, out, i = [], [], 0
    for t in times:
        while i < len(order) and order[i].t0 <= t:
            open_.append(order[i])
            i += 1
        open_ = [s for s in open_ if s.t1 > t]
        best = min(open_, key=lambda s: s.t1 - s.t0, default=None)
        out.append(None if best is None else best.name)
    return out


def top(pairs, k: int = 10) -> list:
    """The ``k`` largest ``[name, seconds]`` totals of ``(name, seconds)``
    pairs, largest first."""
    acc: dict = {}
    for name, sec in pairs:
        acc[name] = acc.get(name, 0.0) + sec
    return [[n, s] for n, s in sorted(acc.items(), key=lambda x: -x[1])[:k]]


def latencies_ms(records: dict) -> np.ndarray:
    """Submit-to-retire latency of each request, as the harness timed it."""
    return (records["t_retire"] - records["t_submit"]) * 1e3


def window_share(r, names) -> float | None:
    """Percent of a run's window inside spans named in ``names``; None where
    the run recorded no such span."""
    if not any(s.name in names for s in r.spans):
        return None
    w = r.window
    return 100.0 * spans_seconds(r.spans, names, w.t0, w.t1) / w.seconds


def per_sweep_ms(r, names) -> float | None:
    """Milliseconds a sweep inside the window's spans named in ``names``,
    each carrying the sweeps it ran in ``args["sweeps"]``."""
    spans = [s for s in r.within(r.spans) if s.name in names
             and s.args.get("sweeps")]
    sweeps = sum(s.args["sweeps"] for s in spans)
    if not sweeps:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in spans) / sweeps


def idle_percent(r) -> float | None:
    """Percent of the traced stretch in which no operation ran on the
    device."""
    if r.trace_window is None or not r.ops:
        return None
    lo, hi = r.trace_window
    busy = union_seconds([(o.t0, o.t1) for o in r.ops], lo, hi)
    return 100.0 * (1.0 - busy / (hi - lo))


def sweep_mfu(r) -> float | None:
    """Percent of the fp32 peak that the window's matrix work of the
    factorizer is: the sweeps each retired row needed times a row-sweep's
    FLOPs, over the window's seconds."""
    rec = r.records
    if r.peaks is None or not len(rec["i"]):
        return None
    flops = float(rec["iterations"].sum()) * r.system.row_flops
    return 100.0 * flops / (r.window.seconds * r.peaks["fp32_flops"])
