"""Readings of the spans the program records inside an engine step, and of
the kernels launched inside them.

A span's children are the spans whose ``parent`` is its id (the program's
spans nest on their track).  A kernel belongs to a span when the host call
that launched it began at or after the span's start and before its end, on
the run's clock (``DeviceOp.launched``).  Every reading is None where the
run recorded none of the spans it reads.
"""
from __future__ import annotations

import bisect

from perfbench.bench import reduce, trace


def named(spans, name: str) -> list:
    return [s for s in spans if s.name == name]


def children(spans, parents, name: str) -> list:
    """Spans named ``name`` whose parent is one of ``parents``."""
    ids = {p.sid for p in parents}
    return [s for s in spans if s.name == name and s.parent in ids]


def self_seconds(spans, name: str, lo: float, hi: float) -> float:
    """Seconds of ``[lo, hi]`` inside spans named ``name`` and outside every
    child of theirs (their self time; children that overlap count once)."""
    kids: dict = {}
    for s in spans:
        kids.setdefault(s.parent, []).append((s.t0, s.t1))
    total = 0.0
    for s in named(spans, name):
        a, b = max(s.t0, lo), min(s.t1, hi)
        if b > a:
            total += (b - a) - reduce.union_seconds(kids.get(s.sid, []), a, b)
    return total


def launch_times(r) -> list:
    """Sorted host times of the kernel launches the device trace recorded."""
    return sorted(o.launched for o in r.ops
                  if trace.is_kernel(o) and o.launched is not None)


def launches_in(launched, intervals) -> int:
    """Launches (sorted times) at or after each ``(t0, t1)``'s start and
    before its end, summed over the intervals."""
    return sum(bisect.bisect_left(launched, t1) - bisect.bisect_left(launched, t0)
               for t0, t1 in intervals)


def recorded(r, name: str) -> list:
    """Spans named ``name`` wholly inside the stretch whose kernels the
    device trace holds: inside the traced stretch, and ending before the
    last kernel launch it recorded.  Some runs lose the kernel records of
    the trace's last tens of milliseconds (their launch calls are recorded,
    the kernels not), so a span there would count too few launches."""
    launched = launch_times(r)
    if r.trace_window is None or not launched:
        return []
    lo, hi = r.trace_window
    return named(r.within(r.spans, lo, min(hi, launched[-1])), name)


def window_bursts(r) -> list:
    """The ``sweep-burst`` spans inside the window that ran sweeps."""
    return [s for s in named(r.within(r.spans), "sweep-burst")
            if s.args.get("sweeps")]


def traced_bursts(r) -> list:
    """The ``sweep-burst`` spans that ran sweeps, of those :func:`recorded`
    holds (``sweep.launches.decode`` takes every burst inside the traced
    stretch)."""
    return [s for s in recorded(r, "sweep-burst") if s.args.get("sweeps")]


def per_sweep(spans, bursts, name: str) -> tuple:
    """``(spans named name nested in bursts, the sweeps of the bursts that
    hold them)``."""
    inner = children(spans, bursts, name)
    holding = {s.parent for s in inner}
    return inner, sum(b.args["sweeps"] for b in bursts if b.sid in holding)


def unspanned_percent(r) -> float | None:
    """Percent of the traced stretch's kernel launches whose launch time
    lies outside every recorded span."""
    if r.trace_window is None or not r.spans:
        return None
    lo, hi = r.trace_window
    launched = [t for t in launch_times(r) if lo <= t <= hi]
    if not launched:
        return None
    gaps = reduce.gaps([(s.t0, s.t1) for s in r.spans], lo, hi)
    starts = [a for a, _ in gaps]
    outside = 0
    for t in launched:
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and t < gaps[k][1]:
            outside += 1
    return 100.0 * outside / len(launched)
