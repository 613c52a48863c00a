"""Percent of the device's busy time in the traced stretch that kernels
launched inside the program's ``moe`` spans (each layer's MoE half of a
prefill chunk or a decode step) take: the union of those kernels' device
intervals over the union of every operation's, both within the stretch.
None where the run recorded no ``moe`` span or no device trace."""
import bisect

from perfbench.bench import reduce, spans


def read(r):
    moe = sorted((s.t0, s.t1) for s in spans.named(r.spans, "moe"))
    if r.trace_window is None or not r.ops or not moe:
        return None
    lo, hi = r.trace_window
    starts = [a for a, _ in moe]
    inside = []
    for o in r.ops:
        if o.launched is None:
            continue
        k = bisect.bisect_right(starts, o.launched) - 1
        if k >= 0 and o.launched < moe[k][1]:
            inside.append((o.t0, o.t1))
    busy = reduce.union_seconds([(o.t0, o.t1) for o in r.ops], lo, hi)
    if not busy:
        return None
    return 100.0 * reduce.union_seconds(inside, lo, hi) / busy
