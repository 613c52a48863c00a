"""Percent of its roofline that ``flash_decode`` reaches in a model with
sliding-window layers: as ``flash_decode_roofline``, for the engine steps
wholly inside the traced stretch, each launch's least time over the
kernel's device time, but each layer's bytes at its own window
(``moe_counts.flash_decode_window``: a sliding layer's rows read at
``min(len, window)`` positions, a full layer's at ``len``).  A step's
launches are one a layer and decode step, in layer order; a step whose
launch count differs (the trace lost kernel records) is left out."""
import bisect

from perfbench.bench import counts, moe_counts


def read(r):
    steps = getattr(r.window, "steps", None)
    if r.peaks is None or r.trace_window is None or not steps:
        return None
    ops = sorted((o for o in r.ops if "flash_decode" in o.name
                  and o.launched is not None), key=lambda o: o.launched)
    at = [o.launched for o in ops]
    c, bs = r.cell.config, int(r.cell.traffic["block_size"])
    wins = moe_counts.windows(c)
    lo, hi = r.trace_window
    least = busy = 0.0
    for t0, t1, n, lens in steps:
        a, b = bisect.bisect_left(at, t0), bisect.bisect_left(at, t1)
        if not n or t0 < lo or t1 > hi or b - a != len(wins) * n:
            continue
        for j in range(n):
            for w in wins:
                one = moe_counts.flash_decode_window(lens + j + 1, w, c, bs)
                least += counts.roofline_seconds(one, r.peaks)
        busy += sum(o.t1 - o.t0 for o in ops[a:b])
    return 100.0 * least / busy if busy else None
