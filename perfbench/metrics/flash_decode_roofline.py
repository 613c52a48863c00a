"""Percent of its roofline that ``flash_decode`` reaches: for the engine
steps wholly inside the traced stretch, each launch's least time
(``lm_counts.flash_decode``: every live slot's K and V read once at its
length, at 3.35 TB/s) over the kernel's device time.  A step's launches
are those whose launch call lies inside it, one a layer and decode step;
the slots' lengths come from the generator's record of the step
(``Window.steps``).  A step whose launch count differs (the trace lost
kernel records) is left out."""
import bisect

from perfbench.bench import counts, lm_counts


def read(r):
    steps = getattr(r.window, "steps", None)
    if r.peaks is None or r.trace_window is None or not steps:
        return None
    ops = sorted((o for o in r.ops if "flash_decode" in o.name
                  and o.launched is not None), key=lambda o: o.launched)
    at = [o.launched for o in ops]
    c, bs = r.cell.config, int(r.cell.traffic["block_size"])
    layers, G = c["n_layers"], c["n_kv_heads"]
    quantized = c["kv_cache_dtype"] == "int8"
    lo, hi = r.trace_window
    least = busy = 0.0
    for t0, t1, n, lens in steps:
        a, b = bisect.bisect_left(at, t0), bisect.bisect_left(at, t1)
        if not n or t0 < lo or t1 > hi or b - a != layers * n:
            continue
        for j in range(n):
            one = lm_counts.flash_decode(lens + j + 1, G, c["n_heads"] // G,
                                         c["head_dim"], quantized, bs)
            least += layers * counts.roofline_seconds(one, r.peaks)
        busy += sum(o.t1 - o.t0 for o in ops[a:b])
    return 100.0 * least / busy if busy else None
