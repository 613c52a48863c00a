"""Device kernels a sweep: kernels whose launch call the profiler saw inside
the Engine's sweep-burst spans, over the sweeps those spans ran; only spans
wholly inside the traced stretch count."""
from perfbench.bench import trace


def read(r):
    if r.trace_window is None:
        return None
    lo, hi = r.trace_window
    bursts = sorted((s.t0, s.t1, s.args.get("sweeps", 0))
                    for s in r.within(r.spans, lo, hi) if s.name == "sweep-burst")
    sweeps = sum(b[2] for b in bursts)
    launched = sorted(o.launched for o in r.ops
                      if trace.is_kernel(o) and o.launched is not None)
    if not sweeps or not launched:
        return None
    import bisect

    n = sum(bisect.bisect_left(launched, t1) - bisect.bisect_left(launched, t0)
            for t0, t1, _ in bursts)
    return n / sweeps
