"""Device kernels a sweep in the noise draws: kernels whose launch call the
profiler saw inside ``rng`` spans, over the sweeps of the sweep-burst spans
that hold them; only bursts wholly inside the stretch whose kernels the
trace recorded count (``spans.recorded``)."""
from perfbench.bench import spans


def read(r):
    draws, sweeps = spans.per_sweep(r.spans, spans.traced_bursts(r), "rng")
    if not sweeps:
        return None
    return spans.launches_in(spans.launch_times(r),
                             [(s.t0, s.t1) for s in draws]) / sweeps
