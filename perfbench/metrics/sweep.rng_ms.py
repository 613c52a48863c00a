"""Milliseconds a sweep in the noise draws: the ``rng`` spans nested in the
window's sweep-burst spans, over the sweeps of the bursts that hold them."""
from perfbench.bench import spans


def read(r):
    draws, sweeps = spans.per_sweep(r.spans, spans.window_bursts(r), "rng")
    if not sweeps:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in draws) / sweeps
