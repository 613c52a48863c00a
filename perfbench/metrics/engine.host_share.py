"""Percent of the window the host spends in the engine's own work between
sweeps: the Engine's fill and retire spans (its ``obs`` spans) and the
harness's spans around ``Engine.submit``, less the abduction tail that runs
inside retire (``nvsa.tail_share`` reads that)."""
from perfbench.bench import reduce


def read(r):
    if not any(s.name == "retire" for s in r.spans):
        return None
    return reduce.window_share(r, {"fill", "retire", "submit"}) - (
        reduce.window_share(r, {"tail"}) or 0.0)
