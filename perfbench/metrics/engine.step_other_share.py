"""Percent of the window inside the Engine's ``step`` spans and outside
every span nested in them: the step's self time, host work that no span
of the program names."""
from perfbench.bench import spans


def read(r):
    if not spans.named(r.spans, "step"):
        return None
    w = r.window
    return 100.0 * spans.self_seconds(r.spans, "step", w.t0, w.t1) / w.seconds
