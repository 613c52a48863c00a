"""Milliseconds a task in the abduction tail: the Engine's ``postprocess``
spans (one a finished task, in ``Engine._finalize``) inside the window,
over their number."""
from perfbench.bench import spans


def read(r):
    post = spans.named(r.within(r.spans), "postprocess")
    if not post:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in post) / len(post)
