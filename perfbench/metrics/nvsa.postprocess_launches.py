"""Device kernels a task's abduction tail launches: kernels whose launch call
the profiler saw inside the Engine's ``postprocess`` spans, over those
spans; only spans wholly inside the stretch whose kernels the trace
recorded count (``spans.recorded``)."""
from perfbench.bench import spans


def read(r):
    post = spans.recorded(r, "postprocess")
    if not post:
        return None
    return spans.launches_in(spans.launch_times(r),
                             [(s.t0, s.t1) for s in post]) / len(post)
