"""95th percentile of time to first token over the requests submitted and
admitted inside the window: from the harness's submit to the end of the
engine step whose fill admitted the request (its decode burst produced the
first token), host clock.  Requests admitted after the close are left
out: in a traced run their wait holds the device trace's collection."""
from perfbench.bench import reduce


def read(r):
    w = r.window
    c = w.book.view()
    inside = (c["t_submit"] >= w.t0) & (c["t_first"] <= w.t1)
    if not inside.any():
        return None
    return reduce.percentile(
        (c["t_first"][inside] - c["t_submit"][inside]) * 1e3, 95)
