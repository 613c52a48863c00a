"""Milliseconds an output token after those of the first engine step: the
median, over the requests retired inside the window in a later step than
the one that admitted them, of (retire - end of the admitting step) over
the output tokens produced after that step, host clock.  A request that
retires in the step that admitted it has no such token."""
import numpy as np


def read(r):
    w = r.window
    rec = r.records
    later = rec["step_retire"] > rec["step_first"]
    if not later.any():
        return None
    before = np.minimum(rec["iterations"],
                        np.asarray(w.decodes)[rec["step_first"]])
    n = (rec["iterations"] - before).astype(np.float64)
    keep = later & (n > 0)
    if not keep.any():
        return None
    per = (rec["t_retire"][keep] - rec["t_first"][keep]) / n[keep]
    return 1e3 * float(np.median(per))
