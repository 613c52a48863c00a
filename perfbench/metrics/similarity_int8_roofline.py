"""Percent of its roofline that ``similarity_int8`` reaches: each launch's
least time (its bytes at 3.35 TB/s or its fp32 FLOPs at 67 TFLOP/s, the
longer; ``counts.similarity_int8`` at the engine's slots) over the kernel's
device time in the trace."""
from perfbench.bench import counts


def read(r):
    ops = [o for o in r.ops if "similarity_int8" in o.name]
    if not ops or r.peaks is None:
        return None
    c = r.cell.config
    one = counts.similarity_int8(int(r.cell.traffic["slots"]),
                                 c["codebook_size"], c["dim"])
    least = len(ops) * counts.roofline_seconds(one, r.peaks)
    return 100.0 * least / sum(o.t1 - o.t0 for o in ops)
