"""Percent of their roofline that the MoE's grouped expert products reach:
for the ``moe`` spans wholly inside the traced stretch, each call's least
time (``moe_counts.grouped_products``: the three bf16 matrices of every
expert the call's device record says received a token, and the routed rows
in and out, at 3.35 TB/s; or its FLOPs at the bf16 peak, the longer) over
the device time of the grouped-product kernels launched inside the span
(PyTorch's grouped GEMM, ``GroupProblemShape`` in its name, and the kernel
that prepares its problem list).  The record is the engine's
``moe_stats`` (one row a call, read after the window), the span's ``call``
its row, and its ``tokens`` the tokens the call routed.  A span whose
grouped products are not three (the trace lost kernel records) is left
out."""
import bisect

from perfbench.bench import counts, moe_counts, spans, trace


def grouped(name: str) -> bool:
    return "GroupProblemShape" in name or "grouped_gemm" in name


def read(r):
    stats = getattr(r.system, "moe_stats", None)
    if r.peaks is None or stats is None:
        return None
    calls = [s for s in spans.recorded(r, "moe") if "call" in s.args]
    ops = sorted((o for o in r.ops if trace.is_kernel(o) and grouped(o.name)
                  and o.launched is not None), key=lambda o: o.launched)
    if not calls or not ops:
        return None
    at = [o.launched for o in ops]
    first = min(s.args["call"] for s in calls)
    rows = stats.rows(first, max(s.args["call"] for s in calls) + 1)
    least = busy = 0.0
    for s in calls:
        a, b = bisect.bisect_left(at, s.t0), bisect.bisect_left(at, s.t1)
        if sum("GroupProblemShape" in o.name for o in ops[a:b]) != 3:
            continue
        experts = int(rows[s.args["call"] - first, 0])
        one = moe_counts.grouped_products(experts, s.args["tokens"],
                                          r.cell.config)
        least += counts.roofline_seconds(one, r.peaks)
        busy += sum(o.t1 - o.t0 for o in ops[a:b])
    return 100.0 * least / busy if busy else None
