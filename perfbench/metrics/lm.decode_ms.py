"""Milliseconds a decode step: ``LMEngine``'s ``decode-burst`` spans inside
the window (each ends on the host's read of its last step's tokens) over
the decode steps they ran (their ``decodes`` argument)."""
from perfbench.bench import spans


def read(r):
    bursts = [s for s in spans.named(r.within(r.spans), "decode-burst")
              if s.args.get("decodes")]
    n = sum(s.args["decodes"] for s in bursts)
    if not n:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in bursts) / n
