"""Percent of the card's bf16 peak (989 TFLOP/s) that the window's model
work is: the FLOPs of what the window's engine steps served
(``lm_counts.window_flops``: the prompts their fills prefilled and the
positions that produced their output tokens, each through the layers'
matrices, causal attention over its context and, where it samples, the
head), over the window's seconds."""
from perfbench.bench import lm_counts


def read(r):
    w = r.window
    c = w.book.view()
    if r.peaks is None or not len(c["i"]):
        return None
    lo, hi = w.window_steps
    flops = lm_counts.window_flops(r.cell.config, w.decodes, c["step_first"],
                                   c["step_retire"], c["prompt_len"],
                                   c["iterations"], lo, hi)
    return 100.0 * flops / (w.seconds * r.peaks["bf16_flops"]) if flops else None
