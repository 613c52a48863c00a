"""Percent of the window inside ``ServeEngine``'s ``prefill-chunk`` spans:
the chunked prefill of the prompts that ``LMEngine``'s fill admits."""
from perfbench.bench import reduce


def read(r):
    return reduce.window_share(r, {"prefill-chunk"})
