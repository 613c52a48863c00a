"""Tokens per second that the engine served: the prompt tokens it prefilled
and the output tokens it produced in the window's steps, for the requests
the run retired (inside the window or in the drain), over the window's
seconds (host clock).  A prompt counts in the step whose fill admitted it;
an output token in the step that produced it, each request's up to its
``max_new_tokens`` as ``LMEngine`` trims them (a decode burst's overshoot is
not counted), since a request lives longer than the window."""
from perfbench.bench import lm_counts


def read(r):
    w = r.window
    c = w.book.view()
    lo, hi = w.window_steps
    out = lm_counts.tokens_in_steps(w.decodes, c["step_first"],
                                    c["step_retire"], c["iterations"], lo, hi)
    return (out + lm_counts.prompt_tokens_in_steps(
        c["step_first"], c["prompt_len"], lo, hi)) / w.seconds
