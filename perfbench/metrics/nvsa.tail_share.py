"""Percent of the window in the abduction tail: the harness's span around
the nvsa_abduction postprocess, which the Engine runs in its retire."""
from perfbench.bench import reduce


def read(r):
    return reduce.window_share(r, {"tail"})
