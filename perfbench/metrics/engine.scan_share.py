"""Percent of the window the Engine spends in its slot scan: the
``slot-scan`` spans of ``Engine._fill`` (the loop over every slot and each
``_pop_next`` over the queue), which close before the device refill."""
from perfbench.bench import reduce


def read(r):
    return reduce.window_share(r, {"slot-scan"})
