"""Percent of the traced stretch in which no operation ran on the device:
1 minus the union of the profiler's GPU operation intervals."""
from perfbench.bench import reduce


def read(r):
    return reduce.idle_percent(r)
