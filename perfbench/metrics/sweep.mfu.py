"""Percent of the card's fp32 peak (67 TFLOP/s) done as the factorizer's
matrix work: the sweeps each row retired in the window reported needing,
times 4 F M D FLOPs a row-sweep (scores and projection), over the window."""
from perfbench.bench import reduce


def read(r):
    return reduce.sweep_mfu(r)
