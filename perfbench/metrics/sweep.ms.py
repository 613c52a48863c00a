"""Milliseconds a resonator sweep: the Engine's sweep-burst spans (each
ends on the host sync of its last sweep) over the sweeps they ran."""
from perfbench.bench import reduce


def read(r):
    return reduce.per_sweep_ms(r, {"sweep-burst"})
