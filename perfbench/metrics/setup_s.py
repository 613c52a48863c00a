"""Seconds from the process's start to the window's first timed request:
imports, inputs, the kernels' build or load, the engine and the warm-up."""


def read(r):
    return r.setup_s
