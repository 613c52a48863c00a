"""Percent of the traced stretch's kernel launches whose launch call lies
outside every span, the program's or the harness's: launches no span
names, or a device clock that disagrees with the host's."""
from perfbench.bench import spans


def read(r):
    return spans.unspanned_percent(r)
