"""Shared set-up of the benchmark's tests: the port on the path, and cells
cut to sizes a CPU test can run (widths as published; slots, clients,
pools and samples small, the factorization's samples large enough that
their statistics, the converged share and the mean sweeps, read as they do
at the cells' own sizes)."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from perfbench.bench import spec  # noqa: E402

SMALL = {
    "tab7-int8.closed-4096": dict(slots=32, clients=32, warm_retired=32,
                                  pool=1024, sample=256, sample_slowest=4),
    "tab7-int8.closed-256": dict(slots=16, clients=16, warm_retired=16,
                                 pool=1024, sample=256, sample_slowest=4),
    "nvsa-raven.serve-256": dict(slots=32, clients=4, warm_retired=4, pool=16,
                                 sample=6, sample_slowest=2),
}


def small_cell(name: str) -> spec.Cell:
    cell = spec.cell(name)
    cell.traffic.update(SMALL[name])
    return cell
