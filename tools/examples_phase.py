#!/usr/bin/env python3
"""The six user examples on one card, alone: ``chip_smoke.py``'s phase 33
(``examples/torch_{quickstart,lvrf_ood,engine_serving,runtime_serving,
fleet_overload,tracing}.py`` run as a user runs them, the two runtime
examples contiguous and paged, every kernel launch counted), without the
other phases.

Run from the root of a checkout on a machine with an NVIDIA GPU and the CUDA
toolkit:  ``python3 tools/examples_phase.py``.  It builds the checkout's
kernels first (so that no nvcc build runs on the runtime's stepper thread),
runs the phase (it raises on a failed check) and prints as its last line
one JSON object with each example's wall and kernel launches.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("examples_phase: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.device import disable_tf32
    from repro_torch.kernels import _build
    from repro_torch.kernels.circconv import ops as cc
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.resonator_step import ops as rs
    from repro_torch.kernels.similarity import ops as sim

    disable_tf32()
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    out = cs.phase_examples(torch, rs, sim, fd, cc, card)
    print(json.dumps({"card": card, "phase_s": time.perf_counter() - t0,
                      **{k: {"wall_s": v["wall_s"],
                             "launches": v["launches"]}
                         for k, v in out.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
