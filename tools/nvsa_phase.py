#!/usr/bin/env python3
"""NVSA abduction on one card, alone: ``chip_smoke.py``'s phase 5 (the
masked sweep at D = 2048) and phase 23 (the masked sweep at NVSA's D = 1024,
the oracle cell, the image path, the bipolar fused variant and the
adSCH-planned stream), without the other phases.

Run from the root of a checkout on a machine with an NVIDIA GPU and the CUDA
toolkit:  ``python3 tools/nvsa_phase.py``.  It builds the checkout's kernels,
runs the two phases (each raises on a failed check) and prints as its last
line one JSON object: the masked kernel's times at both widths and phase
23's end-to-end numbers.
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
        print("nvsa_phase: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.device import disable_tf32
    from repro_torch.kernels import _build
    from repro_torch.kernels.resonator_step import ops as rs
    from repro_torch.kernels.resonator_step import ref

    disable_tf32()
    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    d2048 = cs.phase_timing(torch, dev, rs, ref, card)
    d1024 = cs.phase_nvsa_kernel(torch, dev, rs, ref, card)
    cell = cs.phase_nvsa(torch, dev, rs, card)
    print(json.dumps({"card": card,
                      "d2048": d2048["resonator_step_batch_masked"],
                      "d1024": d1024, **cell}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
