#!/usr/bin/env python3
"""Training the paper's workloads on one card, alone: ``chip_smoke.py``'s
phase 25 (the NVSA/PrAE frontend trained for 4000 steps and served through
PrAE, the engine's image path and the bipolar fused sweep; MIMONet trained
at S = 1, 2, 4 and served through circconv_rows), without the other phases.

Run from the root of a checkout on a machine with an NVIDIA GPU and the CUDA
toolkit:  ``python3 tools/train_phase.py``.  It builds the checkout's kernels,
runs the phase (which raises on a failed check) and prints as its last line
one JSON object of the phase's figures.
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
        print("train_phase: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.device import disable_tf32
    from repro_torch.kernels import _build
    from repro_torch.kernels.circconv import ops as cc
    from repro_torch.kernels.resonator_step import ops as rs

    disable_tf32()
    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    out = cs.phase_train(torch, dev, rs, cc, card)
    print(json.dumps({"card": card, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
