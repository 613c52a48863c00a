#!/usr/bin/env python3
"""Distribution and modelling on one card, alone: ``chip_smoke.py``'s
phase 32 (Llama 3.2 3B's blocks as a 4-stage pipeline on logical stages
of the card, bitwise against ``sequential_apply``; the roofline bounds of
its prefill, decode and train steps against the steps timed on the card),
without the other phases.  It builds no kernel: the phase launches none.

Run from the root of a checkout on a machine with an NVIDIA GPU:
``python3 tools/dist_phase.py``.  Each part raises on a failed check; the
last line is one JSON object of its figures.
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
        print("dist_phase: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.device import disable_tf32

    disable_tf32()
    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    out = cs.phase_dist(torch, dev, card)
    print(json.dumps({"card": card, "seconds": time.perf_counter() - t0,
                      **out}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
