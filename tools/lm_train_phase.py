#!/usr/bin/env python3
"""LM training on one card, alone: ``chip_smoke.py``'s phase 31 (Llama 3.2
3B trained 30 steps at full width and its serving copy served through
flash_decode with the greedy contract, Granite-MoE 3B trained 10 steps,
the ten architectures' gradients and steps against the CPU at smoke
shapes, int8 gradient compression on 8 logical data shards), without the
other phases.

Run from the root of a checkout on a machine with an NVIDIA GPU and the CUDA
toolkit:  ``python3 tools/lm_train_phase.py``.  It builds the checkout's
kernels, runs the phase (each part raises on a failed check) and prints as
its last line one JSON object of its figures.
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
        print("lm_train_phase: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.device import disable_tf32
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_decode import ops as fd

    disable_tf32()
    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    out = cs.phase_lm_train(torch, dev, fd, card)
    print(json.dumps({"card": card, "seconds": time.perf_counter() - t0,
                      **out}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
