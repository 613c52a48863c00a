#!/usr/bin/env python3
"""The rest of the LM stack on one card, alone: ``chip_smoke.py``'s phase 11
(flash_decode against its plain version, the other configs' head shapes
included) and phases 26-30 (Granite-MoE 3B served paged at full size,
starcoder2-3b's rep-12 kernel through LMEngine, every other architecture at
full width, all ten against the CPU at smoke shapes, flash_decode timed at
the new shapes), without the other phases.

Run from the root of a checkout on a machine with an NVIDIA GPU and the CUDA
toolkit:  ``python3 tools/lm_stack_phase.py``.  It builds the checkout's
kernels, runs the phases (each raises on a failed check) and prints as its
last line one JSON object of their figures.
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
        print("lm_stack_phase: needs an NVIDIA GPU", file=sys.stderr)
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
    err = cs.phase_flash_decode(torch, dev, fd)
    granite = cs.phase_granite(torch, dev, fd, card)
    starcoder = cs.phase_starcoder(torch, dev, fd, card)
    archs = cs.phase_arch_full(torch, dev, card)
    cpu = cs.phase_arch_card_cpu(torch, dev, card)
    times = {arch: cs.phase_fd_timing(
        torch, dev, fd, run["lens"], card, g=g, rep=rep, dh=dh,
        kvs=("bf16",), phase=30, gate=False)["bf16"]
        for arch, run in ((cs.GRANITE, granite), (cs.STARCODER, starcoder))
        for g, rep, dh in (cs.FD_CONFIG_SHAPES[arch],)}
    granite.pop("lens")
    starcoder.pop("lens")
    print(json.dumps({"card": card, "seconds": time.perf_counter() - t0,
                      "max_abs_err": err, "granite": granite,
                      "starcoder2": starcoder, "archs": archs,
                      "card_cpu": cpu, "flash_decode": times},
                     default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
