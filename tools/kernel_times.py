#!/usr/bin/env python3
"""Device times of the fused resonator sweep and ``similarity_int8`` of one
checkout, by CUDA-graph replay, for comparing two designs on one card.

Run from the root of a checkout on a machine with an NVIDIA GPU and the CUDA
toolkit:  ``python3 tools/kernel_times.py [--root DIR] [--tag NAME]``.
``--root`` names the checkout whose ``src/repro_torch`` is timed (default:
this one), so an unpacked older tree (``git archive``) is timed with the
same script.  It builds that checkout's two sources, prints what
``nvcc -Xptxas -v`` reports for them (registers, shared memory, stack frame,
spills), and times at the shapes the main path gives them:

  * dense and masked sweeps at N 256, F 3, M 10, D 2048 (masks 5/6/10);
  * the LOCAL sweep at N 64, F 3, M_loc 5, D 2048;
  * ``similarity_int8`` at (256, 10, 1024) and (128, 257, 1024), beside one
    fp32 matmul over the dequantized codebook (``q @ W_deq.T``).

Each time is the lower of two graph replays (kernel, kernel).  The last line
is one JSON object ``{"tag": ..., "card": ..., "ms": {row: ms}}``.  To
compare designs, run the script for each checkout in turns in one command
(older, newer, newer, older): two calls may land on two cards.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def graph_ms(torch, fn, iters: int = 100, replays: int = 5) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (iters * replays)


def ptxas_report(build, name: str) -> str:
    """``nvcc -Xptxas -v`` of one kernel source, the lines that name
    each instantiation, its registers, stack frame and spills."""
    src = build.sources()[name]
    out = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", "/dev/null",
         str(src)], capture_output=True, text=True)
    keep = [ln.strip() for ln in (out.stdout + out.stderr).splitlines()
            if any(k in ln for k in ("Compiling entry", "registers",
                                     "stack frame", "spill"))]
    return "\n".join(keep)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--tag", default="this checkout")
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc -Xptxas -v for both sources")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))

    import torch

    if not torch.cuda.is_available():
        print("kernel_times: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.quantization import quantize
    from repro_torch.device import disable_tf32
    from repro_torch.kernels import _build
    from repro_torch.kernels.resonator_step import kernel as rk
    from repro_torch.kernels.similarity import kernel as sk

    disable_tf32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    _build.build_all(["resonator_step", "similarity_int8"])
    if args.ptxas:
        for name in ("resonator_step", "similarity_int8"):
            print(f"[{args.tag}] ptxas {name}:\n{ptxas_report(_build, name)}",
                  flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(5)

    def bip(shape):
        return (torch.randint(0, 2, shape, generator=gen) * 2.0 - 1.0).to(dev)

    qs, est, cbs = bip((256, 2048)), bip((256, 3, 2048)), bip((3, 10, 2048))
    mask = torch.stack([torch.arange(10) < s for s in (5, 6, 10)]).to(dev)
    ql, el, bl = bip((64, 2048)), bip((64, 3, 2048)), bip((3, 5, 2048))
    ml = torch.ones((3, 5), dtype=torch.bool, device=dev)
    rows = {
        "resonator_step_batch": lambda: rk.resonator_step_batch(qs, est, cbs),
        "resonator_step_batch_masked":
            lambda: rk.resonator_step_batch_masked(qs, est, cbs, mask),
        "resonator_step_batch_local":
            lambda: rk.resonator_step_batch_local(ql, el, bl, ml),
    }
    for n, m, d in ((256, 10, 1024), (128, 257, 1024)):
        q = torch.randn((n, d), generator=gen).to(dev)
        w = quantize(torch.randn((m, d), generator=gen)).to(dev)
        w_deq = w.dequantize()
        rows[f"similarity_int8{(n, m, d)}"] = \
            (lambda q=q, w=w: sk.similarity_int8(q, w.values, w.scale))
        rows[f"q @ W_deq.T{(n, m, d)}"] = (lambda q=q, w=w_deq: q @ w.T)
    ms = {}
    for name, fn in rows.items():
        ms[name] = min(graph_ms(torch, fn), graph_ms(torch, fn))
        print(f"[{args.tag}] {name}: {ms[name]:.5f} ms (CUDA graph) on {card}",
              flush=True)
    print(json.dumps({"tag": args.tag, "card": card, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
