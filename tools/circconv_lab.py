#!/usr/bin/env python3
"""Device times of the circular convolutions of one checkout, by CUDA-graph
replay, for comparing two designs on one card.

Run from the root of a checkout on a machine with an NVIDIA GPU and the CUDA
toolkit:  ``python3 tools/circconv_lab.py [--root DIR] [--tag NAME]
[--ptxas]``.  ``--root`` names the checkout whose ``src/repro_torch`` is
timed (default: this one), so an unpacked older tree (``git archive``) is
timed with the same script.  ``--ptxas`` prints what ``nvcc -Xptxas -v``
reports for that checkout's ``circconv.cu`` (registers, shared memory,
stack frame, spills).  It times, at the shapes of ``chip_smoke.py`` phase
22 (fp32):

  * MIMONet's bind and unbind at S = 2 and S = 4 (256 items, D = 2048,
    B = 8, L = 256) through ``vsa.bind`` / ``vsa.unbind`` with
    ``impl="pallas"`` (the wrapper's copies, if any, included) and with
    ``impl="fft"`` on the same tensors;
  * ``circconv_rows`` on 4096 independent rows of L = 256 (contiguous), and
    the FFT bind on them;
  * ``circconv_single`` at L = 2048, the FFT bind, and an empty kernel (the
    launch floor) where the checkout has one;
  * one MIMONet batch (random weights) at S = 2 and 4 with impl="pallas"
    and impl="fft", and, for the pallas batch, the device operations of
    one eager call (profiler) and its peak allocation beyond its inputs.

``--timeline`` also builds a copy of this checkout's ``circconv.cu`` into
``build/lab/`` that stamps each block's start and end on the global timer
and the SM cycles of its phases, runs it once at the S = 2 bind and at
L = 2048, and prints percentiles (the copy changes the source's text at
fixed anchors; an anchor that moved raises).

Each time is the lower of two graph replays.  The last line is one JSON
object ``{"tag": ..., "card": ..., "ms": {row: ms}}``.  To compare designs,
run the script for each checkout in turns in one command (older, newer,
newer, older): two calls may land on two cards.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ITEMS, DIM, BLOCKS = 256, 2048, 8  # MIMONet's batch and VSAConfig
STREAMS = (2, 4)
CONTRACT = (4096, 256)  # independent rows: the direct mode
SINGLE_L = 2048  # the HRR corner


ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "lab"
STAMP = ("{{ long long now = clock64(); lab_c[{k}] = now - lab_t; "
         "lab_t = now; }}")
START = ("  long long lab_g0, lab_c[6] = {0, 0, 0, 0, 0, 0}, lab_t = clock64();\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(lab_g0));\n")
END = ("  if (threadIdx.x == 0) {\n    long long g1;\n"
       "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g1));\n"
       "    long long* o = g_lab + 8 * blockIdx.x;\n"
       "    o[0] = lab_g0; o[1] = g1;\n"
       "    for (int k = 0; k < 6; ++k) o[k + 2] = lab_c[k];\n  }\n")
PHASES = {  # kernel: the phases its stamps close, in order
    "mma": ("offsets table", "stage 0 issued, window in", "strips built",
            "stage 0 in", "k loop", "epilogue"),
    "single": ("staging", "slice sums and shuffles", "peers started, push",
               "cluster barrier", "owner's sum and store"),
}
TIMED = [  # (anchor, replacement) pairs of the instrumented copy
    ("namespace {\n", "__device__ long long g_lab[8 * 65536];\nnamespace {\n"),
    ("  const int row0 = g * group_rows;\n",
     "  const int row0 = g * group_rows;\n" + START),
    ("    ooff[tid] = off.o;\n  }\n  __syncthreads();\n",
     "    ooff[tid] = off.o;\n  }\n  __syncthreads();\n" + STAMP.format(k=0) + "\n"),
    ("  for (int s = 1; s < kMmaStages; ++s) {  // in flight with the strips\n",
     STAMP.format(k=1) + "\n  for (int s = 1; s < kMmaStages; ++s) {\n"),
    ("  cp_async_wait<kMmaStages - 1>();\n  __syncthreads();  // the strips and stage 0 are in\n",
     STAMP.format(k=2) + "\n  cp_async_wait<kMmaStages - 1>();\n  __syncthreads();\n"
     + STAMP.format(k=3) + "\n"),
    ("  // C fragment:", STAMP.format(k=4) + "\n  // C fragment:"),
    ("__floats2bfloat162_rn(v0, v1);\n      }\n    }\n  }\n}\n",
     "__floats2bfloat162_rn(v0, v1);\n      }\n    }\n  }\n"
     + STAMP.format(k=5) + "\n" + END + "}\n"),
    ("  const int rank = (int)cluster.block_rank();\n  const int n0",
     "  const int rank = (int)cluster.block_rank();\n" + START + "  const int n0"),
    ("kSingleThreads);\n  __syncthreads();\n",
     "kSingleThreads);\n  __syncthreads();\n" + STAMP.format(k=0) + "\n"),
    ("  asm volatile(\"barrier.cluster.wait.aligned;\\n\" ::);\n",
     STAMP.format(k=1) + "\n  asm volatile(\"barrier.cluster.wait.aligned;\\n\" ::);\n"),
    ("  cluster.sync();  // every partial sum has reached its owner\n",
     STAMP.format(k=2) + "\n  cluster.sync();\n" + STAMP.format(k=3) + "\n"),
    ("    if (n0 + i < L) o[n0 + i] = from_f32<T>(a);\n  }\n}\n",
     "    if (n0 + i < L) o[n0 + i] = from_f32<T>(a);\n  }\n"
     + STAMP.format(k=4) + "\n" + END + "}\n"),
    ("const char* circconv_error_string(int code) {",
     "int lab_read(long long* host, int n) {\n"
     "  return (int)cudaMemcpyFromSymbol(host, g_lab, n * 8);\n}\n"
     "const char* circconv_error_string(int code) {"),
]


def build_timeline(build) -> Path:
    """The instrumented copy of circconv.cu, built into build/lab/."""
    src = build.sources()["circconv"].read_text()
    for old, new in TIMED:
        if src.count(old) != 1:
            raise RuntimeError(f"anchor not once in circconv.cu: {old[:60]!r}")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / "circconv_timeline.cu", OUT / "circconv_timeline.so"
    cu.write_text(src)
    out = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                          str(cu)], capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed:\n{out.stdout}{out.stderr}")
    return so


def timeline(torch, build, runs) -> None:
    """Runs each (tag, kernel, blocks, fn) once through the instrumented
    copy and prints its blocks' start, end and phase cycles."""
    import numpy as np

    lib = ctypes.CDLL(str(build_timeline(build)))
    lib.lab_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    real = build.load("circconv")
    for tag, kernel, blocks, fn in runs:
        build._loaded["circconv"] = lib
        try:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        finally:
            build._loaded["circconv"] = real
        buf = (ctypes.c_longlong * (8 * blocks))()
        lib.lab_read(buf, 8 * blocks)
        a = np.frombuffer(buf, np.int64).reshape(blocks, 8).astype(np.float64)
        st = (a[:, 0] - a[:, 0].min()) / 1e3
        en = (a[:, 1] - a[:, 0].min()) / 1e3
        cyc = ", ".join(f"{name} {a[:, 2 + j].mean():.0f}/{a[:, 2 + j].max():.0f}"
                        for j, name in enumerate(PHASES[kernel]))
        print(f"timeline {tag}: {blocks} blocks, span {en.max():.2f} us; "
              f"block start 50/90/100 % "
              f"{np.percentile(st, [50, 90, 100]).round(2).tolist()} us, end "
              f"10/50/90/100 % "
              f"{np.percentile(en, [10, 50, 90, 100]).round(2).tolist()} us; "
              f"SM cycles mean/max: {cyc}", flush=True)


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


def ptxas_report(build) -> str:
    """``nvcc -Xptxas -v`` of circconv.cu: each instantiation's registers,
    shared memory, stack frame and spills."""
    out = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", "/dev/null",
         str(build.sources()["circconv"])], capture_output=True, text=True)
    keep = [ln.strip() for ln in (out.stdout + out.stderr).splitlines()
            if any(k in ln for k in ("Compiling entry", "registers",
                                     "stack frame", "spill", "error"))]
    return "\n".join(keep)


def eager_batch(torch, fn) -> str:
    """Device operations of one eager call of ``fn`` and the MB it
    allocates at its peak beyond what was allocated before it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = sum(e.count for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e6
    return f"{ops} device operations, peak {peak:.3f} MB beyond its inputs"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--tag", default="this checkout")
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc -Xptxas -v for circconv.cu")
    ap.add_argument("--timeline", action="store_true",
                    help="a per-block timeline of an instrumented copy")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))

    import torch

    if not torch.cuda.is_available():
        print("circconv_lab: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import vsa
    from repro_torch.device import disable_tf32
    from repro_torch.kernels import _build
    from repro_torch.kernels.circconv import kernel as k

    disable_tf32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    _build.build_all(["circconv"])
    if args.ptxas:
        print(f"[{args.tag}] ptxas circconv:\n{ptxas_report(_build)}",
              flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(5)
    cfg = vsa.VSAConfig(DIM, BLOCKS, impl="pallas")
    rows = {}
    for S in STREAMS:
        emb = torch.randn((ITEMS, S, DIM), generator=gen).to(dev)
        out = torch.randn((ITEMS, DIM), generator=gen).to(dev)
        keys = vsa.random_unitary(gen, (S,), cfg, device=dev)[None]
        for impl in ("pallas", "fft"):
            rows[f"bind S={S} {impl}"] = (
                lambda e=emb, c=keys, i=impl: vsa.bind(e, c, cfg, impl=i))
            rows[f"unbind S={S} {impl}"] = (
                lambda o=out, c=keys, i=impl: vsa.unbind(o[:, None], c, cfg,
                                                         impl=i))
    x = torch.randn(CONTRACT, generator=gen).to(dev)
    y = torch.randn(CONTRACT, generator=gen).to(dev)
    rows[f"circconv_rows{CONTRACT}"] = lambda: k.circconv_rows(x, y)
    rows[f"fft bind{CONTRACT}"] = lambda: vsa._bind_fft(x, y)
    v = torch.randn((SINGLE_L,), generator=gen).to(dev)
    w = torch.randn((SINGLE_L,), generator=gen).to(dev)
    rows[f"circconv_single({SINGLE_L})"] = lambda: k.circconv_single(v, w)
    rows[f"fft bind({SINGLE_L})"] = lambda: vsa._bind_fft(v, w)
    if hasattr(k, "empty_launch"):
        rows["empty kernel"] = lambda: k.empty_launch(dev)
    from repro_torch.models import mimonet as mm

    for S in STREAMS:
        mcfg = mm.MIMONetConfig(vsa=cfg, num_streams=S)
        model = mm.init(mcfg, 0, device=dev)
        imgs = torch.rand((ITEMS, S, 32, 32), generator=gen).to(dev)
        for impl in ("pallas", "fft"):
            run = mm.MIMONetConfig(vsa=vsa.VSAConfig(DIM, BLOCKS, impl=impl),
                                   num_streams=S)
            fn = (lambda m=model, i=imgs, r=run: mm.apply(m, i, r))
            rows[f"MIMONet batch S={S} {impl}"] = fn
            if impl == "pallas":
                print(f"[{args.tag}] MIMONet batch S={S} pallas, one eager "
                      f"call: {eager_batch(torch, fn)}", flush=True)
    ms = {}
    for name, fn in rows.items():
        few = dict(iters=10, replays=3) if name.startswith("MIMONet") else {}
        ms[name] = min(graph_ms(torch, fn, **few), graph_ms(torch, fn, **few))
        print(f"[{args.tag}] {name}: {ms[name]:.5f} ms (CUDA graph) on {card}",
              flush=True)
    if args.timeline:
        emb = torch.randn((ITEMS, 2, DIM), generator=gen).to(dev)
        keys = vsa.random_unitary(gen, (2,), cfg, device=dev)[None]
        L = DIM // BLOCKS
        timeline(torch, _build, [
            ("bind S=2", "mma", k.mma_geometry(2 * BLOCKS, ITEMS, L, 4)[0],
             lambda: vsa.bind(emb, keys, cfg)),
            (f"single L={SINGLE_L}", "single",
             k.single_geometry(SINGLE_L)[1] * k.single_geometry(SINGLE_L)[2],
             lambda: k.circconv_single(v, w))])
    if hasattr(k, "SINGLE_BLOCKS"):  # the single kernel's split, swept
        line, default = [], k.SINGLE_BLOCKS
        try:
            for blocks in (64, 128, 256, 512):
                k.SINGLE_BLOCKS = blocks
                _, tiles, csize, _, _ = k.single_geometry(SINGLE_L)
                t = graph_ms(torch, lambda: k.circconv_single(v, w))
                line.append(f"{tiles}x{csize} {t:.5f}")
        finally:
            k.SINGLE_BLOCKS = default
        print(f"[{args.tag}] circconv_single({SINGLE_L}) by tiles x cluster "
              f"size: " + ", ".join(line) + f" ms on {card}", flush=True)
    print(json.dumps({"tag": args.tag, "card": card, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
