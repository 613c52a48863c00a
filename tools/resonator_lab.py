#!/usr/bin/env python3
"""Where the fused resonator sweep's time goes on the card: the kernel at
every cluster geometry, and a per-block timeline of an instrumented copy.

Run from the root of a checkout on a machine with an NVIDIA GPU and the CUDA
toolkit:  ``python3 tools/resonator_lab.py``.  At the engine's shape (N 256,
F 3, M 10, D 2048, masked 5/6/10) and at the LOCAL shape (N 64, M_loc 5) it

  * times the kernel (CUDA-graph replay) at each (rows a cluster, blocks a
    cluster) where the slice fits whole, and marks the geometry the wrapper
    picks;
  * builds a copy of ``src/repro_torch/kernels/resonator_step/csrc/
    resonator_step.cu`` into ``build/lab/`` that stamps each block's start
    and end on the global timer and the SM cycles of its phases (staging
    and unbinding, scores, first cluster barrier, cluster sum, projection,
    last barrier), runs it once at the wrapper's geometry and prints
    percentiles.

The instrumented copy changes the source's text at fixed anchors; an anchor
that moved raises.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/resonator_step/csrc/resonator_step.cu"
OUT = ROOT / "build" / "lab"
PHASES = ("staging and unbind", "scores", "barrier 1", "cluster sum",
          "projection", "barrier 2")
SLOTS = 2 + len(PHASES)  # start and end on the global timer, then the phases
LAB = "{{ long long now = clock64(); lab_c[{k}] += now - lab_t; lab_t = now; }}"
TIMED = [  # (anchor, replacement) pairs of the instrumented copy; a phase's
           # cycles are summed over the slice's chunks
    ("namespace {\n", "__device__ long long g_lab[16 * 65536];\nnamespace {\n"),
    ("  cg::cluster_group cluster = cg::this_cluster();\n",
     "  cg::cluster_group cluster = cg::this_cluster();\n"
     "  long long lab_g0, lab_c[6] = {0, 0, 0, 0, 0, 0}, lab_t = clock64();\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(lab_g0));\n"),
    ("    cp_async_wait_all();\n    __syncthreads();\n"
     "    scores<MT>(xs, in, part, R, F, M, dc, (len + 3) >> 2, c == 0);\n",
     "    cp_async_wait_all();\n    __syncthreads();\n" + LAB.format(k=0) +
     "\n    scores<MT>(xs, in, part, R, F, M, dc, (len + 3) >> 2, c == 0);\n"
     + LAB.format(k=1) + "\n"),
    ("  cluster.sync();  // every rank's partial scores are complete and "
     "visible\n",
     "  cluster.sync();\n" + LAB.format(k=2) + "\n"),
    ("    wsm[(r * F + f) * m4 + m] = w;\n  }\n  __syncthreads();\n",
     "    wsm[(r * F + f) * m4 + m] = w;\n  }\n  __syncthreads();\n"
     + LAB.format(k=3) + "\n"),
    ("    project(p, xs, wsm, row0, d0, len);\n  }\n",
     "    project(p, xs, wsm, row0, d0, len);\n  }\n"
     + LAB.format(k=4) + "\n"),
    ("  cluster.sync();  // no block exits while a peer reads its shared "
     "memory\n}",
     "  cluster.sync();\n" + LAB.format(k=5) + "\n"
     "  if (threadIdx.x == 0) {\n    long long g1;\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g1));\n"
     "    long long* o = g_lab + 16 * blockIdx.x;\n"
     "    o[0] = lab_g0; o[1] = g1;\n"
     "    for (int k = 0; k < 6; ++k) o[k + 2] = lab_c[k];\n"
     "  }\n}"),
    ("const char* resonator_step_error_string(int code) {",
     "int lab_read(long long* host, int n) {\n"
     "  return (int)cudaMemcpyFromSymbol(host, g_lab, n * 8);\n}\n"
     "const char* resonator_step_error_string(int code) {"),
]


def _edit(src: str, pairs) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise RuntimeError(f"anchor not once in {SOURCE.name}: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_timeline() -> Path:
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / "resonator_timeline.cu", OUT / "resonator_timeline.so"
    cu.write_text(_edit(SOURCE.read_text(), TIMED))
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                          str(cu)], capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed:\n{out.stdout}{out.stderr}")
    return so


def geometry(k, n, f, m, d, rows, csize):
    """The wrapper's geometry with the rows of a tile and the blocks of a
    cluster forced; None where the slice does not fit whole."""
    ds = -(-d // (4 * csize)) * 4
    smem = 4 * k.smem_floats(f, m, rows, ds)
    if smem > k.SMEM_BUDGET:
        return None
    return k.Geometry(rows, -(-n // rows), csize, ds, ds,
                      -(-m // -(-m // k.MAX_MT)), smem)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("resonator_lab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.resonator_step import kernel as k

    dev = torch.device("cuda")
    card = cs.card_line()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(5)
    cases = {}
    for tag, n, m in (("engine", 256, 10), ("local", 64, 5)):
        args = (cs.bipolar(gen, (n, 2048), dev),
                cs.bipolar(gen, (n, 3, 2048), dev),
                cs.bipolar(gen, (3, m, 2048), dev),
                torch.stack([torch.arange(m) < s for s in
                             ((5, 6, 10) if m == 10 else (5, 5, 5))]).to(dev))
        cases[tag] = (n, m, args)
    wrapper_geometry = k.launch_geometry
    try:
        for tag, (n, m, args) in cases.items():
            picked = wrapper_geometry(n, 3, m, 2048, 128, sms)
            fn = (lambda a=args: k.resonator_step_batch_local(*a)) \
                if tag == "local" else \
                (lambda a=args: k.resonator_step_batch_masked(*a))
            line = []
            for csize in (2, 4, 8):
                for rows in (1, 2, 4, 8, 16):
                    g = geometry(k, n, 3, m, 2048, rows, csize)
                    if g is None:
                        continue
                    k.launch_geometry = lambda *a, g=g: g
                    mark = "*" if g == picked else ""
                    line.append(f"{mark}R{rows}xC{csize} {cs.graph_ms(fn):.5f}")
            print(f"{tag} (N {n}, M {m}) on {card}: ms by rows x cluster "
                  f"(* the wrapper's): " + ", ".join(line), flush=True)
    finally:
        k.launch_geometry = wrapper_geometry

    lib = ctypes.CDLL(str(build_timeline()))
    lib.lab_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    real = _build.load("resonator_step")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.resonator_step_launch.argtypes = [p] * 4 + [i] + [p] * 2 + [i] * 14 + [p]
    lib.resonator_step_launch.restype = ctypes.c_int
    lib.resonator_step_error_string.argtypes = [ctypes.c_int]
    lib.resonator_step_error_string.restype = ctypes.c_char_p
    for tag, (n, m, args) in cases.items():
        _build._loaded["resonator_step"] = lib
        try:
            g = k.launch_geometry(n, 3, m, 2048, 128, sms)
            for _ in range(3):
                if tag == "local":
                    k.resonator_step_batch_local(*args)
                else:
                    k.resonator_step_batch_masked(*args)
            torch.cuda.synchronize()
        finally:
            _build._loaded["resonator_step"] = real
        nb = g.clusters * g.csize
        buf = (ctypes.c_longlong * (16 * nb))()
        lib.lab_read(buf, 16 * nb)
        a = np.frombuffer(buf, np.int64).reshape(nb, 16)[:, :SLOTS]
        a = a.astype(np.float64)
        st = (a[:, 0] - a[:, 0].min()) / 1e3
        en = (a[:, 1] - a[:, 0].min()) / 1e3
        cyc = ", ".join(f"{name} {a[:, 2 + j].mean():.0f}/"
                        f"{a[:, 2 + j].max():.0f}"
                        for j, name in enumerate(PHASES))
        print(f"{tag} timeline at {tuple(g)}: span {en.max():.2f} us; block "
              f"start 50/90/100 % {np.percentile(st, [50, 90, 100]).round(2).tolist()} us, "
              f"end 10/50/90/100 % {np.percentile(en, [10, 50, 90, 100]).round(2).tolist()} us; "
              f"SM cycles mean/max: {cyc}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
