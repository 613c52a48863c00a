#!/usr/bin/env python3
"""Where ``flash_decode``'s time goes on the card: diagnostic builds of its
CUDA source, timed at the serving shape of Llama 3.2 3B with a cold L2.

Run from the root of a checkout on a machine with an NVIDIA GPU and the CUDA
toolkit:  ``python3 tools/flash_decode_lab.py [--wide]``.  ``--wide`` takes
starcoder2-3b's head shape (G 2, rep 12: the tensor-core kernel) at phase
30's lengths in place of Llama's.  It compiles three copies of
``src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu`` into
``build/lab/`` and times each, bf16 and int8 pools, at every split count
(CUDA-graph replay, the input sets rotated as in ``chip_smoke.py`` phase 15):

  * ``kernel``: the source as it is;
  * ``loads only``: the same copies into the ring, but a batch's compute cut
    to one read, so the time is what the loads, the staging, the merges and
    the launch cost;
  * ``compute only``: the same compute, but every copy zero-filled (no
    device-memory read of K/V), so the time is what the compute costs.

Then it prints a per-block timeline of the kernel at the split count the
wrapper picks (an instrumented copy: start and end on the global timer,
setup, position loop and merge in SM cycles, positions per block).  The
diagnostic copies change the source's text at fixed anchors; an anchor that
moved raises.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu"
OUT = ROOT / "build" / "lab"

LOOP = "      // Partial scores of the batch's positions"
WIDE_LOOP = "      // Scores of heads (gq, gq + 8)"
LOOP_END = "    }\n    t0 = hi;"
TIMED = [  # (anchor, replacement) pairs of the instrumented copy
    ("namespace {\n", "__device__ long long g_lab[8 * 65536];\nnamespace {\n"),
    ("  cg::cluster_group cluster = cg::this_cluster();\n",
     "  cg::cluster_group cluster = cg::this_cluster();\n"
     "  long long lab_wait = 0, lab_tiles = 0;\n"
     "  long long ck0 = clock64(), gt0;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(gt0));\n"),
    ("  for (int t0 = start; t0 < end;) {\n",
     "  long long ck1 = clock64();\n  for (int t0 = start; t0 < end;) {\n"),
    ("  cp_async_wait<0>();  // only empty",
     "  long long ck2 = clock64();\n  cp_async_wait<0>();  // only empty"),
    ("  cluster.sync();  // no block exits while a peer reads its shared "
     "memory\n}",
     "  long long ck3 = clock64();\n  cluster.sync();\n"
     "  if (threadIdx.x == 0) {\n    long long gt1;\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(gt1));\n"
     "    long long* o = g_lab + 8 * (blockIdx.x + gridDim.x * (blockIdx.y"
     " + gridDim.y * blockIdx.z));\n"
     "    o[0] = gt0; o[1] = gt1; o[2] = ck1 - ck0; o[3] = ck2 - ck1;\n"
     "    o[4] = ck3 - ck2; o[5] = end - start; o[6] = lab_wait;\n"
     "    o[7] = lab_tiles;\n  }\n}"),
    ("      cp_async_wait<kStages - 1>();  // tile `it` has landed\n",
     "      long long cw0 = clock64();\n"
     "      cp_async_wait<kStages - 1>();  // tile `it` has landed\n"
     "      lab_wait += clock64() - cw0;\n      ++lab_tiles;\n"),
    ("const char* flash_decode_error_string(int code) {",
     "int lab_read(long long* host, int n) {\n"
     "  return (int)cudaMemcpyFromSymbol(host, g_lab, n * 8);\n}\n"
     "const char* flash_decode_error_string(int code) {"),
]


def _edit(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"anchor not in {SOURCE.name}: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def variants(src: str) -> dict:
    loads_only = src
    for anchor, read in ((LOOP, "acc[0][0] += __uint_as_float(*reinterpret_"
                                "cast<const uint32_t*>(src + lane * 4));"),
                         (WIDE_LOOP, "o[0][0] += __uint_as_float(*reinterpret_"
                                     "cast<const uint32_t*>(ks + lane * 4));")):
        i = loads_only.index(anchor)
        j = loads_only.index(LOOP_END, i)
        loads_only = loads_only[:i] + "      " + read + "\n" + loads_only[j:]
    compute_only = _edit(src, [
        ("const int n = row >= 0 ? Sh::kChunk : 0;", "const int n = 0;"),
        ("const int n = row >= 0 ? 16 : 0;", "const int n = 0;"),
        ("nn = row >= 0 ? 4 : 0;", "nn = 0;")])
    return {"kernel": src, "loads only": loads_only,
            "compute only": compute_only, "timeline": _edit(src, TIMED)}


def build(sources: dict) -> dict:
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        stem = name.replace(" ", "_")
        (OUT / f"{stem}.cu").write_text(text)
        procs[name] = (OUT / f"{stem}.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"{stem}.so"),
             str(OUT / f"{stem}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = path
    return libs


def use(path) -> ctypes.CDLL:
    """Makes the wrapper launch the library at `path`."""
    from repro_torch.kernels import _build

    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_decode_launch.argtypes = [p] * 8 + [i] * 9 + [p]
    lib.flash_decode_launch.restype = ctypes.c_int
    lib.flash_decode_wide_occupancy.argtypes = [i, i, i, p, p]
    lib.flash_decode_wide_occupancy.restype = ctypes.c_int
    lib.flash_decode_error_string.argtypes = [ctypes.c_int]
    lib.flash_decode_error_string.restype = ctypes.c_char_p
    _build._loaded["flash_decode"] = lib
    return lib


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--wide", action="store_true",
                    help="starcoder2-3b's head shape (rep 12) in place of "
                         "Llama's (rep 3)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_decode_lab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels.flash_decode import kernel as k

    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    libs = build(variants(SOURCE.read_text()))
    if args.wide:  # phase 30's lengths (prompt lengths do not read vocab)
        prompts = cs.lm_prompts(cs.LM_SLOTS, 2, seed=43)
        g, rep = 2, 12
    else:  # phase 15's
        prompts = cs.lm_prompts(cs.LM_REQUESTS, 128256)[:cs.LM_SLOTS]
        g, rep = 8, 3
    lens = [min(len(p) + cs.LM_NEW // 2, cs.LM_MAX_LEN - 1) for p in prompts]
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    dh, width = 128, -(-cs.LM_MAX_LEN // cs.LM_BLOCK)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def call(q, pool, table, splits):
        return k.flash_decode(q, pool["k"], pool["v"], table, kv_lens,
                              k_scale=pool.get("k_scale"),
                              v_scale=pool.get("v_scale"), splits=splits)

    for kv in ("bf16", "int8"):
        sets = [cs.fd_inputs(torch, cs.LM_SLOTS, g, rep, dh, cs.LM_BLOCK,
                             width, kv, 17 + i, dev, dh ** -0.5)
                for i in range(cs.FD_COLD_SETS[kv] * (3 if args.wide else 1))]
        b_ms = cs.fd_bound(lens, g, rep, dh, kv == "int8")[0]
        use(libs["kernel"])  # the occupancy query reads the kernel's build
        chosen = k.split_count(
            cs.LM_SLOTS, g, width * cs.LM_BLOCK, sms,
            k.wide_clusters(0, dh, kv == "int8") if args.wide else None)
        for name in ("kernel", "loads only", "compute only"):
            use(libs[name])
            t = {s: cs.graph_ms(cs.rotate([
                lambda a=a, s=s: call(*a, s) for a in sets]))
                for s in ((1, 2, 3, 4, 5, 6, 8) if args.wide else (1, 2, 4, 8))}
            print(f"{kv} {name}: cold ms by split count " + ", ".join(
                f"S={s} {v:.5f}" for s, v in t.items())
                + f"; at S={chosen} {b_ms / t[chosen]:.1%} of the bound",
                flush=True)
        lib = use(libs["timeline"])
        for a in sets[1:]:
            call(*a, chosen)  # leaves set 0 out of the L2
        call(*sets[0], chosen)
        torch.cuda.synchronize()
        n = chosen * g * cs.LM_SLOTS
        buf = (ctypes.c_longlong * (8 * n))()
        lib.lab_read(buf, 8 * n)
        a = np.frombuffer(buf, np.int64).reshape(n, 8).astype(np.float64)
        st, en = (a[:, 0] - a[:, 0].min()) / 1e3, (a[:, 1] - a[:, 0].min()) / 1e3
        print(f"{kv} timeline at S={chosen}: span {en.max():.2f} us; block "
              f"start percentiles 50/90/100 {np.percentile(st, [50, 90, 100]).round(2).tolist()} us, "
              f"end 10/50/90/100 {np.percentile(en, [10, 50, 90, 100]).round(2).tolist()} us; "
              f"SM cycles setup {a[:, 2].mean():.0f}, loop mean "
              f"{a[:, 3].mean():.0f} max {a[:, 3].max():.0f}, merge "
              f"{a[:, 4].mean():.0f}; positions a block mean "
              f"{a[:, 5].mean():.1f} max {a[:, 5].max():.0f}"
              + (f"; warp 0: tiles mean {a[:, 7].mean():.2f}, cycles waiting "
                 f"on them mean {a[:, 6].mean():.0f} max {a[:, 6].max():.0f}"
                 if args.wide else ""), flush=True)
        if args.wide:
            fn = lib.flash_decode_wide_occupancy
            fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
            occ = []
            for s in (1, 2, 3, 4, 5, 6, 8):
                per_sm, clusters = ctypes.c_int(), ctypes.c_int()
                rc = fn(dh, int(kv == "int8"), s, ctypes.byref(per_sm),
                        ctypes.byref(clusters))
                occ.append(f"S={s} rc {rc}: {per_sm.value} blocks an SM, "
                           f"{clusters.value} clusters at once")
            print(f"{kv} occupancy: " + "; ".join(occ), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
