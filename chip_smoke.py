#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit:  ``python3 chip_smoke.py``.  It builds every CUDA kernel of the
port from the checkout's sources (into ``build/kernels/``), then:

  1. prints the card's name and power limit and the build time;
  2. holds every kernel against its plain PyTorch version on the card, at
     the shapes LVRF serving gives it (bitwise on +-1 inputs; a Gaussian
     query case with a tolerance on the scores);
  3. serves 512 LVRF rows at full width (D = 2048, F = 3, M = 10) through
     ``Engine(slots=256)`` on the card, checks every decode and that the
     dense kernel was launched exactly once per sweep, and replays 32 rows
     through the same engine code on the CPU, which must agree bit for bit;
  4. runs a masked factorization (cardinalities 5/6/10) on the card;
  5. times each kernel, its plain version and its bound at N = 256;
  6. prints one JSON line describing every kernel, the card line, and as
     the last line ``{"ok": true, "device": {...}}``.

A failed phase raises, and the script exits nonzero.  Without a CUDA device,
or without the repository beside it, it exits nonzero before any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

F, M, D = 3, 10, 2048  # LVRF's published widths (models/lvrf.py)
ENGINE_ROWS = 256  # the engine's slot count, the kernel's N on the main path
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
JUNK_ATOL = 1e-3  # fp32 sums of 2048 Gaussian terms in another order


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bipolar(gen, shape, device):
    import torch
    return (torch.randint(0, 2, shape, generator=gen) * 2.0 - 1.0).to(device)


def cuda_ms(fn, iters: int = 200) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(10):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(n: int, masked: bool) -> tuple:
    """Least time (ms) of one sweep at N = n and what bounds it: each input
    read once, each output written once; the scores and projection FMAs,
    the unbind products, at the fp32 rate."""
    nbytes = 4 * (n * D + n * F * D + F * M * D + n * F * M + n * F * D
                  + (F * M if masked else 0))
    flops = 4 * n * F * M * D + n * F * D * (F + 1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(rs, ref, torch, dev) -> dict:
    """Kernels against their plain versions on +-1 inputs, where they must be
    bitwise equal, then on Gaussian queries with a tolerance on alpha.
    Returns each kernel's max |kernel - plain| over the +-1 cases."""
    gen = torch.Generator().manual_seed(11)
    cbs = bipolar(gen, (F, M, D), dev)
    masks = [torch.stack([torch.arange(M) < s for s in sizes]).to(dev)
             for sizes in ((5, 6, 10), (5, 0, 10))]
    err = {"resonator_step_batch": 0.0, "resonator_step_batch_masked": 0.0}

    def check(name, got, want, what):
        torch.cuda.synchronize()
        diff = max((g - w).abs().max().item() for g, w in zip(got, want))
        err[name] = max(err[name], diff)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name} != plain version at {what}: max "
                                 f"|diff| {diff}")

    for n in (1, 7, 256, 257):
        qs = bipolar(gen, (n, D), dev)
        est = bipolar(gen, (n, F, D), dev)
        for act in ("identity", "abs"):
            check("resonator_step_batch",
                  rs.fused_resonator_step_batch(qs, est, cbs, act),
                  ref.resonator_step_batch_ref(qs, est, cbs, act),
                  f"N={n} {act}")
            for mask in masks:
                check("resonator_step_batch_masked",
                      rs.fused_resonator_step_batch_masked(qs, est, cbs, mask,
                                                           act),
                      ref.resonator_step_batch_masked_ref(qs, est, cbs, mask,
                                                          act),
                      f"N={n} {act} cardinalities {mask.sum(1).tolist()}")
        print(f"phase 2: N={n}: dense and masked kernels bitwise equal to "
              "the plain versions (identity, abs; masks 5/6/10 and 5/0/10)",
              flush=True)
    qs = torch.randn((ENGINE_ROWS, D), generator=gen).to(dev)
    est = bipolar(gen, (ENGINE_ROWS, F, D), dev)
    for name, got, want in (
            ("resonator_step_batch",
             rs.fused_resonator_step_batch(qs, est, cbs),
             ref.resonator_step_batch_ref(qs, est, cbs)),
            ("resonator_step_batch_masked",
             rs.fused_resonator_step_batch_masked(qs, est, cbs, masks[0]),
             ref.resonator_step_batch_masked_ref(qs, est, cbs, masks[0]))):
        diff = (got[0] - want[0]).abs().max().item()
        if not diff <= JUNK_ATOL:
            raise AssertionError(f"{name}: Gaussian-query scores differ by "
                                 f"{diff} > {JUNK_ATOL}")
        print(f"phase 2: {name}: Gaussian queries at N={ENGINE_ROWS}, max "
              f"|alpha - plain| = {diff:.3g} (atol {JUNK_ATOL})", flush=True)
    return err


def phase_engine(torch, dev, rs):
    """LVRF serving at full width on the card, then 32 rows on the CPU."""
    import numpy as np

    from repro_torch import engine, obs
    from repro_torch.device import generator
    from repro_torch.models import lvrf

    cfg = lvrf.LVRFConfig()
    rng = np.random.default_rng(1)
    vals = rng.integers(0, cfg.n_values, (512, 3))

    def build(device):
        atoms = lvrf.init_atoms(generator(0), cfg, device=device)
        spec = engine.registry.build("lvrf_rows", 0, fused_step=True,
                                     atoms=atoms, device=device)
        return spec, lvrf.encode_row(atoms, vals, cfg)

    spec, qs = build(dev)
    warm = engine.Engine(spec, slots=ENGINE_ROWS, device=dev)
    for i in range(8):
        warm.submit(qs[i])
    warm.drain()

    eng = engine.Engine(spec, slots=ENGINE_ROWS, device=dev)
    rs.launches = 0  # the main path's run starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = [eng.submit(qs[i]) for i in range(len(vals))]
    done = {r.id: r for r in eng.drain()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rs.launches  # ... and ends here
    got = np.stack([done[i].result["values"][0] for i in ids])
    wrong = int((got != vals).any(1).sum())
    if wrong:
        raise AssertionError(f"{wrong} of {len(vals)} LVRF rows decoded wrong")
    if launches != eng.sweeps_total or launches == 0:
        raise AssertionError(f"dense kernel launches {launches} != "
                             f"sweeps_total {eng.sweeps_total}")
    snap = eng.snapshot()
    print(f"phase 3: engine on {torch.cuda.get_device_name(0)}: "
          f"{len(vals)} LVRF rows at D={D}, slots={ENGINE_ROWS}, all decoded "
          f"correctly; sweeps_per_step={eng.sweeps_per_step} "
          f"sweeps_total={eng.sweeps_total} kernel launches={launches} "
          f"steps={eng.steps_total}; {len(vals) / wall:.1f} requests/s, "
          f"p50 {snap['latency_p50_ms']:.3f} ms, "
          f"p99 {snap['latency_p99_ms']:.3f} ms, wall {wall * 1e3:.2f} ms",
          flush=True)

    # The same run again under a span recorder: where the engine's wall goes.
    rec = obs.Recorder()
    traced = engine.Engine(spec, slots=ENGINE_ROWS, obs=rec, device=dev)
    t0 = time.perf_counter()
    for i in range(len(vals)):
        traced.submit(qs[i])
    t_submit = time.perf_counter() - t0
    traced.drain()
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    spent: dict = {}
    for sp in rec.spans.snapshot():
        if sp.duration is not None:
            spent[sp.name] = spent.get(sp.name, 0.0) + sp.duration
    print(f"phase 3: traced run: wall {t_all * 1e3:.2f} ms = submit "
          f"{t_submit * 1e3:.2f} ms + steps {spent['step'] * 1e3:.2f} ms "
          f"(fill {spent['fill'] * 1e3:.2f}, sweep-burst "
          f"{spent['sweep-burst'] * 1e3:.2f} for {traced.sweeps_total} "
          f"sweeps, retire {spent['retire'] * 1e3:.2f} ms)", flush=True)

    spec_cpu, qs_cpu = build("cpu")
    if not torch.equal(spec_cpu.codebooks, spec.codebooks.cpu()):
        raise AssertionError("CPU and CUDA specs differ")
    eng_cpu = engine.Engine(spec_cpu, slots=32, device="cpu")
    ids_cpu = [eng_cpu.submit(qs_cpu[i], keys=done[ids[i]].keys.cpu())
               for i in range(32)]
    done_cpu = {r.id: r for r in eng_cpu.drain()}
    for i in range(32):
        a = done[ids[i]].factorization
        b = done_cpu[ids_cpu[i]].factorization
        for field in ("indices", "iterations", "converged", "scores"):
            if not np.array_equal(getattr(a, field), getattr(b, field)):
                raise AssertionError(f"row {i}: CUDA and CPU {field} differ")
        np.testing.assert_allclose(a.reconstruction_sim, b.reconstruction_sim,
                                   rtol=1e-6)
    print("phase 3: 32 rows replayed through Engine(device='cpu'): indices, "
          "iterations, converged and scores bit-equal to the CUDA run",
          flush=True)
    return launches, eng


def phase_masked(torch, dev, rs):
    """factorize_batch with a masked fused config (RAVEN-style ragged
    cardinalities) on the card."""
    import numpy as np

    from repro_torch.core import factorizer as fz
    from repro_torch.core import vsa

    sizes = (5, 6, 10)
    cfg = fz.FactorizerConfig(vsa=vsa.VSAConfig(D, D), num_factors=F,
                              codebook_size=M, synchronous=True,
                              fused_step=True, max_iters=40,
                              conv_threshold=0.8)
    gen = torch.Generator().manual_seed(3)
    cbs = fz.make_codebooks(gen, cfg, device=dev)
    mask = torch.stack([torch.arange(M) < s for s in sizes]).to(dev)
    rng = np.random.default_rng(2)
    idx = np.stack([rng.integers(0, s, ENGINE_ROWS) for s in sizes], -1)
    qs = fz.bind_combo(cbs, torch.from_numpy(idx).to(dev), cfg.vsa)
    rs.masked_launches = 0  # the masked path's run starts here
    res = fz.factorize_batch(qs, cbs, gen, cfg, mask, device=dev)
    torch.cuda.synchronize()
    launches = rs.masked_launches  # ... and ends here
    sweeps = int(res.iterations.max())
    if launches != sweeps:
        raise AssertionError(f"masked launches {launches} != sweeps {sweeps}")
    res = fz.FactorizerResult(*(t.cpu().numpy() for t in res))
    plain = fz.factorize_batch(qs.cpu(), cbs.cpu(), gen, cfg, mask.cpu(),
                               device="cpu")
    for field in ("indices", "iterations", "converged", "scores"):
        if not np.array_equal(getattr(res, field),
                              getattr(plain, field).numpy()):
            raise AssertionError(f"masked factorization: CUDA and CPU "
                                 f"{field} differ")
    right = (res.indices == idx).all(1)
    # A converged row decodes right; a Jacobi limit cycle may leave a rare
    # row unconverged at max_iters, as it does in the reference.
    if not right[res.converged].all() or right.mean() < 0.99:
        raise AssertionError(f"masked factorization: {int((~right).sum())} "
                             f"of {len(right)} rows decoded wrong")
    print(f"phase 4: masked factorize_batch at N={ENGINE_ROWS}, D={D}, "
          f"cardinalities {sizes}: {int(right.sum())}/{len(right)} decoded "
          f"correctly ({int(res.converged.sum())} converged), bit-equal to "
          f"the CPU run; {sweeps} sweeps, {launches} masked kernel launches",
          flush=True)
    return launches


def phase_timing(torch, dev, rs, ref, card):
    """Per-sweep kernel and plain-version times at the engine's shape."""
    from repro_torch.kernels.resonator_step import kernel as k

    gen = torch.Generator().manual_seed(5)
    qs = bipolar(gen, (ENGINE_ROWS, D), dev)
    est = bipolar(gen, (ENGINE_ROWS, F, D), dev)
    cbs = bipolar(gen, (F, M, D), dev)
    mask = torch.stack([torch.arange(M) < s for s in (5, 6, 10)]).to(dev)
    times = {}
    for name, kern, plain, masked in (
            ("resonator_step_batch",
             lambda: k.resonator_step_batch(qs, est, cbs),
             lambda: ref.resonator_step_batch_ref(qs, est, cbs), False),
            ("resonator_step_batch_masked",
             lambda: k.resonator_step_batch_masked(qs, est, cbs, mask),
             lambda: ref.resonator_step_batch_masked_ref(qs, est, cbs, mask),
             True)):
        # plain, kernel, kernel, plain: the two versions in turns
        p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(kern), cuda_ms(kern),
                          cuda_ms(plain))
        b_ms, b_by = bound(ENGINE_ROWS, masked)
        times[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                       "bound_ms": b_ms, "bound_by": b_by}
        print(f"phase 5: {name} at N={ENGINE_ROWS} F={F} M={M} D={D} on "
              f"{card}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by}), kernel at "
              f"{b_ms / min(k1, k2):.1%} of the bound", flush=True)
    rows_line = []
    for tn in (1, 2, 4):
        rows, _, _ = k.launch_geometry(
            ENGINE_ROWS, F, M, D, tn,
            torch.cuda.get_device_properties(dev).multi_processor_count)
        t = cuda_ms(lambda: k.resonator_step_batch(qs, est, cbs, tn=tn))
        rows_line.append(f"rows={rows}: {t:.4f} ms")
    print(f"phase 5: dense kernel by rows per block (tn ceiling) on {card}: "
          + ", ".join(rows_line), flush=True)
    return times


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.device import disable_tf32
    from repro_torch.kernels import _build
    from repro_torch.kernels.resonator_step import ops as rs
    from repro_torch.kernels.resonator_step import ref

    disable_tf32()
    dev = torch.device("cuda")
    card = card_line()
    print(f"phase 1: card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"phase 1: built {sorted(libs)} with nvcc in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    err = phase_kernels(rs, ref, torch, dev)
    dense_launches, _ = phase_engine(torch, dev, rs)
    masked_launches = phase_masked(torch, dev, rs)
    times = phase_timing(torch, dev, rs, ref, card)

    src = "src/repro_torch/kernels/resonator_step/csrc/resonator_step.cu"
    kernels = [
        {"name": "resonator_step_batch", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/resonator_step/kernel.py:153",
         "launches": dense_launches,
         "max_abs_err": err["resonator_step_batch"],
         **times["resonator_step_batch"], "library_ms": None},
        {"name": "resonator_step_batch_masked", "route": "cuda",
         "source": src,
         "replaces": "src/repro/kernels/resonator_step/kernel.py:184",
         "launches": masked_launches,
         "max_abs_err": err["resonator_step_batch_masked"],
         **times["resonator_step_batch_masked"], "library_ms": None},
    ]
    print("kernels: " + ", ".join(
        f"{kd['name']} (bitwise equal to plain at N=1/7/256/257, "
        f"{kd['launches']} launches on its path)" for kd in kernels),
        flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
