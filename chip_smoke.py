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
  6. holds the int8 similarity kernel against its plain version at the
     reference test's shapes and the serving shape, with the reference's
     tolerance, plus an argmax-preservation case;
  7. serves 512 requests of the paper's Tab. VII "2x2Grid" configuration at
     int8 (unitary, D = 1024, B = 4, F = 4, M = 10, stochastic Gauss-Seidel)
     through ``Engine(ServeSpec(QTensor codebooks), slots=256)``: accuracy,
     mean iterations, similarity launches = F x sweeps; then the first 256
     again with noise and restarts off, which must decode fewer right;
  8. runs the Tab. VIII/IX F = 3 deterministic int8 factorization on the
     card and on the CPU, which must agree;
  9. checks the counter-based RNG's integer stream on the card bit for bit
     against the CPU's;
 10. times the similarity kernel, its plain version, its bound and one
     PyTorch matmul over a dequantized codebook (device time from CUDA-graph
     replay, and per call with the host included);
 11. prints one JSON line describing every kernel, the card line, and as
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
# similarity_int8: the reference test's shapes (tests/test_kernels.py) and
# the int8 serving shape (N = 256 slots, M = 10, D = 1024); its tolerance.
SIM_SHAPES = ((1, 10, 64), (7, 100, 512), (128, 257, 1024), (3, 1000, 100),
              (ENGINE_ROWS, 10, 1024))
SIM_ATOL, SIM_RTOL = 2e-2, 1e-3
INT8_REQUESTS = 512
FAST_SWEEPS = 5  # phase 8: rows converging this fast must match the CPU


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


def graph_ms(fn, iters: int = 100, replays: int = 5) -> float:
    """Mean device time of ``fn`` with the host taken out: ``iters`` calls
    captured in one CUDA graph, replayed ``replays`` times between two
    events.  Where a call's host work (Python, checks, the launch) exceeds
    its device work, ``cuda_ms`` measures the host and this the device."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
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


def sim_bound(n: int, m: int, d: int) -> tuple:
    """Least time (ms) of one similarity_int8 launch and what bounds it:
    q (fp32), w (int8) and the scales read once, the scores written once;
    N*M*D FMAs plus N*M scale products at the fp32 rate."""
    nbytes = 4 * n * d + m * d + 4 * m + 4 * n * m
    flops = 2 * n * m * d + n * m
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def tab_cfg(fz, vsa, factors=4, noise=0.3, restarts=20):
    """The paper-table factorizer at int8 (benchmarks/paper_tables.py
    ``_fact_cfg``): unitary block codes, D = 1024, B = 4, M = 10,
    Gauss-Seidel, |alpha| activation, up to 100 sweeps."""
    return fz.FactorizerConfig(
        vsa=vsa.VSAConfig(1024, 4), num_factors=factors, codebook_size=10,
        algebra="unitary", activation="abs", noise_std=noise,
        restart_every=restarts, max_iters=100, conv_threshold=0.55,
        codebook_fmt="int8")


def phase_similarity(torch, dev, sim):
    """The int8 similarity kernel against its plain version on the card.
    Returns the max |kernel - plain| over the listed shapes."""
    from repro_torch.core.quantization import quantize

    gen = torch.Generator().manual_seed(21)
    err = 0.0
    for n, m, d in SIM_SHAPES:
        q = torch.randn((n, d), generator=gen).to(dev)
        w = quantize(torch.randn((m, d), generator=gen)).to(dev)
        before = sim.launches
        got = sim.codebook_scores(q, w)
        want = sim.similarity_int8_ref(q, w.values, w.scale)
        torch.cuda.synchronize()
        if sim.launches != before + 1:
            raise AssertionError(f"similarity_int8 at {(n, m, d)}: "
                                 f"{sim.launches - before} launches, not 1")
        diff = (got - want).abs()
        err = max(err, diff.max().item())
        if not bool((diff <= SIM_ATOL + SIM_RTOL * want.abs()).all()):
            raise AssertionError(f"similarity_int8 at N, M, D = {(n, m, d)}: "
                                 f"max |kernel - plain| {diff.max().item()}")
        print(f"phase 6: similarity_int8 at N, M, D = {n}, {m}, {d}: max "
              f"|kernel - plain| = {diff.max().item():.3g} (atol {SIM_ATOL}, "
              f"rtol {SIM_RTOL})", flush=True)
    w_f = torch.randn((50, 512), generator=gen)
    q = w_f[17] + 0.1 * torch.randn(512, generator=gen)
    top = int(torch.argmax(sim.codebook_scores(q[None].to(dev),
                                               quantize(w_f).to(dev))))
    if top != 17:
        raise AssertionError(f"int8 scores moved the argmax to {top}, not 17")
    print("phase 6: int8 scores keep the fp32 argmax (atom 17 of 50, D=512)",
          flush=True)
    return err


def phase_int8_engine(torch, dev, sim):
    """Tab. VII 2x2Grid at int8, stochastic, served through Engine on the
    card; then the first 256 problems without noise and restarts."""
    import dataclasses

    import numpy as np

    from repro_torch import engine
    from repro_torch.core import factorizer as fz
    from repro_torch.core import vsa
    from repro_torch.device import generator

    cfg = tab_cfg(fz, vsa)
    F = cfg.num_factors
    cbs = fz.make_codebooks(generator(1), cfg, device=dev)
    qt = fz.quantize_codebooks(cbs, "int8")
    idx = np.random.default_rng(4).integers(0, cfg.codebook_size,
                                            (INT8_REQUESTS, F))
    qs = fz.bind_combo(cbs, torch.from_numpy(idx).to(dev), cfg.vsa)

    def serve(c, n, warm=False):
        spec = engine.ServeSpec("tab07_2x2grid_int8", codebooks=qt, cfg=c)
        eng = engine.Engine(spec, slots=ENGINE_ROWS, generator=7, device=dev)
        if not warm:
            sim.launches = 0  # this path's run starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = [eng.submit(qs[i]) for i in range(n)]
        done = {r.id: r for r in eng.drain()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = sim.launches  # ... and ends here
        got = np.stack([done[i].factorization.indices[0] for i in ids])
        iters = np.array([done[i].iterations[0] for i in ids])
        return eng, (got == idx[:n]).all(1), iters, wall, launches

    serve(cfg, 16, warm=True)  # cuFFT plans, the kernel's first load
    eng, right, iters, wall, launches = serve(cfg, INT8_REQUESTS)
    if launches != F * eng.sweeps_total or launches == 0:
        raise AssertionError(f"similarity launches {launches} != F x "
                             f"sweeps_total = {F} x {eng.sweeps_total}")
    if eng.kernel_launches_per_sweep != F:
        raise AssertionError("kernel_launches_per_sweep "
                             f"{eng.kernel_launches_per_sweep} != {F}")
    acc, mean_it = float(right.mean()), float(iters.mean())
    snap = eng.snapshot()
    print(f"phase 7: Tab. VII 2x2Grid int8 (F={F}, M=10, D=1024, B=4, noise "
          f"0.3, restarts every 20) on {torch.cuda.get_device_name(0)}: "
          f"{INT8_REQUESTS} requests through Engine(slots={ENGINE_ROWS}): "
          f"accuracy {acc:.4f}, mean iterations {mean_it:.2f}; "
          f"sweeps_per_step={eng.sweeps_per_step} "
          f"sweeps_total={eng.sweeps_total} similarity launches={launches} "
          f"steps={eng.steps_total}; {INT8_REQUESTS / wall:.1f} requests/s, "
          f"p50 {snap['latency_p50_ms']:.3f} ms, p99 "
          f"{snap['latency_p99_ms']:.3f} ms, wall {wall * 1e3:.2f} ms",
          flush=True)
    if acc < 0.93 or not 12 <= mean_it <= 21:
        raise AssertionError(f"int8 serving: accuracy {acc} (needs >= 0.93) "
                             f"or mean iterations {mean_it} (needs 12..21)")
    half = ENGINE_ROWS
    quiet = dataclasses.replace(cfg, noise_std=0.0, restart_every=0)
    _, right0, iters0, _, _ = serve(quiet, half)
    acc_noisy, acc0 = float(right[:half].mean()), float(right0.mean())
    print(f"phase 7: the first {half} problems without noise and restarts: "
          f"accuracy {acc0:.4f} (mean iterations {float(iters0.mean()):.2f})"
          f" against {acc_noisy:.4f} with them", flush=True)
    if acc_noisy - acc0 < 0.06:
        raise AssertionError(f"stochasticity gained {acc_noisy - acc0:.4f} "
                             "< 0.06 in accuracy")
    # Where a sweep's wall goes: 20 sweeps of a full slot batch, with the
    # noise draws and without them (host clock, synchronised).
    keys = fz.draw_keys(3, ENGINE_ROWS).to(dev)
    per = {}
    for name, c in (("stochastic", cfg), ("noise-free", quiet)):
        res = fz.make_resonator(qt, c)
        st = res.init(qs[:ENGINE_ROWS], keys)
        st = res.sweep(qs[:ENGINE_ROWS], st)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            st = res.sweep(qs[:ENGINE_ROWS], st)
        torch.cuda.synchronize()
        per[name] = (time.perf_counter() - t0) / 20 * 1e3
    print(f"phase 7: one sweep of {ENGINE_ROWS} rows (host wall, sweeps 2-21): "
          f"{per['stochastic']:.3f} ms stochastic, {per['noise-free']:.3f} ms "
          f"noise-free; the engine run averaged "
          f"{wall * 1e3 / eng.sweeps_total:.3f} ms of wall per sweep", flush=True)
    return launches


def phase_int8_factorize(torch, dev, sim):
    """Tab. VIII/IX F = 3 deterministic int8 factorize_batch on the card
    against the CPU, on the paper tables' problems (query noise 0.3 std).

    A row that converges within FAST_SWEEPS sweeps on the CPU (the paper's
    regime, most rows) is well conditioned: the card must give its indices
    and converged flag exactly and its iterations within 1.  A row that
    hovers for longer follows a near-chaotic trajectory that the last bit
    of a score can redirect (fp32 sums in another order on the card): those
    are counted and reported, and may be at most 5 % of the rows."""
    import numpy as np

    from repro_torch.core import factorizer as fz
    from repro_torch.core import vsa
    from repro_torch.device import generator

    cfg = tab_cfg(fz, vsa, factors=3, noise=0.0, restarts=0)
    cbs = fz.make_codebooks(generator(1), cfg, device="cpu")
    rng = np.random.default_rng(6)
    idx = rng.integers(0, cfg.codebook_size, (ENGINE_ROWS, 3))
    qs = fz.bind_combo(cbs, torch.from_numpy(idx), cfg.vsa)
    qs = qs + 0.3 * qs.std() * torch.from_numpy(
        rng.standard_normal(tuple(qs.shape)).astype(np.float32))
    qt = fz.quantize_codebooks(cbs, "int8")
    sim.launches = 0
    res = fz.factorize_batch(qs, qt, 0, cfg, device=dev)
    torch.cuda.synchronize()
    launches = sim.launches
    if launches != 3 * int(res.iterations.max()):
        raise AssertionError(f"similarity launches {launches} != 3 x sweeps")
    plain = fz.factorize_batch(qs, qt, 0, cfg, device="cpu")
    res = fz.FactorizerResult(*(t.cpu() for t in res))
    fast = plain.iterations <= FAST_SWEEPS
    for field in ("indices", "converged"):
        if not torch.equal(getattr(res, field)[fast],
                           getattr(plain, field)[fast]):
            raise AssertionError(f"F=3 int8: CUDA and CPU {field} differ on "
                                 f"rows that converge within {FAST_SWEEPS}")
    drift = (res.iterations - plain.iterations).abs()
    if int(drift[fast].max()) > 1:
        raise AssertionError(f"F=3 int8: iterations differ by "
                             f"{int(drift[fast].max())} > 1 on a fast row")
    slow = int((~fast).sum())
    if slow > 0.05 * ENGINE_ROWS:
        raise AssertionError(f"F=3 int8: {slow} rows need more than "
                             f"{FAST_SWEEPS} sweeps")
    acc = float((res.indices.numpy() == idx).all(1).mean())
    acc_cpu = float((plain.indices.numpy() == idx).all(1).mean())
    same = (res.indices == plain.indices).all(1) & (res.converged
                                                     == plain.converged)
    print(f"phase 8: Tab. VIII/IX F=3 deterministic int8 factorize_batch at "
          f"N={ENGINE_ROWS} (query noise 0.3 std): accuracy {acc:.4f} on the "
          f"card, {acc_cpu:.4f} on the CPU; {int(res.iterations.max())} "
          f"sweeps, {launches} similarity launches; the {int(fast.sum())} "
          f"rows converging within {FAST_SWEEPS} sweeps: indices and "
          f"converged equal, iterations within {int(drift[fast].max())}; "
          f"the {slow} slower rows: {int(same[~fast].sum())} decode the same, "
          f"iterations within {int(drift.max())}", flush=True)
    return launches


def phase_rng(torch, dev, card):
    """The counter-based RNG on the card against the CPU."""
    from repro_torch.core import factorizer as fz
    from repro_torch.core import rng

    keys = fz.draw_keys(9, ENGINE_ROWS)
    sweep = torch.arange(ENGINE_ROWS) % 100
    worst = 0.0
    for tag in (rng.SCORES, rng.PROJECTION, rng.RESTART):
        if not torch.equal(rng.bits(keys.to(dev), sweep.to(dev), tag, 4,
                                    1024).cpu(),
                           rng.bits(keys, sweep, tag, 4, 1024)):
            raise AssertionError(f"RNG words of tag {tag} differ between "
                                 "the card and the CPU")
        z = rng.normal(keys.to(dev), sweep.to(dev), tag, 4, 1024).cpu()
        worst = max(worst, (z - rng.normal(keys, sweep, tag, 4, 1024))
                    .abs().max().item())
    if worst > 1e-6:
        raise AssertionError(f"RNG normals differ by {worst} > 1e-6")
    kd, sd = keys.to(dev), sweep.to(dev)
    draw = lambda: rng.normal(kd, sd, rng.SCORES, 4, 10)
    t_draw, t_dev = cuda_ms(draw, 50), graph_ms(draw, 10)
    print(f"phase 9: Philox-4x32-10 words bit-equal on the card and the CPU "
          f"(3 tags, 256 rows x 4 factors x 1024); normals within "
          f"{worst:.3g}; one score-noise draw [256, 4, 10] takes "
          f"{t_draw:.4f} ms per call back to back, {t_dev:.4f} ms of device "
          f"time in a CUDA graph, on {card}", flush=True)


def phase_sim_timing(torch, dev, sim, card):
    """similarity_int8, its plain version and a library matmul over a
    pre-dequantized codebook, in turns: device time from CUDA-graph replay
    (what the JSON line reports), and per call back to back, host
    included."""
    from repro_torch.core.quantization import quantize
    from repro_torch.kernels.similarity import kernel as k

    gen = torch.Generator().manual_seed(23)
    out = {}
    for n, m, d in ((ENGINE_ROWS, 10, 1024), (128, 257, 1024)):
        q = torch.randn((n, d), generator=gen).to(dev)
        w = quantize(torch.randn((m, d), generator=gen)).to(dev)
        w_deq = w.dequantize()
        kern = lambda: k.similarity_int8(q, w.values, w.scale)
        plain = lambda: sim.similarity_int8_ref(q, w.values, w.scale)
        library = lambda: q @ w_deq.T
        p1, k1, k2, p2, l1, l2 = (graph_ms(plain), graph_ms(kern),
                                  graph_ms(kern), graph_ms(plain),
                                  graph_ms(library), graph_ms(library))
        hk, hp, hl = cuda_ms(kern), cuda_ms(plain), cuda_ms(library)
        b_ms, b_by = sim_bound(n, m, d)
        out[(n, m, d)] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                          "bound_ms": b_ms, "bound_by": b_by,
                          "library_ms": min(l1, l2)}
        print(f"phase 10: similarity_int8 at N, M, D = {n}, {m}, {d} on "
              f"{card}: device time (CUDA graph) kernel {k1:.5f}/{k2:.5f} ms, "
              f"plain {p1:.5f}/{p2:.5f} ms, library (q @ W_deq.T, fp32, TF32 "
              f"off) {l1:.5f}/{l2:.5f} ms, bound {b_ms:.5f} ms ({b_by}), "
              f"kernel at {b_ms / min(k1, k2):.1%} of the bound; per call "
              f"back to back, host included: kernel {hk:.4f} ms, plain "
              f"{hp:.4f} ms, library {hl:.4f} ms", flush=True)
    return out[(ENGINE_ROWS, 10, 1024)]


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
    from repro_torch.kernels.similarity import ops as sim

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
    sim_err = phase_similarity(torch, dev, sim)
    sim_launches = phase_int8_engine(torch, dev, sim)
    phase_int8_factorize(torch, dev, sim)
    phase_rng(torch, dev, card)
    sim_times = phase_sim_timing(torch, dev, sim, card)

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
        {"name": "similarity_int8", "route": "cuda",
         "source": "src/repro_torch/kernels/similarity/csrc/similarity_int8.cu",
         "replaces": "src/repro/kernels/similarity/kernel.py:29",
         "launches": sim_launches, "max_abs_err": sim_err, **sim_times},
    ]
    print("kernels: " + ", ".join(
        f"{kd['name']} ({kd['launches']} launches on its path, max |kernel "
        f"- plain| {kd['max_abs_err']:.3g})" for kd in kernels), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
