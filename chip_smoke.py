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
  5. times the dense and masked kernels, their plain versions and their
     bound at N = 256 (device time from CUDA-graph replay, in turns, and per
     call with the host included), and the dense kernel at each row ceiling;
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
 11. holds the paged decode attention kernel ``flash_decode`` against its
     plain version at the reference test's block-boundary cases, at the
     serving shape of Llama 3.2 3B, and at rows on and next to the split
     boundaries of 2, 4 and 8 blocks a cluster, bf16 and int8 pools (2e-5);
 12. serves Llama 3.2 3B at full width (28 layers, d 3072, GQA 24/8, vocab
     128256; random bf16 weights drawn on the card) through
     ``LMEngine(slots=32, paged bs 16, chunk 64)``: 64 greedy requests of
     16-512 prompt tokens and 32 new tokens each; every request complete,
     no non-finite logit, flash_decode launches = 28 x decode steps; wall,
     rates, latency, the spans and the decode step's host and device time;
 13. the greedy contract: 8 prompts through ``ServeEngine`` with the kernel
     and with the dense path may diverge only at near ties;
 14. the int8 KV pool: 16 requests through ``LMEngine`` with the same
     checks, and the greedy contract on 4 prompts;
 15. times flash_decode, its plain version, its bound and one SDPA call at
     the serving shape, bf16 and int8 (CUDA-graph replay), with a cold L2
     (input sets rotated) and warm; prints the split count and the time at
     each forced one; the kernel must be no slower than SDPA cold and read
     at no more than 105 % of its bound;
 16. holds the model-shard (LOCAL) resonator kernel against its plain
     version, bitwise, at the reference test's shapes and at the sharded
     serving shape (64 rows a shard, F = 3, M_loc = 5, D = 2048), and two
     shards' gathered sum against the masked kernel;
 17. serves the 512 LVRF rows through ``ShardedEngine`` on a 4 x 2 mesh of
     logical shards on the card, rows placement (one local launch per shard
     per sweep, F + 1 model reductions), then replicated placement, each
     bitwise equal to ``Engine(slots=256)`` on the same requests; then 256
     Tab. VII requests at fp32 (unitary, stochastic) under rows placement
     against ``Engine``, printing the rows that differ;
 18. times the LOCAL kernel, its plain version and its bound at the sharded
     serving shape (CUDA-graph replay);
 19. holds both circular convolution kernels against their plain versions
     at the reference test's shapes (fp32 and bf16, the reference's
     tolerances), at both of MIMONet's serving shapes (4096 and 8192 rows of
     L = 256, S = 2 and S = 4), and on broadcast operands read as views
     (MIMONet's bind and unbind, x shared over streams, neither; one y row
     shared at the reference's shapes; groups around the tensor-core mode's
     threshold), in both of circconv_rows' modes;
 20. serves MIMONet at full width (D = 2048, B = 8, hidden 2048 x 2, random
     fp32 weights) through ``vsa.bind(impl="pallas")``: 4096 RAVEN panels at
     S = 2 (8 batches of 256 items), then at S = 4 (4 batches); exactly 2
     rows launches a batch, logits, loss and accuracies against the same
     model with impl="fft", stream separation, an eager batch's device
     operations and peak allocation beyond its inputs, and a bind -> mean ->
     unbind round trip through the kernel;
 21. the HRR corner: one item at S = 1, B = 1 (L = 2048) through ``apply``,
     exactly 2 single-row launches, logits against the fft run;
 22. times circconv_rows at MIMONet's bind and unbind shapes (S = 2, 4) and
     on 4096 independent rows, and circconv_single at L = 2048 beside an
     empty kernel: each kernel, its plain version, its bound (distinct
     bytes against an FFT's operations) and the FFT bind, and
     vsa.bind / vsa.unbind with impl="pallas" against impl="fft"
     (CUDA-graph replay, in turns); a kernel below its bound raises;
 23. NVSA abduction at ``NVSAConfig()``'s widths (D = 1024, 4 blocks, F =
     3, M = 10 with the 5/6/10 mask): (a) the masked kernel at NVSA's
     bipolar shape (N = 256, D = 1024, a cluster of 4) bitwise against its
     plain version and timed beside its bound; (b) 256 RAVEN tasks with
     oracle queries (target queries plus 0.3 x std noise) as 256 requests
     through ``Engine(slots=256)`` on the default unitary stochastic config:
     every request answered, finite sims, converged > 0.9, accuracy >= 0.85,
     RPM answers/s and latency, the sweep bursts' host wall and the device
     busy time; solve's factorize-and-abduce stage over the same tasks with
     the same keys: equal answers, and equal indices and iterations on the
     rows settled within 5 sweeps; (c) the same tasks' 4096 rendered panels
     perceived on the card by a random CNN (against the CPU, atol 1e-4)
     and served; (d) the bipolar fused variant on +-1 target queries:
     masked launches = sweeps, every converged query decoded right, 32
     requests replayed on the CPU (factorization bitwise, answers equal,
     sims at atol 1e-5); (e) the adSCH-planned stream (``build_pipeline``, depth 2)
     over 8 batches of 8 tasks equal to per-batch ``solve``;
 24. the supervised runtime: one ``Runtime(obs=Recorder())`` over three
     engines at full width, ``Engine(slots=256)`` for LVRF (fused sweep,
     a measured-cost ``RetunePolicy`` that re-tunes 256 -> 128 slots
     mid-run), ``Engine(slots=256)`` for NVSA (``NVSAConfig()``) and
     ``LMEngine(slots=8, paged bs 16, chunk 64)`` for Llama 3.2 3B (28
     layers, random bf16 weights): (a) phase 3's 512 LVRF rows plus 8
     junk rows, 64 RAVEN tasks and 8 prompts of 16-128 tokens (16 new
     each), submitted from the main thread in 8 interleaved waves, every
     key pinned: LVRF bitwise equal to a bare ``Engine``, NVSA to the
     unitary contract, LM tokens to solo decodes (near ties excepted),
     re-tunes >= 1, resonator_step_batch launches = sweeps + the re-tune's
     timed sweeps, flash_decode launches = 28 x decode steps; (b) the
     reference test's chaos plans (seeds 101/202/303) over fresh engines:
     every future resolved or a structured fault, a deadline_s=0 request
     missed, every engine serving, faults injected and recovered, a NaN
     state corruption caught by ``health_check`` on the card, survivors
     meeting (a)'s contracts, and zero-rate ``ChaosEngine``s giving (a)'s
     results; (c) an overload of the LVRF engine (512 best-effort rows to
     max_iters, then 64 interactive rows): interactive SLO attainment >=
     0.9 under the ``FleetController``, beside the FIFO baseline's; (d)
     the span attribution of (a): every request's buckets cover >= 95 % of
     its wall; requests/s, p50/p99 and bucket totals per engine, and the
     Chrome trace in ``chiprun_out/runtime_trace.json``;
 25. prints one JSON line describing every kernel, the card line, and as
     the last line ``{"ok": true, "device": {...}}``.

A failed phase raises, and the script exits nonzero.  Without a CUDA device,
or without the repository beside it, it exits nonzero before any result.
"""
from __future__ import annotations

import itertools
import json
import math
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


def sync(torch, dev):
    """Wait for the card (no-op on the CPU, where phases are rehearsed)."""
    if dev.type == "cuda":
        torch.cuda.synchronize()


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


def bound(n: int, masked: bool, d: int = D) -> tuple:
    """Least time (ms) of one sweep at N = n (width d) and what bounds it:
    each input read once, each output written once; the scores and
    projection FMAs, the unbind products, at the fp32 rate."""
    nbytes = 4 * (n * d + n * F * d + F * M * d + n * F * M + n * F * d
                  + (F * M if masked else 0))
    flops = 4 * n * F * M * d + n * F * d * (F + 1)
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
    """Per-sweep kernel and plain-version times at the engine's shape:
    device time from CUDA-graph replay in turns (plain, kernel, kernel,
    plain), and per call back to back, host included."""
    from repro_torch.kernels.resonator_step import kernel as k

    gen = torch.Generator().manual_seed(5)
    qs = bipolar(gen, (ENGINE_ROWS, D), dev)
    est = bipolar(gen, (ENGINE_ROWS, F, D), dev)
    cbs = bipolar(gen, (F, M, D), dev)
    mask = torch.stack([torch.arange(M) < s for s in (5, 6, 10)]).to(dev)
    times = {}
    launches = (rs.launches, rs.masked_launches)
    for name, kern, plain, masked in (
            ("resonator_step_batch",
             lambda: k.resonator_step_batch(qs, est, cbs),
             lambda: ref.resonator_step_batch_ref(qs, est, cbs), False),
            ("resonator_step_batch_masked",
             lambda: k.resonator_step_batch_masked(qs, est, cbs, mask),
             lambda: ref.resonator_step_batch_masked_ref(qs, est, cbs, mask),
             True)):
        # plain, kernel, kernel, plain: the two versions in turns
        p1, k1, k2, p2 = (graph_ms(plain), graph_ms(kern), graph_ms(kern),
                          graph_ms(plain))
        hk, hp = cuda_ms(kern), cuda_ms(plain)
        b_ms, b_by = bound(ENGINE_ROWS, masked)
        times[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                       "bound_ms": b_ms, "bound_by": b_by}
        print(f"phase 5: {name} at N={ENGINE_ROWS} F={F} M={M} D={D} on "
              f"{card}: device time (CUDA graph) kernel {k1:.5f}/{k2:.5f} ms, "
              f"plain {p1:.5f}/{p2:.5f} ms, bound {b_ms:.5f} ms ({b_by}), "
              f"kernel at {b_ms / min(k1, k2):.1%} of the bound; per call "
              f"back to back, host included: kernel {hk:.4f} ms, plain "
              f"{hp:.4f} ms", flush=True)
    rows_line = []
    for tn in (1, 2, 4, 8, 16):
        geo = k.launch_geometry(
            ENGINE_ROWS, F, M, D, tn,
            torch.cuda.get_device_properties(dev).multi_processor_count)
        fn = lambda: k.resonator_step_batch(qs, est, cbs, tn=tn)
        rows_line.append(f"tn={tn} {geo}: {graph_ms(fn):.5f} ms (CUDA graph), "
                         f"{cuda_ms(fn):.4f} ms per call back to back")
    rs.launches, rs.masked_launches = launches  # not the main path's
    print(f"phase 5: dense kernel by rows per block (tn ceiling; geometry "
          f"as launch_geometry returns it) on {card}: " + "; ".join(rows_line),
          flush=True)
    return times


# flash_decode: the reference test's shapes (tests/test_flash_decode.py:
# B, G, rep, dh = 3, 2, 2, 16, bs 8, W 3, every boundary case, and rows of
# length zero) and the serving shape of Llama 3.2 3B (32 slots, 8 KV heads,
# rep 3, dh 128, bs 16); the reference's tolerance for its kernel.
FD_LENS = ((1, 1, 1), (3, 8, 9), (8, 16, 24), (9, 17, 23), (16, 24, 8),
           (24, 24, 24), (0, 5, 0))
FD_ATOL = FD_RTOL = 2e-5
FD_SPLITS = (2, 4, 8)  # forced split counts held against the plain version
# Phase 15's cold timing: input sets rotated in one graph, so that a round's
# live K/V exceeds twice the H100's 50 MB L2 (data sheet).
FD_COLD_SETS = {"bf16": 4, "int8": 8}
L2_BYTES = 50e6
LM_SLOTS, LM_BLOCK, LM_CHUNK = 32, 16, 64
LM_REQUESTS, LM_NEW = 64, 32
LM_PROMPTS = (16, 512)  # prompt lengths, uniform, inclusive
# Room for the longest prompt, its 32 tokens and the overshoot of an adSCH
# decode burst (14 steps at 32 slots): 560 positions, 35 blocks a slot.
LM_MAX_LEN = 560
INT8_LM_REQUESTS = 16
# The greedy contract (phases 13, 14).  The kernel and the dense path round
# attention differently in the last fp32 bits, which flips the bf16 rounding
# of a few attention outputs per layer and moves the bf16 logits by a few
# ulps of a row's top logit.  DEV_ULPS bounds that move at every (row, step)
# pair; the readings it was set from are in PERF.md (PR 13).  A stream that
# takes another token than the dense run then does so at a near tie: the
# dense run's top-2 gap is at most 2 * DEV_ULPS.
DEV_ULPS = 8
# The negative control: the kernel run with the newest position of every row
# left out of attention must break the contract within this many steps.
FAULT_PROMPTS, FAULT_STEPS = 4, 4


def fd_inputs(torch, b, g, rep, dh, bs, width, kv_dtype, seed, dev,
              q_scale=1.0):
    """q (normal, times `q_scale`), a random pool and a table giving each
    row `width` distinct blocks (the last physical block is the trash
    block)."""
    import numpy as np

    from repro_torch.nn.layers import _quant_kv

    rng = np.random.default_rng(seed)
    nbp = b * width + 1
    q = torch.from_numpy(rng.standard_normal((b, g, rep, dh), np.float32)
                         * np.float32(q_scale))
    pool = {}
    for name in ("k", "v"):
        t = torch.from_numpy(rng.standard_normal((nbp, bs, g, dh),
                                                 np.float32)).to(dev)
        if kv_dtype == "int8":
            pool[name], pool[name + "_scale"] = _quant_kv(t)
        else:
            pool[name] = t.to(torch.bfloat16)
    table = torch.from_numpy(rng.permutation(b * width).astype(np.int32)
                             .reshape(b, width))
    return q.to(dev), pool, table.to(dev)


def phase_flash_decode(torch, dev, fd):
    """flash_decode against its plain version on the card: the reference
    test's boundary cases, the serving shape, and rows on and next to the
    split boundaries at 2, 4 and 8 blocks a cluster; bf16 and int8 pools.
    Returns the max |kernel - plain| per pool dtype."""
    import numpy as np

    from repro_torch.kernels.flash_decode import kernel as fdk

    err = {"bf16": 0.0, "int8": 0.0}

    def check(kv, q, pool, table, lens, what, splits=None):
        before = fd.launches
        if splits is None:
            got = fd.flash_decode(q, pool, table, lens)
        else:
            got = fdk.flash_decode(q, pool["k"], pool["v"], table, lens,
                                   k_scale=pool.get("k_scale"),
                                   v_scale=pool.get("v_scale"), splits=splits)
        want = fd.flash_decode_plain(q, pool["k"], pool["v"], table, lens,
                                     pool.get("k_scale"), pool.get("v_scale"))
        torch.cuda.synchronize()
        if fd.launches != before + 1:
            raise AssertionError(f"flash_decode at {what}: "
                                 f"{fd.launches - before} launches, not 1")
        diff = (got - want).abs()
        err[kv] = max(err[kv], diff.max().item())
        if not bool((diff <= FD_ATOL + FD_RTOL * want.abs()).all()):
            raise AssertionError(f"flash_decode ({kv}) at {what}: max "
                                 f"|kernel - plain| {diff.max().item()}")
        zero = lens == 0
        if zero.any() and not bool((got[zero] == 0).all()):
            raise AssertionError(f"flash_decode ({kv}) at {what}: a row of "
                                 "length 0 is not exact zeros")
        return diff.max().item()

    for kv in ("bf16", "int8"):
        for lens in FD_LENS:
            q, pool, table = fd_inputs(torch, 3, 2, 2, 16, 8, 3, kv,
                                       sum(lens), dev)
            check(kv, q, pool, table,
                  torch.tensor(lens, dtype=torch.int32, device=dev),
                  f"lens {lens}")
        width = -(-LM_MAX_LEN // LM_BLOCK)
        # q pre-scaled by dh^-0.5, as the attention layer passes it
        q, pool, table = fd_inputs(torch, LM_SLOTS, 8, 3, 128, LM_BLOCK,
                                   width, kv, 13, dev, 128 ** -0.5)
        lens = np.random.default_rng(14).integers(1, LM_MAX_LEN + 1, LM_SLOTS)
        lens[:2] = (0, LM_MAX_LEN)
        d = check(kv, q, pool, table,
                  torch.from_numpy(lens.astype(np.int32)).to(dev),
                  "the serving shape")
        span = fdk.tile(128, 3)
        rows = 0
        for splits in FD_SPLITS:
            edge = fdk.split_edges(span, splits, width * LM_BLOCK)
            q, pool, table = fd_inputs(torch, len(edge), 8, 3, 128, LM_BLOCK,
                                       width, kv, 20 + splits, dev,
                                       128 ** -0.5)
            check(kv, q, pool, table,
                  torch.tensor(edge, dtype=torch.int32, device=dev),
                  f"split boundaries, {splits} blocks a cluster", splits)
            rows += len(edge)
        print(f"phase 11: flash_decode ({kv} pool) within atol {FD_ATOL}, "
              f"rtol {FD_RTOL} of its plain version at every boundary case "
              f"of B, G, rep, dh = 3, 2, 2, 16, bs 8, W 3 (rows of length 0 "
              f"exact zeros), at the serving shape B={LM_SLOTS} G=8 rep=3 "
              f"dh=128 bs={LM_BLOCK} W={width}, and at {rows} rows on and "
              f"next to the split boundaries (span {span}) at "
              f"{', '.join(map(str, FD_SPLITS))} blocks a cluster: max "
              f"|kernel - plain| {err[kv]:.3g} ({d:.3g} at the serving "
              f"shape)", flush=True)
    return err


def lm_prompts(n, vocab, seed=31):
    """`n` prompts of lengths uniform in LM_PROMPTS, random token ids."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(LM_PROMPTS[0], LM_PROMPTS[1] + 1, n)
    return [rng.integers(0, vocab, int(k)) for k in lens]


def _nan_tap(torch, serve):
    """Count non-finite logits of the active rows of every decode step, on
    the device (no extra sync)."""
    bad = torch.zeros((), dtype=torch.int64, device=serve.device)
    inner = serve.step

    def step(*args, **kwargs):
        out = inner(*args, **kwargs)
        if out is not None:
            act = torch.from_numpy(serve.active.copy()).to(serve.device)
            bad.add_(((~torch.isfinite(serve.last_logits))
                      & act[:, None]).sum())
        return out

    serve.step = step
    return bad


def serve_lm(torch, dev, cfg, model, prompts, fd, tag):
    """Drain `prompts` through LMEngine on the card; check every request and
    the launch count; return the run's numbers."""
    from repro_torch import obs, runtime
    from repro_torch.lm.paging import PagedConfig

    rec = obs.Recorder()
    eng = runtime.LMEngine(
        cfg, model, slots=LM_SLOTS, max_len=LM_MAX_LEN, obs=rec, device=dev,
        paged=PagedConfig(block_size=LM_BLOCK, prefill_chunk=LM_CHUNK))
    bad = _nan_tap(torch, eng.serve)
    torch.cuda.synchronize()
    fd.launches = 0  # this path's run starts here
    t0 = time.perf_counter()
    ids = [eng.submit(p, max_new_tokens=LM_NEW) for p in prompts]
    done = {r.id: r for r in eng.drain()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fd.launches  # ... and ends here
    short = [i for i in ids if len(done[i].tokens) != LM_NEW
             or done[i].truncated]
    if short:
        raise AssertionError(f"{tag}: {len(short)} requests without "
                             f"{LM_NEW} tokens or truncated")
    if int(bad):
        raise AssertionError(f"{tag}: {int(bad)} non-finite logits")
    dispatches = eng.serve.decode_dispatches
    if launches != cfg.n_layers * dispatches or launches == 0:
        raise AssertionError(f"{tag}: flash_decode launches {launches} != "
                             f"{cfg.n_layers} x {dispatches} decode steps")
    spent: dict = {}
    for sp in rec.spans.snapshot():
        if sp.duration is not None:
            spent[sp.name] = spent.get(sp.name, 0.0) + sp.duration
    snap = eng.snapshot()
    return {"wall": wall, "launches": launches, "dispatches": dispatches,
            "snap": snap, "spent": spent, "engine": eng,
            "tokens": {i: done[i].tokens for i in ids}}


def device_profile(torch, fn, reps: int = 3) -> str:
    """A profiler trace of ``reps`` eager calls of ``fn``: device operations
    and device busy time per call, and the costliest kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return "the profiler recorded no device events"
    busy = {e.key: getattr(e, "self_device_time_total", 0.0) / (reps * 1e3)
            for e in kern}
    calls = sum(e.count for e in kern) / reps
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
    total = sum(busy.values())
    return (f"{calls:.0f} device operations, {total:.3f} ms device busy; "
            "costliest: " + "; ".join(f"{k[:60]} {v:.3f} ms ({v / total:.0%})"
                                      for k, v in top))


def lm_breakdown(torch, dev, cfg, model, lens, fd, card):
    """Where a decode step and a prefill chunk spend their time, at the
    run's shape (LM_SLOTS active slots at `lens`; one LM_CHUNK-token chunk
    at position 256) on a pool of the run's size: device time from
    CUDA-graph replay (the kernels back to back, no host), host wall of an
    eager call ended by a sync, and a profiler trace of the eager decode
    step (kernels launched, device busy time, the costliest kernels).
    Returns the decode step's device ms."""
    import numpy as np

    from repro_torch.lm import model as lm_model
    from repro_torch.lm.paging import BlockTablePool

    width = -(-LM_MAX_LEN // LM_BLOCK)
    blocks = BlockTablePool(LM_SLOTS * width, LM_BLOCK, LM_SLOTS, width)
    for s, n in enumerate(lens):
        blocks.ensure(s, int(n) + 1)
    pool = lm_model.init_pool(cfg, LM_SLOTS * width, LM_BLOCK, dev)
    table = torch.from_numpy(blocks.table()).to(dev)
    kv_lens = torch.from_numpy(np.asarray(lens, np.int32)).to(dev)
    tokens = torch.ones((LM_SLOTS, 1), dtype=torch.int64, device=dev)
    active = torch.ones(LM_SLOTS, dtype=torch.bool, device=dev)
    chunk = torch.ones((1, LM_CHUNK), dtype=torch.int64, device=dev)
    step = lambda: lm_model.decode_step_paged(model, cfg, pool, table,
                                              kv_lens, tokens, active)
    prefill = lambda: lm_model.prefill_chunk_paged(model, cfg, pool, table[0],
                                                   256, chunk, LM_CHUNK)
    launches = fd.launches
    out = {}
    for name, fn in (("decode step", step), ("prefill chunk", prefill)):
        dev_ms = graph_ms(fn, iters=5, replays=4)
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
            torch.cuda.synchronize()
        out[name] = (dev_ms, (time.perf_counter() - t0) / 5 * 1e3)
    prof = device_profile(torch, step)
    fd.launches = launches  # these launches are not the main path's
    print(f"phase 12: breakdown on {card}: decode step ({LM_SLOTS} slots, "
          f"mean length {np.mean(lens):.0f}) device {out['decode step'][0]:.3f} "
          f"ms (CUDA graph), host wall eager {out['decode step'][1]:.3f} ms; "
          f"prefill chunk ({LM_CHUNK} tokens at position 256) device "
          f"{out['prefill chunk'][0]:.3f} ms, host wall eager "
          f"{out['prefill chunk'][1]:.3f} ms", flush=True)
    print(f"phase 12: profiler, eager decode step: {prof}", flush=True)
    del pool


def phase_lm_serving(torch, dev, fd, card):
    """Llama 3.2 3B at full width, random bf16 weights, through LMEngine on
    the card: 64 greedy requests, then the greedy contract, then the int8
    KV pool."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.nn import transformer as T

    cfg = registry.get("llama3.2-3b").full()
    t0 = time.perf_counter()
    model = T.init(cfg, 0, dev)
    torch.cuda.synchronize()
    n_params = T.param_count(model)
    print(f"phase 12: {cfg.name}: {n_params:,} parameters, random bf16 "
          f"weights drawn on the card in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 1e9:.2f} GB)", flush=True)
    prompts = lm_prompts(LM_REQUESTS, cfg.vocab)
    serve_lm(torch, dev, cfg, model, prompts[:2], fd, "warm-up")
    run = serve_lm(torch, dev, cfg, model, prompts, fd, "bf16 run")
    snap, spent, wall = run["snap"], run["spent"], run["wall"]
    steps = run["dispatches"]
    pool_gb = sum(t.numel() * t.element_size()
                  for t in run["engine"].serve.pool.values()) / 1e9
    host_ms = spent["decode-burst"] / steps * 1e3
    print(f"phase 12: {LM_REQUESTS} greedy requests (prompts {LM_PROMPTS[0]}-"
          f"{LM_PROMPTS[1]} tokens, {LM_NEW} new each) through LMEngine("
          f"slots={LM_SLOTS}, paged bs={LM_BLOCK}, chunk={LM_CHUNK}, "
          f"max_len={LM_MAX_LEN}; KV pool {pool_gb:.2f} GB) on {card}: all "
          f"{LM_NEW} tokens, none truncated, no non-finite logit; wall "
          f"{wall * 1e3:.1f} ms, {LM_REQUESTS / wall:.2f} requests/s, "
          f"{LM_REQUESTS * LM_NEW / wall:.1f} generated tokens/s, p50 "
          f"{snap['latency_p50_ms']:.1f} ms, p99 {snap['latency_p99_ms']:.1f}"
          f" ms; spans: prefill (fill) {spent['fill'] * 1e3:.1f} ms in "
          f"{run['engine'].serve.prefill_dispatches} chunks, decode "
          f"{spent['decode-burst'] * 1e3:.1f} ms in {steps} steps "
          f"(decode_per_step={run['engine'].decode_per_step}), retire "
          f"{spent['retire'] * 1e3:.1f} ms; host wall per decode step "
          f"{host_ms:.3f} ms; flash_decode launches {run['launches']} = "
          f"{cfg.n_layers} x {steps}", flush=True)
    # mid-decode lengths of the first slot batch: the timing shape
    lens = [min(len(p) + LM_NEW // 2, LM_MAX_LEN - 1)
            for p in prompts[:LM_SLOTS]]
    lm_breakdown(torch, dev, cfg, model, lens, fd, card)
    greedy_contract(torch, dev, cfg, model, prompts[:8], "bf16", 13)
    fault_control(torch, dev, cfg, model, prompts[:FAULT_PROMPTS], fd)
    launches = {"bf16": run["launches"]}
    del run
    torch.cuda.empty_cache()

    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    run8 = serve_lm(torch, dev, cfg8, model, prompts[:INT8_LM_REQUESTS], fd,
                    "int8 run")
    launches["int8"] = run8["launches"]
    print(f"phase 14: int8 KV pool: {INT8_LM_REQUESTS} greedy requests "
          f"through the same LMEngine: all {LM_NEW} tokens, none truncated, "
          f"no non-finite logit; wall {run8['wall'] * 1e3:.1f} ms, "
          f"{INT8_LM_REQUESTS * LM_NEW / run8['wall']:.1f} generated "
          f"tokens/s; flash_decode launches {run8['launches']} = "
          f"{cfg.n_layers} x {run8['dispatches']}", flush=True)
    del run8
    torch.cuda.empty_cache()
    greedy_contract(torch, dev, cfg8, model, prompts[:4], "int8", 14)
    return launches, lens


def greedy_contract(torch, dev, cfg, model, prompts, kv, phase,
                    steps=LM_NEW):
    """The same prompts through two ServeEngines in lockstep, one with the
    kernel and one with the dense path (``use_flash=False``).

    The kernel run is fed the dense run's token at every step, so each of
    the len(prompts) x steps (row, step) pairs is compared, not only those
    before a stream first takes another token.  The contract: at every pair,
    max |dlogit| over the vocabulary is at most DEV_ULPS bf16 ulps of the
    dense row's top logit.  A pair where the tokens differ then has a dense
    top-2 gap of at most 2 * DEV_ULPS (the two logits moved by at most
    DEV_ULPS each): a near tie.  Returns (diverging streams, first step's
    max |dlogit|)."""
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.lm.paging import PagedConfig

    engs = []
    for use_flash in (True, False):
        eng = ServeEngine(cfg, model, len(prompts), LM_MAX_LEN, device=dev,
                          paged=PagedConfig(block_size=LM_BLOCK,
                                            prefill_chunk=LM_CHUNK,
                                            use_flash=use_flash))
        for s, p in enumerate(prompts):
            eng.add_request(s, p)
        engs.append(eng)
    kern, plain = engs
    diverged = set()
    d0 = worst = 0.0
    gaps, pinned = [], 0
    for step in range(steps):
        kern.step()
        plain.step()
        lk, lp = kern.last_logits, plain.last_logits
        top = torch.topk(lp, 2, dim=-1).values
        ulp = torch.exp2(torch.floor(torch.log2(top[:, 0].abs())) - 7)
        dev_ulps = ((lk - lp).abs().amax(-1) / ulp).cpu()
        gap = ((top[:, 0] - top[:, 1]) / ulp).cpu()
        if step == 0:
            d0 = (lk - lp).abs().max().item()
        worst = max(worst, float(dev_ulps.max()))
        if worst > DEV_ULPS:
            s = int(dev_ulps.argmax())
            raise AssertionError(
                f"greedy ({kv}): row {s} at step {step}: the kernel run's "
                f"logits differ from the dense run's by {worst:.2f} bf16 "
                f"ulps of the row's top logit > {DEV_ULPS}")
        pinned += int((gap > 2 * DEV_ULPS).sum())
        for s in range(len(prompts)):
            a = plain.generated[s][-1]
            if kern.generated[s][-1] != a:
                diverged.add(s)
                gaps.append(f"{float(gap[s]):.1f}")
                kern.generated[s][-1] = a  # the next step reads a's K/V
    print(f"phase {phase}: greedy contract ({kv} pool), {len(prompts)} "
          f"prompts x {steps} steps in lockstep, kernel against the dense "
          f"path, the kernel run fed the dense run's tokens: "
          f"{len(diverged)} of {len(prompts)} streams take another token at "
          f"some step, at {len(gaps)} (row, step) pairs with dense top-2 "
          f"gaps [{', '.join(gaps)}] bf16 ulps; max |dlogit| at any pair "
          f"{worst:.2f} ulps of the row's top logit (limit {DEV_ULPS}); "
          f"{pinned} of {len(prompts) * steps} pairs have a gap above "
          f"{2 * DEV_ULPS} ulps, where the limit pins the token; first "
          f"step's max |dlogit| {d0:.4g}", flush=True)
    return len(diverged), d0


def fault_control(torch, dev, cfg, model, prompts, fd):
    """The greedy contract must fail for a kernel that leaves the newest
    position of every row out of attention (an off-by-one in kv_lens): run
    it with that fault wrapped around ``fd.flash_decode`` and demand the
    failure."""
    orig = fd.flash_decode

    def dropped_newest(q, pool, table, kv_lens, *, use_flash=True):
        if use_flash:
            kv_lens = (kv_lens - 1).clamp_min(0)
        return orig(q, pool, table, kv_lens, use_flash=use_flash)

    launches = fd.launches
    fd.flash_decode = dropped_newest
    try:
        greedy_contract(torch, dev, cfg, model, prompts, "bf16, faulted", 13,
                        steps=FAULT_STEPS)
    except AssertionError as e:
        caught = str(e)
    else:
        raise AssertionError(
            "greedy contract: a kernel that drops the newest position of "
            f"every row passed {FAULT_STEPS} steps")
    finally:
        fd.flash_decode = orig
        fd.launches = launches  # these launches are not the main path's
    print(f"phase 13: negative control: with the newest position of every "
          f"row left out of the kernel's attention, the contract fails: "
          f"{caught}", flush=True)


def fd_bound(lens, g, rep, dh, quant: bool) -> tuple:
    """Least time (ms) of one flash_decode launch: the K/V (and scales) of
    the live positions read once, q, the table and lengths read once, the
    output written once, over the memory rate; its 4 * rep * dh * len
    FLOP per (row, KV head) at the fp32 rate."""
    live = int(sum(lens))
    elt = 1 if quant else 2
    kv = live * g * (2 * dh * elt + (2 * 4 if quant else 0))
    b = len(lens)
    nbytes = kv + 2 * 4 * b * g * rep * dh + 4 * b
    flops = 4 * live * g * rep * dh
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def rotate(fns):
    """A function that calls each of `fns` in turn, round after round: in a
    captured graph, consecutive launches read different inputs."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def phase_fd_timing(torch, dev, fd, lens, card):
    """flash_decode at the serving shape, its plain version, its bound and
    one library call (SDPA over K/V already gathered into a contiguous
    window with a length mask; the gather is not timed), bf16 and int8
    pools, device time from CUDA-graph replay, in turns.

    Cold: each graph rotates over FD_COLD_SETS input sets whose live K/V
    together exceed twice the L2, as in serving, where each layer reads its
    own slice of the pool; the bound share and the comparison with SDPA use
    these.  Warm: one input set, replayed, partly from the L2.  Also cold:
    every row at the mean length, and each forced split count."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import kernel as k

    width = -(-LM_MAX_LEN // LM_BLOCK)
    g, rep, dh = 8, 3, 128
    kv_lens = torch.from_numpy(np.asarray(lens, np.int32)).to(dev)
    even = torch.full_like(kv_lens, int(round(float(np.mean(lens)))))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chosen = k.split_count(LM_SLOTS, g, width * LM_BLOCK, sms)
    out = {}
    for kv in ("bf16", "int8"):
        b_ms, b_by, nbytes = fd_bound(lens, g, rep, dh, kv == "int8")
        n_sets = FD_COLD_SETS[kv]
        if n_sets * nbytes <= 2 * L2_BYTES:
            raise AssertionError(f"phase 15: {n_sets} sets of {nbytes / 1e6:.1f}"
                                 " MB do not exceed twice the L2")
        kern, plain, library = [], [], []
        for i in range(n_sets):
            q, pool, table = fd_inputs(torch, LM_SLOTS, g, rep, dh, LM_BLOCK,
                                       width, kv, 17 + i, dev, dh ** -0.5)
            ks, vs = pool.get("k_scale"), pool.get("v_scale")
            kern.append(lambda n=kv_lens, s=None, q=q, p=pool, t=table, ks=ks,
                        vs=vs: k.flash_decode(q, p["k"], p["v"], t, n,
                                              k_scale=ks, v_scale=vs,
                                              splits=s))
            plain.append(lambda q=q, p=pool, t=table, ks=ks, vs=vs:
                         fd.flash_decode_plain(q, p["k"], p["v"], t, kv_lens,
                                               ks, vs))
            # the library call's inputs: the table window gathered (and for
            # int8 dequantised) into [B, G, W*bs, dh] bf16, a [B, 1, 1, W*bs]
            # mask
            tab = table.long()
            kg, vg = pool["k"][tab], pool["v"][tab]
            if kv == "int8":
                kg, vg = kg.float() * ks[tab], vg.float() * vs[tab]
            kg = kg.reshape(LM_SLOTS, width * LM_BLOCK, g, dh).transpose(1, 2)
            vg = vg.reshape(LM_SLOTS, width * LM_BLOCK, g, dh).transpose(1, 2)
            kg, vg = kg.to(torch.bfloat16).contiguous(), vg.to(
                torch.bfloat16).contiguous()
            qb = q.reshape(LM_SLOTS, g * rep, 1, dh).to(torch.bfloat16)
            mask = (torch.arange(width * LM_BLOCK, device=dev)[None, :]
                    < kv_lens[:, None])[:, None, None, :]
            library.append(lambda qb=qb, kg=kg, vg=vg, mask=mask:
                           F.scaled_dot_product_attention(
                               qb, kg, vg, attn_mask=mask, scale=1.0,
                               enable_gqa=True))
        launches = fd.launches
        p1, k1, k2, p2, l1, l2 = (graph_ms(rotate(plain)),
                                  graph_ms(rotate(kern)),
                                  graph_ms(rotate(kern)),
                                  graph_ms(rotate(plain)),
                                  graph_ms(rotate(library)),
                                  graph_ms(rotate(library)))
        k_warm, l_warm = graph_ms(kern[0]), graph_ms(library[0])
        # the same positions spread evenly over the rows: how much of the
        # kernel's time the longest row sets
        k_even = graph_ms(rotate([lambda f=f: f(even) for f in kern]))
        by_split = {s: graph_ms(rotate([lambda f=f, s=s: f(s=s)
                                        for f in kern]))
                    for s in (1, 2, 4, 8)}
        fd.launches = launches  # timing launches are not the main path's
        ms, lib_ms = min(k1, k2), min(l1, l2)
        out[kv] = {"ms": ms, "plain_ms": min(p1, p2), "bound_ms": b_ms,
                   "bound_by": b_by, "library_ms": lib_ms, "warm_ms": k_warm,
                   "library_warm_ms": l_warm, "splits": chosen}
        print(f"phase 15: flash_decode ({kv} pool) at B={LM_SLOTS} G={g} "
              f"rep={rep} dh={dh} bs={LM_BLOCK} W={width}, mean live length "
              f"{np.mean(lens):.0f}, {chosen} blocks a cluster (split_count, "
              f"{sms} SMs) on {card}: device time (CUDA graph), cold L2 "
              f"({n_sets} input sets rotated, {n_sets * nbytes / 1e6:.1f} MB "
              f"of live K/V a round): kernel {k1:.5f}/{k2:.5f} ms, plain "
              f"{p1:.5f}/{p2:.5f} ms, library {l1:.5f}/{l2:.5f} ms (bf16 "
              f"SDPA, enable_gqa, length mask, over K/V gathered into a "
              f"contiguous {width * LM_BLOCK}-position window beforehand; the "
              f"gather is not timed); warm (one set replayed): kernel "
              f"{k_warm:.5f} ms, library {l_warm:.5f} ms; bound {b_ms:.5f} ms "
              f"({b_by}: {nbytes / 1e6:.2f} MB of live positions, q and out)"
              f", kernel at {b_ms / ms:.1%} of the bound cold, "
              f"{lib_ms / ms:.2f}x the library's speed cold; every row at the "
              f"mean length (longest row {max(lens)} now): {k_even:.5f} ms "
              f"({k_even / ms:.2f}x the real lengths' time); by forced split "
              f"count: " + ", ".join(f"S={s} {t:.5f} ms"
                                     for s, t in by_split.items()),
              flush=True)
        if b_ms / ms > 1.05:
            raise AssertionError(f"phase 15: flash_decode ({kv}) reads at "
                                 f"{b_ms / ms:.1%} of its HBM bound cold: "
                                 "the L2 is not cold")
        if ms > lib_ms:
            raise AssertionError(f"phase 15: flash_decode ({kv}) {ms:.5f} ms "
                                 f"cold is slower than SDPA's {lib_ms:.5f}")
        del kern, plain, library
        torch.cuda.empty_cache()
    return out


# The sharded engine (phases 16-18): a 4 x 2 mesh of logical shards on the
# card, the engine's 256 slots over the data axis, LVRF's 10 rows over the
# model axis; the reference test's local-kernel shapes (tests/test_kernels.py).
MESH_DATA, MESH_MODEL = 4, 2
N_LOC, M_LOC = ENGINE_ROWS // MESH_DATA, M // MESH_MODEL
LOCAL_TEST_N, LOCAL_TEST_M, LOCAL_TEST_D = (1, 7, 130), 12, 256
TAB7_REQUESTS = 256


def local_bound(n: int, m_loc: int) -> tuple:
    """Least time (ms) of one LOCAL launch: q, est, the row block and its
    mask read once, the raw scores and the fp32 partial projection written
    once; the scores' and projection's FMAs and the unbind products at the
    fp32 rate."""
    nbytes = 4 * (n * D + n * F * D + F * m_loc * D + F * m_loc
                  + n * F * m_loc + n * F * D)
    flops = 4 * n * F * m_loc * D + n * F * D * (F + 1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def phase_local_kernel(rs, ref, torch, dev) -> float:
    """The LOCAL kernel against its plain version on each shard's row block
    and mask slice, bitwise; the shards' padded scores and partial
    projections, summed, masked and saturated, against the masked kernel.
    Returns the max |kernel - plain|."""
    gen = torch.Generator().manual_seed(41)
    err = 0.0
    cases = [(n, LOCAL_TEST_M, LOCAL_TEST_D, (5, 12, 7))
             for n in LOCAL_TEST_N] + [(N_LOC, M, D, (5, 6, 10))]
    for n, m, d, sizes in cases:
        cbs = bipolar(gen, (F, m, d), dev)
        qs, est = bipolar(gen, (n, d), dev), bipolar(gen, (n, F, d), dev)
        mask = torch.stack([torch.arange(m) < s for s in sizes]).to(dev)
        m_loc = m // MESH_MODEL
        for act in ("identity", "abs"):
            acc_a = torch.zeros((n, F, m), device=dev)
            acc_p = torch.zeros((n, F, d), device=dev)
            for s in range(MESH_MODEL):
                blk = cbs[:, s * m_loc:(s + 1) * m_loc].contiguous()
                mk = mask[:, s * m_loc:(s + 1) * m_loc]
                before = rs.local_launches
                got = rs.fused_resonator_step_batch_local(qs, est, blk, mk,
                                                          act)
                want = ref.resonator_step_batch_local_ref(qs, est, blk, mk,
                                                          act)
                torch.cuda.synchronize()
                if rs.local_launches != before + 1:
                    raise AssertionError("the LOCAL wrapper did not launch "
                                         "its kernel once")
                diff = max((g - w).abs().max().item()
                           for g, w in zip(got, want))
                err = max(err, diff)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(
                        f"LOCAL kernel != plain version at N={n} M_loc="
                        f"{m_loc} D={d} {act} shard {s}: max |diff| {diff}")
                acc_a[..., s * m_loc:(s + 1) * m_loc] += got[0]
                acc_p += got[1]
            a_k, e_k = rs.fused_resonator_step_batch_masked(qs, est, cbs,
                                                            mask, act)
            if not (torch.equal(torch.where(mask[None], acc_a, -1e9), a_k)
                    and torch.equal(torch.where(acc_p >= 0, 1.0, -1.0),
                                    e_k)):
                raise AssertionError(f"{MESH_MODEL} shards' gathered LOCAL "
                                     f"outputs != the masked kernel at N={n}")
        print(f"phase 16: LOCAL kernel at N={n} F={F} M_loc={m_loc} D={d} "
              f"(masks {sizes}, identity and abs): each of {MESH_MODEL} "
              f"shards bitwise equal to the plain version; the gathered sum "
              f"bitwise equal to the masked kernel", flush=True)
    return err


def _same(a, b) -> bool:
    import numpy as np

    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in a._fields)


def phase_sharded(torch, dev, rs, card):
    """LVRF at full width through ShardedEngine on a 4 x 2 mesh of logical
    shards on the card, rows then replicated placement, each against
    Engine(slots=256) on the same requests; then Tab. VII at fp32 under rows
    placement against Engine.  Returns the rows run's local launches and
    the serving numbers."""
    import numpy as np

    from repro_torch import engine, obs
    from repro_torch.core import factorizer as fz
    from repro_torch.device import generator
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lvrf

    cfg = lvrf.LVRFConfig()
    vals = np.random.default_rng(1).integers(0, cfg.n_values, (512, 3))
    atoms = lvrf.init_atoms(generator(0), cfg, device=dev)
    spec = engine.registry.build("lvrf_rows", 0, fused_step=True,
                                 atoms=atoms, device=dev)
    qs = lvrf.encode_row(atoms, vals, cfg)
    keys = fz.draw_keys(8, len(vals))

    def serve(eng, n=len(vals)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = [eng.submit(qs[i], keys=keys[i][None]) for i in range(n)]
        done = {r.id: r for r in eng.drain()}
        torch.cuda.synchronize()
        return [done[i] for i in ids], time.perf_counter() - t0

    def sharded(placement):
        mesh = make_host_mesh(MESH_DATA, MESH_MODEL, dev)
        return mesh, engine.ShardedEngine(
            spec, mesh=mesh, codebook_placement=placement, slots=ENGINE_ROWS)

    serve(sharded("rows")[1], 8)  # warm-up
    base, base_wall = serve(engine.Engine(spec, slots=ENGINE_ROWS,
                                          device=dev))
    numbers = {"engine_wall": base_wall}
    for placement in ("rows", "replicated"):
        mesh, eng = sharded(placement)
        rs.launches = rs.masked_launches = rs.local_launches = 0
        got, wall = serve(eng)  # the sharded path's run
        counts = (rs.launches, rs.masked_launches, rs.local_launches)
        sweeps, steps = eng.sweeps_total, eng.steps_total
        wrong = sum(not (r.result["values"][0] == v).all()
                    for r, v in zip(got, vals))
        if wrong:
            raise AssertionError(f"sharded ({placement}): {wrong} of "
                                 f"{len(vals)} LVRF rows decoded wrong")
        if not all(_same(a.factorization, b.factorization)
                   for a, b in zip(base, got)):
            raise AssertionError(f"sharded ({placement}): results differ "
                                 "from Engine's")
        red = dict(mesh.reductions)
        if red["data"] != sweeps + steps:
            raise AssertionError(f"data reductions {red['data']} != sweeps "
                                 f"+ bursts = {sweeps} + {steps}")
        if placement == "rows":
            want_model = (F + 1) * sweeps + 2 * eng.decodes_total
            if (counts != (0, 0, MESH_DATA * MESH_MODEL * sweeps)
                    or sweeps == 0 or red["model"] != want_model):
                raise AssertionError(
                    f"rows placement: launches (dense, masked, local) "
                    f"{counts} for {sweeps} sweeps, model reductions "
                    f"{red['model']} != (F + 1) x sweeps + 2 x decodes = "
                    f"{want_model}")
        elif counts != (MESH_DATA * sweeps, 0, 0) or red["model"] != 0:
            raise AssertionError(f"replicated placement: launches {counts} "
                                 f"for {sweeps} sweeps, model reductions "
                                 f"{red['model']}")
        snap = eng.snapshot()
        numbers[placement] = {"wall": wall, "snap": snap, "sweeps": sweeps,
                              "launches": counts}
        print(f"phase 17: ShardedEngine({placement}, mesh {MESH_DATA}x"
              f"{MESH_MODEL} logical shards on {card}, slots={ENGINE_ROWS}): "
              f"{len(vals)} LVRF rows all decoded correctly and bitwise equal "
              f"to Engine(slots={ENGINE_ROWS}); sweeps_per_step="
              f"{eng.sweeps_per_step} sweeps_total={sweeps} steps={steps}; "
              f"launches (dense, masked, local) {counts}; reductions model "
              f"{red['model']} (decodes {eng.decodes_total}), data "
              f"{red['data']}; wall {wall * 1e3:.2f} ms, "
              f"{len(vals) / wall:.1f} requests/s, p50 "
              f"{snap['latency_p50_ms']:.3f} ms, p99 "
              f"{snap['latency_p99_ms']:.3f} ms", flush=True)
    print(f"phase 17: Engine(slots={ENGINE_ROWS}) on the same requests, same "
          f"card, just before: wall {base_wall * 1e3:.2f} ms, "
          f"{len(vals) / base_wall:.1f} requests/s", flush=True)
    # The rows run again under a span recorder: where the wall goes.
    rec = obs.Recorder()
    launches = rs.local_launches
    traced = engine.ShardedEngine(
        spec, mesh=make_host_mesh(MESH_DATA, MESH_MODEL, dev),
        codebook_placement="rows", slots=ENGINE_ROWS, obs=rec)
    _, wall = serve(traced)
    rs.local_launches = launches  # not the counted run's launches
    spent: dict = {}
    for sp in rec.spans.snapshot():
        if sp.duration is not None:
            spent[sp.name] = spent.get(sp.name, 0.0) + sp.duration
    print(f"phase 17: traced rows run: wall {wall * 1e3:.2f} ms, steps "
          f"{spent['step'] * 1e3:.2f} ms (fill {spent['fill'] * 1e3:.2f}, "
          f"sweep-burst {spent['sweep-burst'] * 1e3:.2f} for "
          f"{traced.sweeps_total} sweeps, retire {spent['retire'] * 1e3:.2f}"
          f" ms)", flush=True)
    phase_sharded_unitary(torch, dev, card)
    return numbers


def phase_sharded_unitary(torch, dev, card):
    """Tab. VII 2x2Grid at fp32 (unitary, D = 1024, B = 4, F = 4, M = 10,
    noise 0.3, restarts every 20), 256 requests, rows placement against
    Engine on the card with the same keys.  The projection's sum over the
    model shards is reassociated, and a row that hovers amplifies that last
    ulp sweep by sweep: such rows may settle elsewhere, and are listed.  Of
    the rows Engine settles within FAST_SWEEPS sweeps at most 2 % may
    differ (a near tie); both accuracies must reach 0.90 and agree within
    0.06 (the rows that part are about a third, each a fresh stochastic
    run: the difference has a spread near 0.017)."""
    import dataclasses

    import numpy as np

    from repro_torch import engine
    from repro_torch.core import factorizer as fz
    from repro_torch.core import vsa
    from repro_torch.device import generator
    from repro_torch.launch.mesh import make_host_mesh

    cfg = dataclasses.replace(tab_cfg(fz, vsa), codebook_fmt="fp32")
    cbs = fz.make_codebooks(generator(1), cfg, device=dev)
    idx = np.random.default_rng(4).integers(0, 10, (TAB7_REQUESTS, 4))
    qs = fz.bind_combo(cbs, torch.from_numpy(idx).to(dev), cfg.vsa)
    keys = fz.draw_keys(7, TAB7_REQUESTS)
    spec = engine.ServeSpec("tab07_2x2grid_fp32", codebooks=cbs, cfg=cfg)

    def serve(eng):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = [eng.submit(qs[i], keys=keys[i][None])
               for i in range(TAB7_REQUESTS)]
        done = {r.id: r for r in eng.drain()}
        torch.cuda.synchronize()
        return ([done[i].factorization for i in ids],
                time.perf_counter() - t0, eng)

    base, t_base, eng_b = serve(engine.Engine(spec, slots=ENGINE_ROWS,
                                              device=dev))
    got, t_rows, eng_r = serve(engine.ShardedEngine(
        spec, mesh=make_host_mesh(MESH_DATA, MESH_MODEL, dev),
        codebook_placement="rows", slots=ENGINE_ROWS))
    differ, fast_differ, fast = [], [], 0
    for i, (a, b) in enumerate(zip(base, got)):
        same = all(np.array_equal(getattr(a, f), getattr(b, f))
                   for f in ("indices", "converged", "iterations"))
        fast += int(a.iterations[0] <= FAST_SWEEPS)
        if not same:
            differ.append(f"{i} ({int(a.iterations[0])} -> "
                          f"{int(b.iterations[0])} sweeps"
                          f"{'' if np.array_equal(a.indices, b.indices) else ', other indices'})")
            if a.iterations[0] <= FAST_SWEEPS:
                fast_differ.append(i)
    acc = [float(np.mean([(r.indices[0] == t).all() for r, t in zip(run, idx)]))
           for run in (base, got)]
    print(f"phase 17: Tab. VII 2x2Grid at fp32, {TAB7_REQUESTS} requests, "
          f"rows placement on {MESH_DATA}x{MESH_MODEL} logical shards against "
          f"Engine on {card}: accuracy {acc[1]:.4f} (Engine {acc[0]:.4f}); "
          f"{len(differ)} of {TAB7_REQUESTS} rows differ in indices, "
          f"converged or iterations ({len(differ) / TAB7_REQUESTS:.2%}): "
          f"[{'; '.join(differ)}]; {len(fast_differ)} of the {fast} rows "
          f"Engine settles within {FAST_SWEEPS} sweeps differ; wall "
          f"{t_rows * 1e3:.1f} ms for {eng_r.sweeps_total} sweeps (Engine "
          f"{t_base * 1e3:.1f} ms for {eng_b.sweeps_total})", flush=True)
    if (len(fast_differ) > 0.02 * fast or min(acc) < 0.90
            or abs(acc[0] - acc[1]) > 0.06):
        raise AssertionError(f"Tab. VII fp32 rows placement: fast rows "
                             f"{fast_differ} differ, or accuracy {acc[1]} "
                             f"against Engine's {acc[0]}")


def phase_local_timing(torch, dev, rs, ref, card):
    """The LOCAL kernel at the sharded serving shape (one shard's 64 rows
    and 5 of LVRF's 10 rows), its plain version and its bound, device time
    from CUDA-graph replay in turns."""
    from repro_torch.kernels.resonator_step import kernel as k

    gen = torch.Generator().manual_seed(43)
    qs = bipolar(gen, (N_LOC, D), dev)
    est = bipolar(gen, (N_LOC, F, D), dev)
    blk = bipolar(gen, (F, M_LOC, D), dev)
    mask = torch.ones((F, M_LOC), dtype=torch.bool, device=dev)
    kern = lambda: k.resonator_step_batch_local(qs, est, blk, mask)
    plain = lambda: ref.resonator_step_batch_local_ref(qs, est, blk, mask)
    launches = rs.local_launches
    p1, k1, k2, p2 = graph_ms(plain), graph_ms(kern), graph_ms(kern), \
        graph_ms(plain)
    hk = cuda_ms(kern)
    rs.local_launches = launches  # timing launches are not the main path's
    b_ms, b_by, nbytes = local_bound(N_LOC, M_LOC)
    print(f"phase 18: LOCAL kernel at N={N_LOC} F={F} M_loc={M_LOC} D={D} on "
          f"{card}: device time (CUDA graph) kernel {k1:.5f}/{k2:.5f} ms, "
          f"plain {p1:.5f}/{p2:.5f} ms, bound {b_ms:.5f} ms ({b_by}: "
          f"{nbytes / 1e6:.2f} MB), kernel at {b_ms / min(k1, k2):.1%} of the "
          f"bound; per call back to back, host included: kernel {hk:.4f} ms",
          flush=True)
    return {"ms": min(k1, k2), "plain_ms": min(p1, p2), "bound_ms": b_ms,
            "bound_by": b_by}


# MIMONet (phases 19-22): the reference test's circconv shapes
# (tests/test_kernels.py), the serving shape of a MIMONet batch (256 items x
# S = 2 x B = 8 rows of L = 256), the HRR corner's lengths, and the traffic:
# 4096 panels served at S = 2 and again at S = 4, 256 items a batch (the
# stream counts examples/mimonet_superposition.py sweeps).
MIMO_DIM, MIMO_BLOCKS = 2048, 8  # MIMONetConfig's VSAConfig: L = 256
MIMO_PANELS, MIMO_ITEMS, MIMO_STREAMS = 4096, 256, (2, 4)
CC_ROWS_CASES = ((1, 64), (4, 128), (32, 256), (7, 100), (130, 64), (16, 1024))
CC_SERVE = tuple((MIMO_ITEMS * S * MIMO_BLOCKS, MIMO_DIM // MIMO_BLOCKS)
                 for S in MIMO_STREAMS)  # one launch's rows: (4096 | 8192, 256)
CC_SINGLE_L = (512, 1024, 777, 2048)
CC_TIMED_L = 2048
MIMO_ATOL, MIMO_RTOL = 1e-5, 1e-4  # logits of order 0.05: fp32 binds in
# another order (kernel against cuFFT), through the same cuBLAS GEMMs


def cc_broadcast_cases() -> list:
    """(name, x shape, y shape) of phase 19's broadcast operands, read by
    circconv_rows as views: at MIMONet's launch shapes (N items, S streams,
    B blocks, L) the keys shared over items (the bind), x shared over
    streams, both (the unbind), neither; the reference test's shapes
    against one shared y row; groups of rows just below, at and above the
    tensor-core mode's threshold (kernel.MMA_MIN_ROWS)."""
    from repro_torch.kernels.circconv import kernel as k

    N, B, L = MIMO_ITEMS, MIMO_BLOCKS, MIMO_DIM // MIMO_BLOCKS
    cases = []
    for S in MIMO_STREAMS:
        cases += [(f"bind S={S}", (N, S, B, L), (1, S, B, L)),
                  (f"x over streams S={S}", (N, 1, B, L), (N, S, B, L)),
                  (f"unbind S={S}", (N, 1, B, L), (1, S, B, L)),
                  (f"neither S={S}", (N, S, B, L), (N, S, B, L))]
    cases += [(f"y shared ({n}, {L_})", (n, L_), (1, L_))
              for n, L_ in CC_ROWS_CASES]
    cases += [(f"group of {g}", (g, 2, 128), (1, 2, 128))
              for g in (k.MMA_MIN_ROWS - 1, k.MMA_MIN_ROWS,
                        k.MMA_MIN_ROWS + 1)]
    return cases


def phase_circconv(torch, dev, cc) -> dict:
    """Both circconv kernels against their plain versions on the card, at
    the reference test's shapes and tolerances, fp32 and bf16, every shape
    the MIMONet path launches (CC_SERVE), and broadcast operands read as
    views (cc_broadcast_cases), in both of circconv_rows' modes.  Returns
    each kernel's max |kernel - plain| in fp32."""
    from repro_torch.kernels.circconv import kernel as k
    from repro_torch.kernels.circconv import ref

    gen = torch.Generator().manual_seed(51)
    launches = (cc.rows_launches, cc.single_launches)
    err = {}

    def check(name, got, want, atol, rtol, what):
        torch.cuda.synchronize()
        diff = (got.float() - want).abs()
        if not bool((diff <= atol + rtol * want.abs()).all()):
            raise AssertionError(f"{name} != plain version at {what}: max "
                                 f"|diff| {diff.max().item()}")
        return diff.max().item()

    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 0.15)):
        worst = 0.0
        for n, L in CC_ROWS_CASES + CC_SERVE:
            x = torch.randn((n, L), generator=gen).to(dev, dtype)
            y = torch.randn((n, L), generator=gen).to(dev, dtype)
            worst = max(worst, check(
                "circconv_rows", k.circconv_rows(x, y),
                ref.circconv_rows_ref(x, y), tol * L ** 0.5, tol,
                f"N={n} L={L} {dtype}"))
        modes = {}
        for name, xs, ys in cc_broadcast_cases():
            shape = torch.broadcast_shapes(xs, ys)
            L = shape[-1]
            x = torch.randn(xs, generator=gen).to(dev, dtype).expand(shape)
            y = torch.randn(ys, generator=gen).to(dev, dtype).expand(shape)
            mode = k.rows_plan(shape, x.stride(), y.stride()).mode
            modes[mode] = modes.get(mode, 0) + 1
            got = k.circconv_rows(x, y).reshape(-1, L)
            worst = max(worst, check(
                "circconv_rows", got,
                ref.circconv_rows_ref(x.reshape(-1, L).contiguous(),
                                      y.reshape(-1, L).contiguous()),
                tol * L ** 0.5, tol, f"{name} {dtype} ({mode} mode)"))
        if dtype == torch.float32:  # the path's dtype
            err["rows"] = worst
        print(f"phase 19: circconv_rows within the reference's tolerance "
              f"(atol {tol} sqrt(L), rtol {tol}) of its plain version at "
              f"{dtype}, (N, L) in {CC_ROWS_CASES + CC_SERVE} and "
              f"{len(cc_broadcast_cases())} broadcast cases ({modes}): max "
              f"|diff| {worst:.3g}", flush=True)
    worst = 0.0
    for L in CC_SINGLE_L:
        x = torch.randn((L,), generator=gen).to(dev)
        y = torch.randn((L,), generator=gen).to(dev)
        worst = max(worst, check("circconv_single", k.circconv_single(x, y),
                                 ref.circconv_single_ref(x, y), 1e-3, 1e-4,
                                 f"L={L}"))
    err["single"] = worst
    print(f"phase 19: circconv_single within atol 1e-3, rtol 1e-4 of its "
          f"plain version at fp32, L in {CC_SINGLE_L}: max |diff| "
          f"{worst:.3g}", flush=True)
    cc.rows_launches, cc.single_launches = launches  # not the main path's
    return err


def _logits_agree(torch, got, want, what):
    """Every logit finite and within MIMO_ATOL + MIMO_RTOL |want|."""
    for a, (g, w) in enumerate(zip(got, want)):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}: attribute {a} has a non-finite "
                                 "logit")
        diff = (g - w).abs()
        if not bool((diff <= MIMO_ATOL + MIMO_RTOL * w.abs()).all()):
            raise AssertionError(f"{what}: attribute {a} logits differ from "
                                 f"the fft run by up to {diff.max().item()}")


def _losses_agree(torch, mm, model, batch, cfg, fft):
    """loss_fn through the kernel against the fft run: the loss within
    1e-5 relative; a prediction may differ only at a near tie (the fft
    run's top two logits within twice the logits' tolerance), and each
    accuracy only by such predictions.  Returns the near ties taken."""
    loss, accs = mm.loss_fn(model, batch, cfg)
    loss_f, accs_f = mm.loss_fn(model, batch, fft)
    if abs(loss.item() - loss_f.item()) > 1e-5 * abs(loss_f.item()):
        raise AssertionError(f"loss {loss.item()} against the fft run's "
                             f"{loss_f.item()}")
    logits = mm.apply(model, batch["images"], cfg)
    logits_f = mm.apply(model, batch["images"], fft)
    ties = 0
    for a, name in enumerate(mm.ATTRS):
        flip = logits[a].argmax(-1) != logits_f[a].argmax(-1)
        top2 = logits_f[a].topk(2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]
        slack = 2 * (MIMO_ATOL + MIMO_RTOL * top2[..., 0].abs())
        if bool((flip & (gap > slack)).any()):
            raise AssertionError(f"{name}: a prediction differs from the fft "
                                 "run away from a near tie")
        n = int(flip.sum())
        ties += n
        if abs(accs[name].item() - accs_f[name].item()) > (
                n / flip.numel() + 1e-6):
            raise AssertionError(f"{name} accuracy {accs[name].item()} "
                                 f"against the fft run's {accs_f[name].item()}")
    return ties


def phase_mimonet(torch, dev, cc, card) -> dict:
    """MIMONet served at full width (D = 2048, B = 8, hidden 2048 x 2) through
    impl="pallas": 4096 panels at S = 2 (8 batches) and again at S = 4 (4
    batches), 256 items a batch, random weights from a seed.  Checks the
    launch count (one bind and one unbind a batch, no single-row launch),
    the logits, loss and accuracies against the same model with impl="fft",
    stream separation, and a bind -> mean -> unbind round trip of Gaussian
    embeddings through the kernel.  Returns the rows launches of the two
    served runs and the serving numbers."""
    import dataclasses

    import numpy as np

    from repro_torch.core import vsa
    from repro_torch.data import raven
    from repro_torch.models import mimonet as mm

    data = raven.attribute_classification_batch(np.random.default_rng(61),
                                                MIMO_PANELS)
    imgs = torch.from_numpy(data["images"]).to(dev)
    labels = {a: torch.from_numpy(data[a]).to(dev) for a in mm.ATTRS}
    out = {"launches": 0}
    for seed, S in enumerate(MIMO_STREAMS):
        cfg = mm.MIMONetConfig(
            vsa=vsa.VSAConfig(MIMO_DIM, MIMO_BLOCKS, impl="pallas"),
            num_streams=S)
        fft = dataclasses.replace(
            cfg, vsa=vsa.VSAConfig(MIMO_DIM, MIMO_BLOCKS, impl="fft"))
        model = mm.init(cfg, seed, device=dev)
        per = MIMO_ITEMS * S
        batches = [{"images": imgs[i:i + per].reshape(MIMO_ITEMS, S, 32, 32),
                    **{a: labels[a][i:i + per].reshape(MIMO_ITEMS, S)
                       for a in mm.ATTRS}}
                   for i in range(0, MIMO_PANELS, per)]
        for run in (cfg, fft):  # warm-up: cuBLAS and cuFFT plans
            mm.apply(model, batches[0]["images"], run)
        torch.cuda.synchronize()

        def serve(run):
            walls, logits = [], []
            t_all = time.perf_counter()
            for b in batches:
                t0 = time.perf_counter()
                logits.append(mm.apply(model, b["images"], run))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            return logits, walls, time.perf_counter() - t_all

        cc.rows_launches = cc.single_launches = 0  # the main path's run
        logits, walls, wall = serve(cfg)
        launches = (cc.rows_launches, cc.single_launches)  # ... ends here
        if launches != (2 * len(batches), 0):
            raise AssertionError(f"S={S}: (rows, single) launches {launches}"
                                 f", expected ({2 * len(batches)}, 0): one "
                                 "bind and one unbind a batch")
        out["launches"] += launches[0]
        logits_f, walls_f, wall_f = serve(fft)
        for i, (g, w) in enumerate(zip(logits, logits_f)):
            _logits_agree(torch, g, w, f"S={S} batch {i}")
        ties = sum(_losses_agree(torch, mm, model, b, cfg, fft)
                   for b in batches)
        first = logits[0][0]
        if torch.allclose(first[:, 0], first[:, 1]):
            raise AssertionError(f"S={S}: streams 0 and 1 give the same "
                                 "logits")
        worst = max((g - w).abs().max().item() for gs, ws in
                    zip(logits, logits_f) for g, w in zip(gs, ws))
        scale = max(g.abs().max().item() for gs in logits for g in gs)
        launches_before = cc.rows_launches
        dev_ms = graph_ms(lambda: mm.apply(model, batches[0]["images"], cfg),
                          iters=5, replays=4)
        dev_f = graph_ms(lambda: mm.apply(model, batches[0]["images"], fft),
                         iters=5, replays=4)
        prof = device_profile(
            torch, lambda: mm.apply(model, batches[0]["images"], cfg))
        peak = {run.vsa.impl: peak_beyond_inputs(
            torch, lambda run=run: mm.apply(model, batches[0]["images"], run))
            for run in (cfg, fft)}
        cc.rows_launches = launches_before
        out[S] = {"wall_ms": wall * 1e3, "panels_per_s": MIMO_PANELS / wall,
                  "batch_ms": float(np.mean(walls)) * 1e3,
                  "device_ms": dev_ms, "peak_mb": peak}
        print(f"phase 20: MIMONet S={S} at full width on {card}: "
              f"{sum(p.numel() for p in model.parameters()):,} fp32 "
              f"parameters, {MIMO_PANELS} panels in {len(batches)} batches "
              f"of {MIMO_ITEMS} items; rows launches {launches[0]} (2 a "
              f"batch), single {launches[1]}; wall {wall * 1e3:.2f} ms, "
              f"{MIMO_PANELS / wall:.1f} panels/s, per batch (host "
              f"included) mean {np.mean(walls) * 1e3:.3f} ms, min "
              f"{min(walls) * 1e3:.3f} ms; device time of a batch (CUDA "
              f"graph) {dev_ms:.4f} ms; impl='fft' on the same model: wall "
              f"{wall_f * 1e3:.2f} ms, {MIMO_PANELS / wall_f:.1f} panels/s, "
              f"per batch {np.mean(walls_f) * 1e3:.3f} ms, device "
              f"{dev_f:.4f} ms", flush=True)
        print(f"phase 20: S={S}: profiler, one eager batch: {prof}; "
              f"peak allocation beyond its inputs {peak['pallas']:.3f} MB "
              f"(impl='fft': {peak['fft']:.3f} MB)", flush=True)
        print(f"phase 20: S={S}: every logit finite and within atol "
              f"{MIMO_ATOL}, rtol {MIMO_RTOL} of the fft run (max |diff| "
              f"{worst:.3g}, max |logit| {scale:.3g}); loss_fn's loss within "
              f"1e-5 relative and its accuracies equal up to {ties} near "
              f"ties; streams 0 and 1 give different logits", flush=True)

    # The reference's test_superpose_unbind_roundtrip at D = 2048, through
    # the kernel: each recovered stream correlates best with its own.
    vcfg = vsa.VSAConfig(2048, 8, impl="pallas")
    gen = torch.Generator().manual_seed(62)
    keys = vsa.random_unitary(gen, (3,), vcfg, device=dev)
    embs = torch.randn((2, 3, 8, 2048), generator=gen).to(dev)
    before = cc.rows_launches
    bundled = torch.mean(vsa.bind(embs, keys[None, :, None, :], vcfg), dim=1)
    rec = vsa.unbind(bundled[:, None], keys[None, :, None, :], vcfg)
    if cc.rows_launches != before + 2:
        raise AssertionError("the round trip did not go through the kernel")
    cc.rows_launches = before
    corr = [[torch.mean(rec[:, s] * embs[:, o]).item() for o in range(3)]
            for s in range(3)]
    other = [max(abs(corr[s][o]) for o in range(3) if o != s)
             for s in range(3)]
    if not all(corr[s][s] > 2 * other[s] for s in range(3)):
        raise AssertionError(f"round trip: correlations {corr}")
    print("phase 20: bind -> mean -> unbind round trip of 3 Gaussian streams "
          "at D=2048 through the kernel: own correlations "
          + ", ".join(f"{corr[s][s]:.4f}" for s in range(3))
          + f"; largest other {max(other):.4f}", flush=True)
    return out


def peak_beyond_inputs(torch, fn) -> float:
    """MB that one eager call of ``fn`` allocates at its peak beyond what
    was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e6


def phase_hrr(torch, dev, cc) -> int:
    """The HRR corner: one item, S = 1, B = 1 (L = 2048) through apply; each
    bind and unbind is one single-row launch.  Returns the launches."""
    import dataclasses

    import numpy as np

    from repro_torch.core import vsa
    from repro_torch.data import raven
    from repro_torch.models import mimonet as mm

    cfg = mm.MIMONetConfig(vsa=vsa.VSAConfig(2048, 1, impl="pallas"),
                           num_streams=1)
    fft = dataclasses.replace(cfg, vsa=vsa.VSAConfig(2048, 1, impl="fft"))
    model = mm.init(cfg, 7, device=dev)
    data = raven.attribute_classification_batch(np.random.default_rng(63), 1)
    img = torch.from_numpy(data["images"]).reshape(1, 1, 32, 32).to(dev)
    cc.rows_launches = cc.single_launches = 0  # the main path's run
    logits = mm.apply(model, img, cfg)
    torch.cuda.synchronize()
    launches = (cc.rows_launches, cc.single_launches)  # ... ends here
    if launches != (0, 2):
        raise AssertionError(f"HRR corner: (rows, single) launches "
                             f"{launches}, expected (0, 2)")
    _logits_agree(torch, logits, mm.apply(model, img, fft), "HRR corner")
    print(f"phase 21: HRR corner (one item, S=1, D=L=2048): 2 single-row "
          f"launches, no rows launch; logits within atol {MIMO_ATOL}, rtol "
          f"{MIMO_RTOL} of the fft run", flush=True)
    return launches[1]


def circ_bound(xs: tuple, ys: tuple, itemsize: int = 4) -> tuple:
    """Least time (ms) of one circular convolution of x (shape xs) with y
    (ys), broadcast to one shape of n rows of L: each operand's distinct
    rows read once, the n output rows written once, over the memory rate;
    the FLOP of its cheapest method at the fp32 rate.  That is the FFT
    route, not the direct 2 L^2 a row: a real FFT of 2.5 L log2 L (half the
    5 L log2 L of a complex radix-2 FFT) for each distinct row of x and y
    and each output row, and a complex product of L / 2 + 1 bins at 6 FLOP
    an output row."""
    L = xs[-1]
    n = math.prod(torch_broadcast(xs, ys)[:-1])
    dx, dy = math.prod(xs[:-1]), math.prod(ys[:-1])
    nbytes = (dx + dy + n) * L * itemsize
    flops = (dx + dy + n) * 2.5 * L * math.log2(max(L, 2)) + n * 6 * (
        L // 2 + 1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def torch_broadcast(xs: tuple, ys: tuple) -> tuple:
    import torch
    return tuple(torch.broadcast_shapes(xs, ys))


def cc_timed_shapes() -> list:
    """(name, x shape, y shape) that phase 22 times circconv_rows at: the
    MIMONet path's bind (emb with the keys) and unbind (out with the
    involuted keys) at S = 2 and 4, in blocked layout, and 4096
    independent rows of L = 256 (the direct mode)."""
    N, B, L = MIMO_ITEMS, MIMO_BLOCKS, MIMO_DIM // MIMO_BLOCKS
    shapes = []
    for S in MIMO_STREAMS:
        shapes += [(f"bind S={S}", (N, S, B, L), (1, S, B, L)),
                   (f"unbind S={S}", (N, 1, B, L), (1, S, B, L))]
    return shapes + [("independent rows", CC_SERVE[0], CC_SERVE[0])]


def phase_circconv_timing(torch, dev, cc, card) -> dict:
    """circconv_rows at the path's shapes (cc_timed_shapes) and
    circconv_single at L = 2048, fp32: each kernel, its plain version, its
    bound and the library yardstick (the port's FFT bind: rfft, rfft,
    multiply, irfft, four calls, since no single PyTorch call computes a
    circular convolution; it transforms the operands before they
    broadcast), device time from CUDA-graph replay, in turns; at the bind and unbind shapes also ``vsa.bind`` /
    ``vsa.unbind`` with impl="pallas" against impl="fft" (the unbind's
    involution included in both); beside the single kernel an empty
    kernel's time, the card's launch floor.  Raises if a kernel's time is
    below its bound by more than 5 % (a timing fault).  Returns the
    kernels' rows for the JSON line (circconv_rows at the S = 2 bind)."""
    from repro_torch.core import vsa
    from repro_torch.kernels.circconv import kernel as k
    from repro_torch.kernels.circconv import ref

    gen = torch.Generator().manual_seed(71)
    launches = (cc.rows_launches, cc.single_launches)
    few = dict(iters=5, replays=3)  # the plain rows version gathers 1-2 GB
    vcfg = vsa.VSAConfig(MIMO_DIM, MIMO_BLOCKS, impl="pallas")
    out = {}

    def timed(name, xs, ys, kern, plain, library, extra=""):
        p1, k1, k2, p2, l1, l2 = (graph_ms(plain, **few), graph_ms(kern),
                                  graph_ms(kern), graph_ms(plain, **few),
                                  graph_ms(library), graph_ms(library))
        b_ms, b_by, nbytes, flops = circ_bound(xs, ys)
        ms = min(k1, k2)
        if b_ms > 1.05 * ms:
            raise AssertionError(f"{name}: {ms:.5f} ms is below its bound "
                                 f"{b_ms:.5f} ms: a timing fault")
        print(f"phase 22: {name} fp32 on {card}: device time (CUDA graph) "
              f"kernel {k1:.5f}/{k2:.5f} ms, plain {p1:.5f}/{p2:.5f} ms, "
              f"library {l1:.5f}/{l2:.5f} ms (the FFT bind: rfft, rfft, "
              f"multiply, irfft), bound {b_ms:.6f} ms ({b_by}: distinct "
              f"{nbytes / 1e6:.4f} MB; {flops / 1e9:.4f} GFLOP by FFT), "
              f"kernel at {b_ms / ms:.1%} of the bound{extra}", flush=True)
        return {"ms": ms, "plain_ms": min(p1, p2), "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": min(l1, l2)}

    for name, xs, ys in cc_timed_shapes():
        shape = torch_broadcast(xs, ys)
        L = shape[-1]
        xb = torch.randn(xs, generator=gen).to(dev)
        yb = torch.randn(ys, generator=gen).to(dev)
        x, y = xb.expand(shape), yb.expand(shape)
        x2, y2 = x.reshape(-1, L).contiguous(), y.reshape(-1, L).contiguous()
        mode = k.rows_plan(shape, x.stride(), y.stride()).mode
        extra = ""
        if not name.startswith("independent"):  # through the vsa entry points
            S = shape[1]
            flat = (xb.reshape(MIMO_ITEMS, xs[1], MIMO_DIM),
                    yb.reshape(1, S, MIMO_DIM))  # emb or out, keys
            fns = {impl: ((lambda i=impl: vsa.bind(*flat, vcfg, impl=i))
                          if name.startswith("bind") else
                          (lambda i=impl: vsa.unbind(*flat, vcfg, impl=i)))
                   for impl in ("pallas", "fft")}
            t = {impl: [graph_ms(fn) for _ in range(2)]
                 for impl, fn in fns.items()}
            extra = (f"; vsa.{name.split()[0]} impl='pallas' "
                     f"{t['pallas'][0]:.5f}/{t['pallas'][1]:.5f} ms, "
                     f"impl='fft' {t['fft'][0]:.5f}/{t['fft'][1]:.5f} ms")
        out[name] = timed(
            f"circconv_rows {name} {tuple(shape)} ({mode} mode)", xs, ys,
            lambda: k.circconv_rows(x, y),
            lambda: ref.circconv_rows_ref(x2, y2),
            lambda: vsa._bind_fft(xb, yb), extra)  # broadcasts after rfft
        if name != "independent rows":
            out[name]["vsa_ms"] = {i: min(v) for i, v in t.items()}
    v = torch.randn((CC_TIMED_L,), generator=gen).to(dev)
    w = torch.randn((CC_TIMED_L,), generator=gen).to(dev)
    floor = min(graph_ms(lambda: k.empty_launch(dev)) for _ in range(2))
    _, tiles, csize, _, _ = k.single_geometry(CC_TIMED_L)
    out["single"] = timed(
        f"circconv_single ({CC_TIMED_L},), {tiles} clusters of {csize}",
        (CC_TIMED_L,), (CC_TIMED_L,), lambda: k.circconv_single(v, w),
        lambda: ref.circconv_single_ref(v, w), lambda: vsa._bind_fft(v, w),
        f"; an empty kernel (the launch floor) {floor:.5f} ms")
    out["single"]["floor_ms"] = floor
    cc.rows_launches, cc.single_launches = launches  # not the main path's
    return out


# NVSA (phase 23): NVSAConfig()'s widths (D = 1024, 4 blocks of 256, F = 3,
# M = 10 with the 5/6/10 mask), 256 RAVEN tasks served as 256 requests of 8
# context queries through Engine(slots=256); the bipolar variant's sweep is
# one launch of the masked kernel at D = 1024 (a cluster of 4 blocks).
NVSA_TASKS = 256
NVSA_D = 1024
NVSA_NOISE = 0.3  # oracle frontend: query noise, x the queries' std
NVSA_REPLAY = 32  # bipolar requests replayed on the CPU
# The pipelined stream: 8 task batches of 8.  adSCH pipelines NVSA's
# boundary up to batches of 8 (modeled gain 1.059; 1.035 < 1.05 at 32).
NVSA_BATCH, NVSA_T = 8, 8


def phase_nvsa_kernel(torch, dev, rs, ref, card) -> dict:
    """(a) The masked kernel at NVSA's bipolar shape (N = 256, F = 3, M =
    10, mask 5/6/10, D = 1024) against its plain version, bitwise on +-1
    inputs, then timed by CUDA-graph replay in turns beside its bound."""
    from repro_torch.kernels.resonator_step import kernel as k

    gen = torch.Generator().manual_seed(23)
    qs = bipolar(gen, (ENGINE_ROWS, NVSA_D), dev)
    est = bipolar(gen, (ENGINE_ROWS, F, NVSA_D), dev)
    cbs = bipolar(gen, (F, M, NVSA_D), dev)
    mask = torch.stack([torch.arange(M) < s for s in (5, 6, 10)]).to(dev)
    launches = rs.masked_launches
    err = 0.0
    for act in ("identity", "abs"):
        got = rs.fused_resonator_step_batch_masked(qs, est, cbs, mask, act)
        want = ref.resonator_step_batch_masked_ref(qs, est, cbs, mask, act)
        torch.cuda.synchronize()
        err = max(err, max((g - w).abs().max().item()
                           for g, w in zip(got, want)))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"masked kernel != plain version at N="
                                 f"{ENGINE_ROWS} D={NVSA_D} {act}: max "
                                 f"|diff| {err}")
    kern = lambda: k.resonator_step_batch_masked(qs, est, cbs, mask)
    plain = lambda: ref.resonator_step_batch_masked_ref(qs, est, cbs, mask)
    p1, k1, k2, p2 = (graph_ms(plain), graph_ms(kern), graph_ms(kern),
                      graph_ms(plain))
    rs.masked_launches = launches  # not a path's launches
    geo = k.launch_geometry(
        ENGINE_ROWS, F, M, NVSA_D, 128,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    b_ms, b_by = bound(ENGINE_ROWS, True, NVSA_D)
    out = {"ms": min(k1, k2), "plain_ms": min(p1, p2), "bound_ms": b_ms,
           "bound_by": b_by, "max_abs_err": err}
    print(f"phase 23a: resonator_step_batch_masked at NVSA's shape N="
          f"{ENGINE_ROWS} F={F} M={M} (mask 5/6/10) D={NVSA_D} ({geo}) on "
          f"{card}: bitwise equal to the plain version (identity, abs); "
          f"device time (CUDA graph) kernel {k1:.5f}/{k2:.5f} ms, plain "
          f"{p1:.5f}/{p2:.5f} ms, bound {b_ms:.5f} ms ({b_by}), kernel at "
          f"{b_ms / out['ms']:.1%} of the bound", flush=True)
    return out


def _nvsa_tasks(render: bool) -> dict:
    from repro_torch.data import raven

    return raven.RavenDataset(raven.RavenConfig(
        batch_size=NVSA_TASKS, render=render)).next_batch()


def _nvsa_queries(torch, nvsa, cbs, b, cfg, noise: float, seed: int):
    """Context [T, 8, D] and candidate [T, 8, D] target queries of the tasks
    ``b`` plus ``noise`` x std Gaussian noise, computed on the CPU from CPU
    codebooks (one seed, one set of bits on every device)."""
    import numpy as np

    from repro_torch.data import raven

    attrs = np.stack([b[f"grid_{a}"].reshape(NVSA_TASKS, 9)[:, :8]
                      for a in raven.ATTRS], -1)
    cands = np.stack([b[f"cand_{a}"] for a in raven.ATTRS], -1)
    gen = torch.Generator().manual_seed(seed)
    out = []
    for a in (attrs, cands):
        q = nvsa.target_query(cbs, torch.from_numpy(a), cfg)
        if noise:
            q = q + noise * q.std() * torch.randn(q.shape, generator=gen)
        out.append(q)
    return out


def _serve_nvsa(torch, engine, spec, ctx, cand, keys, dev, obs=None):
    """Every task as one request of its 8 context queries (pinned keys) with
    its candidates in ``meta``; returns (requests in task order, engine,
    host wall s)."""
    import numpy as np

    eng = engine.Engine(spec, slots=ENGINE_ROWS, obs=obs, device=dev)
    sync(torch, dev)
    t0 = time.perf_counter()
    ids = [eng.submit(ctx[t], keys=keys[8 * t:8 * t + 8],
                      meta={"cand": cand[t]}) for t in range(len(ctx))]
    done = {r.id: r for r in eng.drain()}
    sync(torch, dev)
    wall = time.perf_counter() - t0
    reqs = [done[i] for i in ids]
    for t, r in enumerate(reqs):
        if "answer" not in r.result:
            raise AssertionError(f"NVSA task {t} got no answer")
        if not np.isfinite(r.result["sims"]).all():
            raise AssertionError(f"NVSA task {t}: non-finite sims")
    return reqs, eng, wall


def phase_nvsa(torch, dev, rs, card) -> dict:
    """(b)-(e): NVSA abduction at NVSAConfig()'s widths on the card."""
    import dataclasses

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import engine, obs
    from repro_torch.core import factorizer as fz
    from repro_torch.core import vsa
    from repro_torch.data import raven
    from repro_torch.models import cnn, nvsa

    t_phase = time.perf_counter()

    def since() -> str:
        return f"[{time.perf_counter() - t_phase:.1f} s into phase 23]"

    out = {}
    cfg = nvsa.NVSAConfig()
    b = _nvsa_tasks(render=True)
    truth = b["answer"]
    spec = engine.registry.build("nvsa_abduction", 0, cfg=cfg, device=dev)
    cbs_cpu, mask_cpu = nvsa.make_codebooks(0, cfg, device="cpu")
    if not torch.equal(spec.codebooks.cpu(), cbs_cpu):
        raise AssertionError("the spec's codebooks are not make_codebooks(0)'s")
    ctx_cpu, cand_cpu = _nvsa_queries(torch, nvsa, cbs_cpu, b, cfg,
                                      NVSA_NOISE, seed=5)
    ctx, cand = ctx_cpu.to(dev), cand_cpu.to(dev)
    keys = fz.draw_keys(9, 8 * NVSA_TASKS)

    # (b) the oracle cell, default config (unitary, stochastic Gauss-Seidel)
    _serve_nvsa(torch, engine, spec, ctx[:4], cand[:4], keys, dev)  # warm-up
    print(f"phase 23b: tasks, queries and the warm-up done {since()}",
          flush=True)
    reqs, eng, wall = _serve_nvsa(torch, engine, spec, ctx, cand, keys, dev)
    answers = np.array([r.result["answer"] for r in reqs])
    iters = np.stack([r.iterations for r in reqs])
    conv = np.stack([r.factorization.converged for r in reqs])
    acc, conv_share = float((answers == truth).mean()), float(conv.mean())
    snap = eng.snapshot()
    rec = obs.Recorder()  # the same run again, traced: where the wall goes
    # Device activity only: host events of the whole run made the trace's
    # post-processing take most of a minute.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, eng_tr, wall_tr = _serve_nvsa(torch, engine, spec, ctx, cand, keys,
                                         dev, obs=rec)
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        raise AssertionError("the profiler recorded no device events")
    busy = sum(getattr(e, "self_device_time_total", 0.0) for e in kern) / 1e3
    spent: dict = {}
    for sp in rec.spans.snapshot():
        if sp.duration is not None:
            spent[sp.name] = spent.get(sp.name, 0.0) + sp.duration
    out["oracle"] = {"wall_ms": wall * 1e3, "answers_per_s": NVSA_TASKS / wall,
                     "p50_ms": snap["latency_p50_ms"],
                     "p99_ms": snap["latency_p99_ms"],
                     "sweeps": eng.sweeps_total, "accuracy": acc,
                     "mean_iterations": float(iters.mean()),
                     "converged": conv_share}
    print(f"phase 23b: NVSA oracle cell (NVSAConfig(): D={NVSA_D}, 4 blocks, "
          f"F=3, M=10 mask 5/6/10, unitary, stochastic Gauss-Seidel, noise "
          f"0.3, restarts every 20) on {card}: {NVSA_TASKS} RPM tasks as "
          f"{NVSA_TASKS} requests of 8 queries through Engine(slots="
          f"{ENGINE_ROWS}): accuracy {acc:.4f}, converged {conv_share:.4f}, "
          f"mean iterations {float(iters.mean()):.3f}; sweeps_per_step="
          f"{eng.sweeps_per_step} sweeps_total={eng.sweeps_total} steps="
          f"{eng.steps_total}; {NVSA_TASKS / wall:.1f} RPM answers/s, p50 "
          f"{snap['latency_p50_ms']:.3f} ms, p99 {snap['latency_p99_ms']:.3f} "
          f"ms, wall {wall * 1e3:.2f} ms; traced run (profiler on): wall "
          f"{wall_tr * 1e3:.2f} ms = submit "
          f"{(wall_tr - spent['step']) * 1e3:.2f} ms + steps "
          f"{spent['step'] * 1e3:.2f} ms (fill {spent['fill'] * 1e3:.2f}, "
          f"sweep bursts {spent['sweep-burst'] * 1e3:.2f}, retire with the "
          f"abduction tail {spent['retire'] * 1e3:.2f}); device busy "
          f"{busy:.3f} ms over the whole run ({busy / (wall_tr * 1e3):.1%} of "
          f"its wall)" + " " + since(), flush=True)
    if conv_share <= 0.9 or acc < 0.85:
        raise AssertionError(f"NVSA oracle cell: converged {conv_share} "
                             f"(needs > 0.9), accuracy {acc} (needs >= 0.85)")
    # solve's factorize-and-abduce stage over the same tasks in one batch,
    # with the same keys (drawn from the same seed)
    beliefs, res = nvsa.beliefs_from_queries(ctx.reshape(-1, NVSA_D),
                                             spec.codebooks, spec.valid_mask,
                                             9, cfg)
    ans_b, _ = nvsa.abduce_answers(beliefs.reshape(NVSA_TASKS, 8, 3, M), cand,
                                   spec.codebooks, cfg)
    ans_b = ans_b.cpu().numpy()
    idx_b = res.indices.cpu().numpy().reshape(NVSA_TASKS, 8, 3)
    it_b = res.iterations.cpu().numpy().reshape(NVSA_TASKS, 8)
    idx_e = np.stack([r.factorization.indices for r in reqs])
    fast = iters <= FAST_SWEEPS
    differ = (idx_e != idx_b).any(-1) | (iters != it_b)
    rows = [f"task {t} query {q} ({iters[t, q]} -> {it_b[t, q]} sweeps)"
            for t, q in zip(*np.nonzero(differ))]
    print(f"phase 23b: solve's stage on the card over the same {NVSA_TASKS} "
          f"tasks in one batch, same keys: {int(differ.sum())} of "
          f"{differ.size} rows differ from the engine's in indices or "
          f"iterations [{'; '.join(rows[:16])}]; of the {int(fast.sum())} "
          f"rows the engine settled within {FAST_SWEEPS} sweeps, "
          f"{int((differ & fast).sum())} differ; "
          f"{int((ans_b != answers).sum())} answers differ" + " " + since(), flush=True)
    if (differ & fast).any() or (ans_b != answers).any():
        raise AssertionError("NVSA: solve and Engine disagree on a fast row "
                             "or an answer")

    # (c) the image path, random CNN weights
    model = cnn.init(cfg.cnn, 1, device=dev)
    model_cpu = cnn.init(cfg.cnn, 1, device="cpu")
    imgs9 = torch.from_numpy(b["images"])  # the 9th panel is zero
    imgs = imgs9[:, :8]
    cimgs = torch.from_numpy(b["candidate_images"].copy())
    q_gpu = [nvsa.perceive(model, x.to(dev), cfg, spec.codebooks)
             for x in (imgs, cimgs)]
    q_cpu = [nvsa.perceive(model_cpu, x, cfg, cbs_cpu) for x in (imgs, cimgs)]
    diff = max((g.cpu() - c).abs().max().item() for g, c in zip(q_gpu, q_cpu))
    if not diff <= 1e-4:
        raise AssertionError(f"perceive on the card differs from the CPU by "
                             f"{diff} > 1e-4")
    reqs_i, eng_i, wall_i = _serve_nvsa(torch, engine, spec, *q_gpu, keys, dev)
    acc_i = float((np.array([r.result["answer"] for r in reqs_i]) == truth)
                  .mean())
    it_i = np.stack([r.iterations for r in reqs_i])
    out["image"] = {"wall_ms": wall_i * 1e3, "accuracy": acc_i,
                    "sweeps": eng_i.sweeps_total}
    print(f"phase 23c: NVSA image path, random CNN weights: "
          f"{2 * 8 * NVSA_TASKS} panels perceived on the card, within "
          f"{diff:.3g} of the CPU (atol 1e-4, TF32 off); {NVSA_TASKS} "
          f"requests all answered with finite sims; accuracy {acc_i:.4f} "
          f"(untrained weights: not a result), mean iterations "
          f"{float(it_i.mean()):.2f}, sweeps_total={eng_i.sweeps_total}, wall "
          f"{wall_i * 1e3:.2f} ms" + " " + since(), flush=True)

    # (d) the bipolar fused variant: one masked launch per sweep
    cfg_b = nvsa.NVSAConfig(vsa=vsa.VSAConfig(NVSA_D, NVSA_D))
    cfg_b = dataclasses.replace(cfg_b, factorizer=dataclasses.replace(
        cfg_b.factorizer, noise_std=0.0, restart_every=0, synchronous=True))
    spec_b = engine.registry.build("nvsa_abduction", 0, cfg=cfg_b,
                                   fused_step=True, device=dev)
    cbs_b = nvsa.make_codebooks(0, cfg_b, device="cpu")[0]
    ctx_b, cand_b = _nvsa_queries(torch, nvsa, cbs_b, b, cfg_b, 0.0, seed=0)
    _serve_nvsa(torch, engine, spec_b, ctx_b[:4].to(dev), cand_b[:4].to(dev),
                keys, dev)  # warm-up
    rs.masked_launches = 0  # the bipolar NVSA run starts here
    reqs_b, eng_b, wall_b = _serve_nvsa(torch, engine, spec_b, ctx_b.to(dev),
                                        cand_b.to(dev), keys, dev)
    launches = rs.masked_launches  # ... and ends here
    if launches != eng_b.sweeps_total or launches == 0:
        raise AssertionError(f"masked launches {launches} != sweeps_total "
                             f"{eng_b.sweeps_total}")
    attrs = np.stack([b[f"grid_{a}"].reshape(NVSA_TASKS, 9)[:, :8]
                      for a in raven.ATTRS], -1)
    idx_d = np.stack([r.factorization.indices for r in reqs_b])
    conv_d = np.stack([r.factorization.converged for r in reqs_b])
    right = (idx_d == attrs).all(-1)
    # A converged query decodes right.  Deterministic Jacobi sweeps leave a
    # few queries in a limit cycle, unconverged at max_iters, as the
    # reference's bipolar NVSA does on the same bits (tests/
    # test_torch_nvsa.py holds the two bitwise): 43 of the 2048 on the CPU.
    if not right[conv_d].all() or right.mean() < 0.97:
        raise AssertionError(f"bipolar NVSA: {int((~right).sum())} queries "
                             f"decoded wrong, {int((~right & conv_d).sum())} "
                             "of them converged")
    acc_b = float((np.array([r.result["answer"] for r in reqs_b]) == truth)
                  .mean())
    spec_c = engine.registry.build("nvsa_abduction", 0, cfg=cfg_b,
                                   fused_step=True, device="cpu")
    reqs_c, _, _ = _serve_nvsa(torch, engine, spec_c, ctx_b[:NVSA_REPLAY],
                               cand_b[:NVSA_REPLAY], keys,
                               torch.device("cpu"))
    # The factorization is integer arithmetic on +-1 operands: bitwise.  The
    # abduction tail is fp32 on soft beliefs (exp, cuBLAS): answers equal,
    # sims (cosines in [-1, 1], summed over D = 1024) within atol 1e-5.
    sims_diff = 0.0
    for t, (g, c) in enumerate(zip(reqs_b, reqs_c)):
        for f in ("indices", "iterations", "converged", "scores"):
            if not np.array_equal(getattr(g.factorization, f),
                                  getattr(c.factorization, f)):
                raise AssertionError(f"bipolar NVSA task {t}: card and CPU "
                                     f"{f} differ")
        np.testing.assert_allclose(g.factorization.reconstruction_sim,
                                   c.factorization.reconstruction_sim,
                                   rtol=1e-6)
        if g.result["answer"] != c.result["answer"]:
            raise AssertionError(f"bipolar NVSA task {t}: card and CPU "
                                 "answers differ")
        np.testing.assert_allclose(g.result["sims"], c.result["sims"],
                                   atol=1e-5, rtol=0)
        sims_diff = max(sims_diff, float(np.abs(g.result["sims"]
                                                - c.result["sims"]).max()))
    out["bipolar"] = {"wall_ms": wall_b * 1e3, "accuracy": acc_b,
                      "sweeps": eng_b.sweeps_total, "launches": launches}
    print(f"phase 23d: bipolar fused NVSA (D={NVSA_D}, lanes 1, Jacobi, noise "
          f"0): {NVSA_TASKS} requests, {int(right.sum())} of {right.size} "
          f"queries decoded to their attributes ({int(conv_d.sum())} converged"
          f", every converged one right; the rest limit cycles at max_iters), "
          f"accuracy {acc_b:.4f}; sweeps_total={eng_b.sweeps_total} masked "
          f"kernel launches={launches}; wall {wall_b * 1e3:.2f} ms, "
          f"{NVSA_TASKS / wall_b:.1f} RPM answers/s; {NVSA_REPLAY} requests "
          f"replayed on the CPU: indices, iterations, converged and scores "
          f"bit-equal, answers equal, sims within {sims_diff:.3g} (atol "
          f"1e-5)" + " " + since(), flush=True)

    # (e) the adSCH-planned stream: 8 task batches of 32, images
    runner = engine.build_pipeline(nvsa.stage_graph(
        model, spec.codebooks, spec.valid_mask, cfg, batch=NVSA_BATCH))
    if runner.depth != 2:
        raise AssertionError(f"NVSA pipeline depth {runner.depth} != 2")
    n = NVSA_T * NVSA_BATCH
    stream_i = imgs9[:n].reshape(NVSA_T, NVSA_BATCH, 9, 32, 32).to(dev)
    stream_c = cimgs[:n].reshape(NVSA_T, NVSA_BATCH, 8, 32, 32).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = runner((stream_i, stream_c), 13)
    torch.cuda.synchronize()
    t_pipe = time.perf_counter() - t0
    gens = engine.batch_generators(13, NVSA_T)
    t0 = time.perf_counter()
    want = torch.stack([nvsa.solve(model, {"images": stream_i[t],
                                           "candidate_images": stream_c[t]},
                                   spec.codebooks, spec.valid_mask, gens[t],
                                   cfg)["answer"] for t in range(NVSA_T)])
    torch.cuda.synchronize()
    t_seq = time.perf_counter() - t0
    if not torch.equal(got, want):
        raise AssertionError(f"pipelined stream != per-batch solve in "
                             f"{int((got != want).sum())} answers")
    out["stream"] = {"wall_ms": t_pipe * 1e3, "sequential_ms": t_seq * 1e3}
    print(f"phase 23e: NVSA stream through build_pipeline(stage_graph(batch="
          f"{NVSA_BATCH})): depth {runner.depth}, phases {runner.phase_names},"
          f" {NVSA_T} batches; answers equal to {NVSA_T} per-batch solve calls"
          f" with the same generators; wall {t_pipe * 1e3:.2f} ms against "
          f"{t_seq * 1e3:.2f} ms sequential (one stream: ordered, not "
          f"overlapped)" + " " + since(), flush=True)
    return out


# Phase 24: the supervised runtime over LVRF, NVSA and Llama 3.2 3B.
RT_JUNK = 8  # Gaussian LVRF rows that hold their slots to max_iters
RT_WAVES = 8  # the traffic goes in as this many interleaved waves
RT_NVSA_TASKS = 64
RT_LM_PROMPTS, RT_LM_NEW, RT_LM_SLOTS = 8, 16, 8
RT_LM_LENS = (16, 128)  # prompt lengths, uniform, inclusive
# The longest prompt, its 16 tokens and the overshoot of an adSCH decode
# burst (12 steps at 8 slots): 155 positions, 10 blocks a slot.
RT_LM_MAX_LEN = 160
RT_LM_LAYERS = None  # None: all 28 layers
RT_RETUNE_TO = 128  # the re-tune's one candidate: 256 -> 128 slots mid-run
RT_TIMEOUT_S = 600.0  # per-future wait; the phase takes seconds
# (b): the reference test's plans (tests/test_runtime_faults.py:569-579)
RT_CHAOS = {"lvrf": dict(seed=101, step_error_rate=0.12, corrupt_rate=0.08,
                         max_faults=3),
            "nvsa": dict(seed=202, step_error_rate=0.15, max_faults=2),
            "lm": dict(seed=303, step_error_rate=0.1, submit_reject_rate=0.3,
                       max_faults=3)}
# (c): best-effort rows that fill every slot twice over, then interactive
RT_OVER_JUNK, RT_OVER_GOOD = 2 * ENGINE_ROWS, 64
RT_COVERAGE = 0.95  # (d): the attribution's contract per request


def rt_traffic(torch, dev) -> dict:
    """Phase 24's engines' specs, weights and requests: phase 3's 512 LVRF
    rows plus RT_JUNK Gaussian rows, phase 23b's first 64 RAVEN tasks
    (oracle queries, 0.3 std noise), 8 prompts for Llama 3.2 3B; every key
    pinned."""
    import dataclasses

    import numpy as np

    from repro_torch import engine
    from repro_torch.configs import registry
    from repro_torch.core import factorizer as fz
    from repro_torch.device import generator
    from repro_torch.models import lvrf, nvsa
    from repro_torch.nn import transformer as T

    t = {}
    cfg = lvrf.LVRFConfig()
    atoms = lvrf.init_atoms(generator(0), cfg, device=dev)
    t["lvrf_spec"] = engine.registry.build("lvrf_rows", 0, fused_step=True,
                                           atoms=atoms, device=dev)
    t["vals"] = np.random.default_rng(1).integers(0, cfg.n_values, (512, 3))
    junk = np.random.default_rng(24).normal(size=(RT_JUNK, cfg.vsa.dim))
    t["lvrf_q"] = torch.cat([lvrf.encode_row(atoms, t["vals"], cfg),
                             torch.from_numpy(junk.astype(np.float32))
                             .to(dev)])
    t["lvrf_keys"] = fz.draw_keys(24, len(t["lvrf_q"]))
    cfg_n = nvsa.NVSAConfig()
    t["nvsa_spec"] = engine.registry.build("nvsa_abduction", 0, cfg=cfg_n,
                                           device=dev)
    b = _nvsa_tasks(render=False)
    cbs_cpu, _ = nvsa.make_codebooks(0, cfg_n, device="cpu")
    ctx, cand = _nvsa_queries(torch, nvsa, cbs_cpu, b, cfg_n, NVSA_NOISE,
                              seed=5)
    t["ctx"] = ctx[:RT_NVSA_TASKS].to(dev)
    t["cand"] = cand[:RT_NVSA_TASKS].to(dev)
    t["truth"] = b["answer"][:RT_NVSA_TASKS]
    t["nvsa_keys"] = fz.draw_keys(25, 8 * RT_NVSA_TASKS)
    lm_cfg = registry.get("llama3.2-3b").full()
    if RT_LM_LAYERS is not None:
        lm_cfg = dataclasses.replace(lm_cfg, n_layers=RT_LM_LAYERS)
    t["lm_cfg"], t["lm_model"] = lm_cfg, T.init(lm_cfg, 0, dev)
    rng = np.random.default_rng(33)
    t["prompts"] = [rng.integers(0, lm_cfg.vocab, int(k)) for k in
                    rng.integers(RT_LM_LENS[0], RT_LM_LENS[1] + 1,
                                 RT_LM_PROMPTS)]
    return t


def rt_engines(torch, dev, t, plans=None) -> dict:
    """Fresh engines at full width; wrapped in ChaosEngines when `plans`
    (name -> FaultPlan fields; a missing name gets the zero-rate plan)."""
    from repro_torch import engine, runtime
    from repro_torch.lm.paging import PagedConfig

    engs = {"lvrf": engine.Engine(t["lvrf_spec"], slots=ENGINE_ROWS,
                                  device=dev),
            "nvsa": engine.Engine(t["nvsa_spec"], slots=ENGINE_ROWS,
                                  device=dev),
            "lm": runtime.LMEngine(
                t["lm_cfg"], t["lm_model"], slots=RT_LM_SLOTS,
                max_len=RT_LM_MAX_LEN, device=dev,
                paged=PagedConfig(block_size=LM_BLOCK,
                                  prefill_chunk=LM_CHUNK))}
    if plans is None:
        return engs
    return {n: runtime.ChaosEngine(e, runtime.FaultPlan(**plans.get(n, {})))
            for n, e in engs.items()}


def rt_order(n_rows: int) -> list:
    """LVRF submission order: wave c leads with junk row c (so junk holds
    slots through the re-tune and the chaos plan's early steps), then its
    share of the 512 decodable rows."""
    per = n_rows // RT_WAVES
    return [[n_rows + c] + list(range(c * per, (c + 1) * per))
            for c in range(RT_WAVES)]


def _outcome(r, gid):
    """A future's result, or the exception it resolved to (a timeout is a
    hang and fails the phase)."""
    try:
        return r.result(gid, timeout=RT_TIMEOUT_S)
    except TimeoutError:
        raise
    except Exception as e:  # a structured fault; the caller checks its type
        return e


def rt_serve(torch, dev, t, engs, *, obs=None, failure=None,
             deadline_probe=False) -> dict:
    """One Runtime over the three engines (LVRF with a measured-cost re-tune
    policy); every request submitted from this thread in interleaved waves;
    returns each request's outcome by engine and index."""
    from repro_torch import runtime

    r = runtime.Runtime(obs=obs, failure=failure)
    r.register("lvrf", engs["lvrf"], retune=runtime.RetunePolicy(
        threshold=2.0, check_every=1, baseline_rps=1e-3,
        candidates=(RT_RETUNE_TO,), use_measured_cost=True))
    r.register("nvsa", engs["nvsa"])
    r.register("lm", engs["lm"])
    q, keys = t["lvrf_q"], t["lvrf_keys"]
    gids = {"lvrf": {}, "nvsa": {}, "lm": {}}
    per_n, per_p = RT_NVSA_TASKS // RT_WAVES, RT_LM_PROMPTS // RT_WAVES
    sync(torch, dev)
    t0 = time.perf_counter()
    with r:
        for c, wave in enumerate(rt_order(len(t["vals"]))):
            for i in wave:
                gids["lvrf"][i] = r.submit("lvrf", q[i], keys=keys[i][None])
            for k in range(c * per_n, (c + 1) * per_n):
                gids["nvsa"][k] = r.submit(
                    "nvsa", t["ctx"][k], keys=t["nvsa_keys"][8 * k:8 * k + 8],
                    meta={"cand": t["cand"][k]})
            for p in range(c * per_p, (c + 1) * per_p):
                gids["lm"][p] = r.submit("lm", t["prompts"][p],
                                         max_new_tokens=RT_LM_NEW)
        dead = r.submit("lvrf", q[-1], deadline_s=0.0) \
            if deadline_probe else None
        out = {n: {i: _outcome(r, g) for i, g in gs.items()}
               for n, gs in gids.items()}
        dead = None if dead is None else _outcome(r, dead)
        sync(torch, dev)
        wall = time.perf_counter() - t0
        stats = r.stats()
    return {"out": out, "dead": dead, "wall": wall, "stats": stats,
            "runtime": r}


def lm_solo(torch, dev, cfg, model, prompt, steps):
    """A solo greedy decode of `prompt` through ServeEngine (batch 1, the
    kernel path) and its top-2 logit gap at every step, in bf16 ulps of the
    top logit."""
    import math

    from repro_torch.launch.serve import ServeEngine
    from repro_torch.lm.paging import PagedConfig

    eng = ServeEngine(cfg, model, 1, RT_LM_MAX_LEN, device=dev,
                      paged=PagedConfig(block_size=LM_BLOCK,
                                        prefill_chunk=LM_CHUNK))
    eng.add_request(0, prompt)
    gaps = []
    for _ in range(steps):
        eng.step()
        top = torch.topk(eng.last_logits[0].float(), 2).values.tolist()
        ulp = 2.0 ** (math.floor(math.log2(abs(top[0]))) - 7)
        gaps.append((top[0] - top[1]) / ulp)
    return eng.generated[0][1:steps + 1], gaps


def rt_check_lm(req, solo, what) -> int | None:
    """Phase 13's greedy contract against a solo decode: equal tokens, or
    the first differing token at a near tie (the solo run's top-2 gap at
    most 2 x DEV_ULPS).  Returns the step where it parts, or None."""
    toks, (want, gaps) = req.result["tokens"], solo
    if len(toks) != RT_LM_NEW or req.result["truncated"]:
        raise AssertionError(f"{what}: {len(toks)} tokens, truncated "
                             f"{req.result['truncated']}")
    for k, (a, b) in enumerate(zip(toks, want)):
        if a != b:
            if gaps[k] > 2 * DEV_ULPS:
                raise AssertionError(
                    f"{what}: token {k} is {a}, the solo decode's {b}, at a "
                    f"top-2 gap of {gaps[k]:.1f} bf16 ulps > {2 * DEV_ULPS}")
            return k
    return None


def rt_check(t, run, ref, what, *, clean=None) -> dict:
    """The contracts of phase 24 on one run's outcomes: LVRF decodes right
    and bitwise equal to a bare Engine (and to `clean`, when given, with
    scores); junk unconverged at max_iters; NVSA answers, indices and
    converged flags equal to a bare Engine, iterations on rows that settle
    within FAST_SWEEPS; LM tokens by the greedy contract.  Exceptions are
    skipped here (the caller decides which are allowed)."""
    import numpy as np

    n, max_it = len(t["vals"]), t["lvrf_spec"].cfg.max_iters
    out = run["out"]
    for i, req in out["lvrf"].items():
        if isinstance(req, Exception):
            continue
        f, g = req.factorization, ref["lvrf"][i].factorization
        if i >= n:
            if bool(f.converged[0]) or int(f.iterations[0]) != max_it:
                raise AssertionError(f"{what}: junk row {i - n} did not run "
                                     f"to max_iters unconverged")
            continue
        if req.result["values"][0].tolist() != t["vals"][i].tolist():
            raise AssertionError(f"{what}: LVRF row {i} decoded wrong")
        fields = ("indices", "iterations", "converged")
        for field in fields:
            if not np.array_equal(getattr(f, field), getattr(g, field)):
                raise AssertionError(f"{what}: LVRF row {i} {field} differs "
                                     f"from the bare Engine's")
        if clean is not None:
            c = clean["out"]["lvrf"][i].factorization
            for field in fields + ("scores",):
                if not np.array_equal(getattr(f, field), getattr(c, field)):
                    raise AssertionError(f"{what}: LVRF row {i} {field} "
                                         f"differs from the clean run's")
    for k, req in out["nvsa"].items():
        if isinstance(req, Exception):
            continue
        g = ref["nvsa"][k]
        if req.result["answer"] != g.result["answer"]:
            raise AssertionError(f"{what}: NVSA task {k}'s answer differs "
                                 "from the bare Engine's")
        fast = g.iterations <= FAST_SWEEPS
        if not (np.array_equal(req.factorization.indices,
                               g.factorization.indices)
                and np.array_equal(req.factorization.converged,
                                   g.factorization.converged)
                and np.array_equal(req.iterations[fast], g.iterations[fast])):
            raise AssertionError(f"{what}: NVSA task {k} breaks the unitary "
                                 "contract against the bare Engine")
    parted = {}
    for p, req in out["lm"].items():
        if isinstance(req, Exception):
            continue
        parted[p] = rt_check_lm(req, ref["lm"][p], f"{what}: prompt {p}")
        if clean is not None and \
                req.result["tokens"] != clean["out"]["lm"][p].result["tokens"]:
            raise AssertionError(f"{what}: prompt {p}'s tokens differ from "
                                 "the clean run's")
    return parted


def rt_engine_line(rec) -> dict:
    """Per engine, from the request spans: requests/s over the engine's
    first submit to last result, and p50/p99 ms from submit to result."""
    import numpy as np

    spans: dict = {}
    for sp in rec.spans.snapshot():
        if sp.name == "request" and sp.t1 is not None:
            spans.setdefault(sp.args["engine"], []).append(sp)
    out = {}
    for name, sps in sorted(spans.items()):
        lat = np.array([sp.t1 - sp.t0 for sp in sps])
        span = max(sp.t1 for sp in sps) - min(sp.t0 for sp in sps)
        out[name] = {"requests": len(sps), "rps": len(sps) / span,
                     "p50_ms": float(np.percentile(lat, 50) * 1e3),
                     "p99_ms": float(np.percentile(lat, 99) * 1e3)}
    return out


def phase_runtime(torch, dev, rs, fd, card) -> dict:
    """(a) mixed traffic, (b) chaos, (c) fleet control, (d) attribution."""
    from repro_torch import engine, obs, runtime
    from repro_torch.runtime import runtime as rt_mod

    t_phase = time.perf_counter()

    def since() -> str:
        return f"[{time.perf_counter() - t_phase:.1f} s into phase 24]"

    t = rt_traffic(torch, dev)
    n = len(t["vals"])
    lm_cfg = t["lm_cfg"]
    print(f"phase 24: {n} LVRF rows + {RT_JUNK} junk, {RT_NVSA_TASKS} NVSA "
          f"tasks, {RT_LM_PROMPTS} prompts for {lm_cfg.name} "
          f"({lm_cfg.n_layers} layers, d {lm_cfg.d_model}, random bf16 "
          f"weights) ready {since()}", flush=True)

    # The references: bare engines and solo decodes, same keys.
    bare = engine.Engine(t["lvrf_spec"], slots=ENGINE_ROWS, device=dev)
    order = [i for wave in rt_order(n) for i in wave]
    ids = {i: bare.submit(t["lvrf_q"][i], keys=t["lvrf_keys"][i][None])
           for i in order}
    done = {r.id: r for r in bare.drain()}
    ref = {"lvrf": {i: done[ids[i]] for i in order}}
    reqs, _, _ = _serve_nvsa(torch, engine, t["nvsa_spec"], t["ctx"],
                             t["cand"], t["nvsa_keys"], dev)
    ref["nvsa"] = dict(enumerate(reqs))
    ref["lm"] = {p: lm_solo(torch, dev, lm_cfg, t["lm_model"], prompt,
                            RT_LM_NEW)
                 for p, prompt in enumerate(t["prompts"])}
    print(f"phase 24: references (bare Engine(slots={ENGINE_ROWS}) for LVRF "
          f"and NVSA, solo ServeEngine decodes) done {since()}", flush=True)

    # (a) the main path: mixed traffic under one Runtime(obs=Recorder()).
    measured = [0]  # launches of the re-tune's own sweep timings
    inner = rt_mod.retune_slots

    def counted(eng, *args, **kwargs):
        before = rs.launches
        try:
            return inner(eng, *args, **kwargs)
        finally:
            measured[0] += rs.launches - before

    rec = obs.Recorder()
    engs = rt_engines(torch, dev, t)
    rt_mod.retune_slots = counted
    try:
        rs.launches = fd.launches = 0  # the main path's run starts here
        run = rt_serve(torch, dev, t, engs, obs=rec)
        launches = {"resonator_step_batch": rs.launches,
                    "flash_decode": fd.launches}  # ... and ends here
    finally:
        rt_mod.retune_slots = inner
    errs = [(name, i, o) for name, d in run["out"].items()
            for i, o in d.items() if isinstance(o, Exception)]
    if errs:
        raise AssertionError(f"(a): {len(errs)} futures failed: {errs[:3]}")
    parted = rt_check(t, run, ref, "(a)")
    st, lv, lm = run["stats"], engs["lvrf"], engs["lm"]
    retunes = st["lvrf"]["telemetry"]["retunes"]
    if retunes < 1 or lv.slots == ENGINE_ROWS:
        raise AssertionError(f"(a): {retunes} re-tunes, LVRF slots "
                             f"{lv.slots}")
    if launches["resonator_step_batch"] != lv.sweeps_total + measured[0] \
            or lv.sweeps_total == 0:
        raise AssertionError(
            f"(a): resonator_step_batch launches "
            f"{launches['resonator_step_batch']} != the LVRF engine's "
            f"sweeps_total {lv.sweeps_total} + the re-tune's timed sweeps "
            f"{measured[0]}")
    steps = lm.serve.decode_dispatches
    if launches["flash_decode"] != lm_cfg.n_layers * steps or steps == 0:
        raise AssertionError(f"(a): flash_decode launches "
                             f"{launches['flash_decode']} != "
                             f"{lm_cfg.n_layers} x {steps} decode steps")
    diverged = {p: k for p, k in parted.items() if k is not None}
    print(f"phase 24a: mixed traffic through one Runtime on {card}: "
          f"{len(run['out']['lvrf'])} LVRF, {RT_NVSA_TASKS} NVSA and "
          f"{RT_LM_PROMPTS} LM requests, all resolved in "
          f"{run['wall'] * 1e3:.1f} ms; LVRF decodes right and bitwise equal "
          f"to the bare Engine, junk unconverged at max_iters, NVSA answers "
          f"equal (unitary contract), LM streams equal to solo decodes but "
          f"{len(diverged)} parting at near ties {diverged}; re-tunes "
          f"{retunes} (slots {ENGINE_ROWS} -> {lv.slots}, measured-cost: "
          f"{measured[0]} timed sweeps); resonator_step_batch launches "
          f"{launches['resonator_step_batch']} = sweeps_total "
          f"{lv.sweeps_total} + {measured[0]}; flash_decode launches "
          f"{launches['flash_decode']} = {lm_cfg.n_layers} x {steps} decode "
          f"steps " + since(), flush=True)

    # (b) chaos: the reference test's plans over fresh engines.
    chaos_engs = rt_engines(torch, dev, t, RT_CHAOS)
    fast = runtime.FailurePolicy(max_restarts=50, backoff_initial_s=0.01,
                                 backoff_max_s=0.05, health_check_every=1)
    chaos = rt_serve(torch, dev, t, chaos_engs, failure=fast,
                     deadline_probe=True)
    outs = [o for d in chaos["out"].values() for o in d.values()]
    unstructured = [o for o in outs if isinstance(o, Exception)
                    and not isinstance(o, runtime.FaultError)]
    if unstructured:
        raise AssertionError(f"(b): unstructured failures {unstructured[:3]}")
    if not isinstance(chaos["dead"], runtime.DeadlineExceededError):
        raise AssertionError(f"(b): the deadline_s=0 request gave "
                             f"{chaos['dead']!r}")
    st = chaos["stats"]
    states = {name: st[name]["supervision"]["state"] for name in chaos_engs}
    injected = {name: dict(e.injected) for name, e in chaos_engs.items()}
    recoveries = {name: st[name]["telemetry"]["recoveries"]
                  for name in chaos_engs}
    caught = sum(tag == "fault fault"
                 for _, tag in st["lvrf"]["supervision"]["events"])
    if set(states.values()) != {"serving"}:
        raise AssertionError(f"(b): engine states {states}")
    if not sum(sum(v.values()) for v in injected.values()) or \
            not sum(recoveries.values()):
        raise AssertionError(f"(b): injected {injected}, recoveries "
                             f"{recoveries}")
    if not injected["lvrf"]["corrupt"] or not caught:
        raise AssertionError(f"(b): corruptions {injected['lvrf']['corrupt']}"
                             f", caught by the health check {caught}")
    rejected = sum(isinstance(o, runtime.InjectedFault)
                   for o in chaos["out"]["lm"].values())
    if rejected != injected["lm"]["submit_reject"]:
        raise AssertionError(f"(b): {rejected} LM futures rejected, "
                             f"{injected['lm']['submit_reject']} injected")
    failed = sum(isinstance(o, Exception) for o in outs)
    rt_check(t, chaos, ref, "(b)")
    print(f"phase 24b: chaos (seeds 101/202/303, FailurePolicy(backoff "
          f"0.01-0.05 s, health check every step)) on {card}: every future "
          f"resolved, {failed} to structured faults ({rejected} LM submit "
          f"rejections) plus the deadline_s=0 request's "
          f"DeadlineExceededError; injected {injected}; recoveries "
          f"{recoveries}; {caught} NaN state corruption(s) caught by "
          f"health_check on the card; every engine serving; survivors meet "
          f"(a)'s contracts; wall {chaos['wall'] * 1e3:.1f} ms " + since(),
          flush=True)
    zero = rt_serve(torch, dev, t, rt_engines(torch, dev, t, {}))
    errs = [o for d in zero["out"].values() for o in d.values()
            if isinstance(o, Exception)]
    if errs:
        raise AssertionError(f"(b): zero-rate run failed {errs[:3]}")
    rt_check(t, zero, ref, "(b) zero-rate", clean=run)
    print(f"phase 24b: the same traffic through zero-rate ChaosEngines: "
          f"LVRF rows bitwise equal to (a) (indices, iterations, converged, "
          f"scores), LM tokens equal to (a)'s " + since(), flush=True)

    over = rt_fleet(torch, dev, t, card)

    # (d) attribution over (a)'s spans.
    rep = obs.attribution(rec)
    low = [r for r in rep["requests"] if r["coverage"] < RT_COVERAGE]
    if low:
        raise AssertionError(
            f"(d): {len(low)} requests' buckets cover < {RT_COVERAGE} of "
            f"their wall, e.g. {low[0]}")
    lines = rt_engine_line(rec)
    buckets = ("queue_wait", "fill", "sweep_burst", "decode_burst", "retire",
               "cross_engine", "dispatch", "ingest", "step_other", "retune",
               "other")
    for name, line in lines.items():
        rows = [r for r in rep["requests"] if r["engine"] == name]
        tot = {b: sum(r["queue_wait_s"] if b == "queue_wait"
                      else r["phases"].get(b, 0.0) for r in rows)
               for b in buckets}
        line["buckets_s"] = tot
        print(f"phase 24d: {name} on {card}: {line['requests']} requests, "
              f"{line['rps']:.1f} requests/s, p50 {line['p50_ms']:.2f} ms, "
              f"p99 {line['p99_ms']:.2f} ms submit to result; summed over "
              f"its requests (s): " + ", ".join(
                  f"{b} {v:.4f}" for b, v in tot.items()), flush=True)
    trace = ROOT / "chiprun_out" / "runtime_trace.json"
    trace.parent.mkdir(exist_ok=True)
    rec.write_chrome_trace(str(trace))
    print(f"phase 24d: attribution coverage min "
          f"{rep['coverage']['min']:.4f}, mean {rep['coverage']['mean']:.4f}"
          f" over {rep['coverage']['requests']} requests (>= {RT_COVERAGE} "
          f"each); Chrome trace in {trace.relative_to(ROOT)} " + since(),
          flush=True)
    del t, engs, chaos_engs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launches, "measured": measured[0], "fleet": over,
            "engines": lines, "wall_ms": run["wall"] * 1e3}


def rt_fleet(torch, dev, t, card) -> dict:
    """(c) A short overload of the LVRF engine: RT_OVER_JUNK best-effort
    Gaussian rows fill every slot twice over, then RT_OVER_GOOD interactive
    rows arrive; under a FleetController (priority fill, preemption) and as
    a FIFO baseline, against an SLO target of 30 measured warm steps."""
    import numpy as np

    from repro_torch import engine, obs, runtime
    from repro_torch.core import factorizer as fz

    rng = np.random.default_rng(61)
    junk = torch.from_numpy(rng.normal(size=(RT_OVER_JUNK, D))
                            .astype(np.float32)).to(dev)
    good = t["lvrf_q"][:RT_OVER_GOOD]
    jkeys, gkeys = fz.draw_keys(61, RT_OVER_JUNK), t["lvrf_keys"]
    # The target, as tests/test_fleet.py:539 sets it: 30 warm steps + 8 ms.
    # A step is timed at this shape's load: a full wave of best-effort rows
    # drained through a warm engine (at 256 slots the host's per-request
    # fill and retire work, not the sweep, sets a loaded step's time).
    eng = engine.Engine(t["lvrf_spec"], slots=ENGINE_ROWS, device=dev)
    eng.submit(junk[0], keys=jkeys[0][None])
    eng.drain()  # warm
    sync(torch, dev)
    t0 = time.perf_counter()
    for i in range(ENGINE_ROWS):
        eng.submit(junk[i], keys=jkeys[i][None])
    steps0 = eng.steps_total
    eng.drain()
    sync(torch, dev)
    t_step = (time.perf_counter() - t0) / max(1, eng.steps_total - steps0)
    target = 30.0 * t_step + 0.008

    def overload(fleet):
        e = engine.Engine(t["lvrf_spec"], slots=ENGINE_ROWS, device=dev)
        r = runtime.Runtime(slo={"interactive": obs.SLOTarget(target),
                                 "best_effort": obs.SLOTarget(target)},
                            fleet=fleet)
        r.register("lvrf", e)
        with r:
            jids = [r.submit("lvrf", junk[i], keys=jkeys[i][None],
                             class_="best_effort")
                    for i in range(RT_OVER_JUNK)]
            deadline = time.monotonic() + RT_TIMEOUT_S
            while time.monotonic() < deadline:
                live = sum(v["rows"] for v in e.live_requests().values())
                if live == ENGINE_ROWS and e.in_flight == RT_OVER_JUNK:
                    break
                time.sleep(0.0005)
            else:
                raise AssertionError("(c): best-effort rows never held the "
                                     "engine")
            steps0, t_burst = e.steps_total, time.perf_counter()
            gids = [r.submit("lvrf", good[i], keys=gkeys[i][None],
                             class_="interactive")
                    for i in range(RT_OVER_GOOD)]
            t_burst = time.perf_counter() - t_burst
            gouts = [_outcome(r, g) for g in gids]
            steps = e.steps_total - steps0
            outs = [_outcome(r, g) for g in jids] + gouts
            snap = r.stats()
        bad = [o for o in outs if isinstance(o, Exception)
               and not isinstance(o, runtime.FaultError)]
        if bad:
            raise AssertionError(f"(c): unstructured failures {bad[:3]}")
        for i, o in enumerate(outs[RT_OVER_JUNK:]):
            res = o.result.result if isinstance(o.result,
                                                runtime.DegradedResult) \
                else o.result
            if res["values"][0].tolist() != t["vals"][i].tolist():
                raise AssertionError(f"(c): interactive row {i} decoded "
                                     "wrong")
        snap["burst_ms"], snap["steps"] = t_burst * 1e3, steps
        return snap

    pol = runtime.FleetPolicy(classes=(
        runtime.PriorityClass("interactive", priority=0),
        runtime.PriorityClass("best_effort", priority=3, preemptible=True)),
        default_class="best_effort", max_preempt_per_tick=RT_OVER_GOOD,
        rebalance_every=0)
    snap_p, snap_b = overload(pol), overload(None)
    att_p = snap_p["slo"]["interactive"]["attainment"]
    att_b = snap_b["slo"]["interactive"]["attainment"]
    pre = sum(snap_p["fleet"]["preempted_rows"].values())
    print(f"phase 24c: overload of the LVRF engine on {card}: "
          f"{RT_OVER_JUNK} best-effort rows to max_iters, then "
          f"{RT_OVER_GOOD} interactive rows; SLO target {target * 1e3:.2f} ms"
          f" (30 warm steps of {t_step * 1e3:.3f} ms at {ENGINE_ROWS} live "
          f"rows + 8 ms); interactive "
          f"attainment {att_p} under the FleetController ({pre} rows "
          f"preempted), {att_b} as FIFO; " + "; ".join(
              f"{tag}: interactive p50/p99 "
              f"{sn['slo']['interactive']['latency_p50_s'] * 1e3:.2f}/"
              f"{sn['slo']['interactive']['latency_p99_s'] * 1e3:.2f} ms, "
              f"their {RT_OVER_GOOD} submits took {sn['burst_ms']:.2f} ms on "
              f"this thread, {sn['steps']} engine steps until the last "
              f"interactive result"
              for tag, sn in (("policy", snap_p), ("FIFO", snap_b))),
          flush=True)
    if att_p is None or att_p < 0.9 or pre == 0:
        raise AssertionError(f"(c): interactive attainment {att_p} under the "
                             f"policy (needs >= 0.9), {pre} preempted rows")
    return {"attainment": att_p, "fifo_attainment": att_b,
            "target_ms": target * 1e3, "preempted": pre}


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
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.similarity import ops as sim
    from repro_torch.kernels.circconv import ops as cc

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
    fd_err = phase_flash_decode(torch, dev, fd)
    fd_launches, fd_lens = phase_lm_serving(torch, dev, fd, card)
    fd_times = phase_fd_timing(torch, dev, fd, fd_lens, card)
    local_err = phase_local_kernel(rs, ref, torch, dev)
    sharded = phase_sharded(torch, dev, rs, card)
    local_times = phase_local_timing(torch, dev, rs, ref, card)
    cc_err = phase_circconv(torch, dev, cc)
    mimo = phase_mimonet(torch, dev, cc, card)
    hrr_launches = phase_hrr(torch, dev, cc)
    cc_times = phase_circconv_timing(torch, dev, cc, card)
    nvsa_kernel = phase_nvsa_kernel(torch, dev, rs, ref, card)
    nvsa_run = phase_nvsa(torch, dev, rs, card)
    rt_run = phase_runtime(torch, dev, rs, fd, card)

    src = "src/repro_torch/kernels/resonator_step/csrc/resonator_step.cu"
    kernels = [
        {"name": "resonator_step_batch", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/resonator_step/kernel.py:153",
         "launches": dense_launches,
         "max_abs_err": err["resonator_step_batch"],
         **times["resonator_step_batch"], "library_ms": None,
         "runtime_launches": rt_run["launches"]["resonator_step_batch"],
         "runtime_timed_sweeps": rt_run["measured"]},
        {"name": "resonator_step_batch_masked", "route": "cuda",
         "source": src,
         "replaces": "src/repro/kernels/resonator_step/kernel.py:184",
         "launches": masked_launches,
         "max_abs_err": max(err["resonator_step_batch_masked"],
                            nvsa_kernel["max_abs_err"]),
         **times["resonator_step_batch_masked"], "library_ms": None,
         "nvsa_launches": nvsa_run["bipolar"]["launches"],
         "nvsa_shape": f"N = {ENGINE_ROWS}, F = {F}, M = {M}, D = {NVSA_D}",
         **{f"nvsa_{key}": nvsa_kernel[key]
            for key in ("ms", "plain_ms", "bound_ms", "bound_by")}},
        {"name": "resonator_step_batch_local", "route": "cuda",
         "source": src,
         "replaces": "src/repro/kernels/resonator_step/kernel.py:218",
         "launches": sharded["rows"]["launches"][2],
         "max_abs_err": local_err, **local_times, "library_ms": None},
        {"name": "similarity_int8", "route": "cuda",
         "source": "src/repro_torch/kernels/similarity/csrc/similarity_int8.cu",
         "replaces": "src/repro/kernels/similarity/kernel.py:29",
         "launches": sim_launches, "max_abs_err": sim_err, **sim_times},
    ] + [
        {"name": f"flash_decode[{kv}]", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode/kernel.py:87",
         "launches": fd_launches[kv], "max_abs_err": fd_err[kv],
         **fd_times[kv],
         **({"runtime_launches": rt_run["launches"]["flash_decode"]}
            if kv == "bf16" else {})}
        for kv in ("bf16", "int8")
    ] + [
        {"name": "circconv_rows", "route": "cuda",
         "source": "src/repro_torch/kernels/circconv/csrc/circconv.cu",
         "replaces": "src/repro/kernels/circconv/kernel.py:55",
         "launches": mimo["launches"], "max_abs_err": cc_err["rows"],
         "shape": "MIMONet bind, S = 2",
         **{key: v for key, v in cc_times["bind S=2"].items()
            if key != "vsa_ms"}},
        {"name": "circconv_single_mxu", "route": "cuda",
         "source": "src/repro_torch/kernels/circconv/csrc/circconv.cu",
         "replaces": "src/repro/kernels/circconv/kernel.py:101",
         "launches": hrr_launches, "max_abs_err": cc_err["single"],
         "shape": f"L = {CC_TIMED_L}",
         **{key: v for key, v in cc_times["single"].items()
            if key != "floor_ms"}},
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
