#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit:  ``python3 chip_smoke.py``.  It builds every CUDA kernel of the
port from the checkout's sources (into ``build/kernels/``), then:

  1. prints the card's name and power limit and the build time, and ptxas's
     registers, stack frame and spills of flash_decode's tensor-core
     instantiations (rep 9-16; any spill fails);
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
     serving shape of Llama 3.2 3B, at rows on and next to the split
     boundaries of 2, 4 and 8 blocks a cluster, and at the other configs'
     head shapes (Granite rep 3 dh 64; starcoder2 rep 12, rep 10 and rep 16
     on the tensor-core kernel, one launch each), bf16 and int8 pools
     (2e-5); then with a sliding window (phase 11b: Mellum2's sliding
     layers, rep 8 and a window of 1024, and a window of 1000 at rep 8
     and rep 12, every split count);
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
 25. trains the paper's workloads on the card and serves the trained nets
     through the ported kernels: (a) the NVSA/PrAE frontend at
     ``NVSAConfig()``'s widths (CNN 686,741 parameters, D = 1024) by
     ``examples/torch_raven_abduction.py::get_frontend``, 4000 AdamW steps
     of 128 panels (loss and cosine every 1000 steps, steps/s, host data
     time against the steps), saved and loaded back; PrAE accuracy on the
     reference test's batch and on 256 tasks (>= 0.85); the NVSA image path
     on those 256 tasks through ``registry.build("nvsa_abduction")`` and
     ``Engine(slots=256)`` (accuracy within 0.05 of the reference's CPU
     figure, RPM answers/s); the bipolar fused variant on the same
     frontend (masked launches = sweeps); (b) MIMONet at
     ``MIMONetConfig()`` width by
     ``examples/torch_mimonet_superposition.py::train_eval`` at S = 1, 2, 4
     (600 steps, impl="fft"; held-out accuracy within 0.03 of the
     reference's CPU figure), then served with impl="pallas": 2
     ``circconv_rows`` launches a batch, logits against impl="fft" at atol
     1e-5, rtol 1e-4, predictions equal but at near ties, panels/s each;
 26. serves Granite-MoE 3B at full size (32 layers, d 1536, 24/8 heads of
     64, 40 experts top-8 of width 512, vocab 49155; 3,374,295,552 random
     bf16 parameters drawn on the card) through ``LMEngine(slots=32, paged
     bs 16, chunk 64)``: Llama's 64 greedy requests, every one complete, no
     non-finite logit, flash_decode launches = 32 x decode steps; the MoE's
     dropped share at prefill and at decode, wall, tokens/s, p50/p99, the
     decode step's host and device time; the greedy contract on 8 prompts,
     where a pair past 8 ulps is excused only on a row whose MoE routing
     differed between the two runs at that step or before (named), and a
     routing difference needs a router top-K margin of at most 1 bf16 ulp;
 27. serves starcoder2-3b at full size (rep 12: 24 query heads over 2 KV
     heads of 128) through the same LMEngine: 16 requests, complete,
     flash_decode launches = 30 x decode steps; then 8 requests with the
     int8 KV pool, the same checks;
 28. runs every other architecture at full width: minicpm-2b, whisper-small
     (1500 frames) and xlstm-125m whole; qwen2.5-32b at 4 layers,
     qwen2-vl-72b at 2 (256 vision patches, M-RoPE), dbrx-132b at 2 and
     jamba-1.5-large-398b at one period of 8 with 4 of 16 experts:
     ``forward`` + ``loss_fn`` on 4 x 512 tokens (finite; tokens/s, peak
     memory) and 16 greedy decode steps (the contiguous ``ServeEngine``
     where the reference serves the model, ``decode_step`` for whisper and
     qwen2-vl);
 29. all ten architectures at smoke shapes, the same weights on the card and
     on the CPU: forward logits, loss and 8 decode steps, fp32 within 1e-5
     of each row's largest |logit| (decode steps 2e-5) and bf16 within 8
     ulps of it (a row the two runs route otherwise through a MoE is
     excused and named);
 30. times flash_decode at Granite's shape (rep 3, dh 64) and starcoder2's
     (rep 12, dh 128; bf16 and int8, the tensor-core kernel: no slower than
     SDPA cold) and at rep 16, cold L2, beside its bound, plain version and
     SDPA, with the time at each split count;
 31. trains by ``launch/train.py``'s recipe (batch 8 x 128 tokens of
     ``TokenDataset``, AdamW at fp32 state, cosine 3e-4, clip 1.0, remat
     "full"): (a) Llama 3.2 3B at full width in the training layout
     (3,606,752,256 fp32 masters), 30 steps, ce lowered, every loss and
     gradient norm finite, steps/s, tokens/s, host data time and peak
     memory; then the optimizer state freed, the serving copy (bf16 matmul
     weights) through ``LMEngine(slots=16)``: 16 requests of 16-256
     tokens, 16 new, flash_decode launches = 28 x decode steps, and the
     greedy contract on 8 prompts; (b) Granite-MoE 3B at full width, 10
     steps, its dropped share; (c) all ten architectures at smoke shapes,
     the same fp32 masters and batch on the card and on the CPU: one
     step's loss and every leaf's gradient (fp32 and bf16) and the
     parameters after 3 steps of each spec's recipe; (d) int8 gradient
     compression with error feedback on 8 logical data shards, the
     reference test's least squares, exact and int8, 400 steps each;
 32. distribution and modelling at Llama 3.2 3B's full width (random bf16
     weights drawn on the card): (a) its 28 blocks as 4 stages of 7
     on a ``pipe`` axis of 4 logical stages on the card, 8 microbatches of
     2 x 512 tokens through ``pipeline_apply`` (embedding and head outside),
     bitwise equal to ``sequential_apply``; walls, the bubble fraction, the
     ``ppermute`` count and peak memory; (b) the roofline bound of three LM
     steps (``costmodel.step_cost`` priced by ``roofline_terms`` at one
     card: prefill of 1 x 4096 tokens, a contiguous decode step at 32 slots
     of 560, a train step of 8 x 128 tokens in the training layout) beside
     each step's device time and host wall; a device time below its bound
     fails; ``compat.cost_analysis``'s FLOPs of the prefill beside
     ``costmodel.forward_flops``.  No kernel launches here;
 33. runs the six user examples (``examples/torch_{quickstart,lvrf_ood,
     engine_serving,runtime_serving,fleet_overload,tracing}.py``) on the
     card as a user runs them (``runpy`` as ``__main__`` with ``--device
     cuda``, traces under a temporary directory), every kernel counter set
     to 0 before each and read after: quickstart's int8 factorization
     launches ``similarity_int8`` F x its iterations; ``runtime_serving``
     and ``tracing`` run contiguous, then with ``REPRO_LM_PAGED=1``, with
     the same LM tokens and LVRF decodes, ``flash_decode`` launched n_layers
     x decode steps paged and never contiguous; ``tracing`` injects one
     fault and recovers once; lvrf_ood, engine_serving and fleet_overload
     launch no kernel.  Each example's figures and wall;
 34. prints one JSON line describing every kernel, the card line, and as
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
# The other configs' head shapes (G, rep, dh): Granite-MoE 3B, starcoder2-3b,
# and the tensor-core kernel's other reps (one M = 16 tile of query heads).
FD_CONFIG_SHAPES = {"granite-moe-3b-a800m": (8, 3, 64),
                    "starcoder2-3b": (2, 12, 128), "rep 10": (2, 10, 128),
                    "rep 16": (2, 16, 128)}
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
    # the other configs' head shapes at the serving window (32 slots, bs 16,
    # 35 blocks a row), lengths from 0 to the full window
    width = -(-LM_MAX_LEN // LM_BLOCK)
    lens = np.random.default_rng(15).integers(1, LM_MAX_LEN + 1, LM_SLOTS)
    lens[:2] = (0, LM_MAX_LEN)
    kv_lens = torch.from_numpy(lens.astype(np.int32)).to(dev)
    for name, (g, rep, dh) in FD_CONFIG_SHAPES.items():
        for kv in ("bf16", "int8"):
            q, pool, table = fd_inputs(torch, LM_SLOTS, g, rep, dh, LM_BLOCK,
                                       width, kv, 16 + rep, dev, dh ** -0.5)
            d = max(check(kv, q, pool, table, kv_lens, f"{name}'s shape"),
                    check(kv, q, pool, table, kv_lens,
                          f"{name}'s shape, 8 blocks a cluster", 8))
            err[f"{name}, {kv}"] = d
            cores = ("tensor" if rep >= fdk.WIDE_MIN_REP else "CUDA")
            print(f"phase 11: flash_decode ({kv} pool) at {name}'s shape B="
                  f"{LM_SLOTS} G={g} rep={rep} ({cores} cores) dh={dh} "
                  f"bs={LM_BLOCK} W={width}: max |kernel - plain| {d:.3g} "
                  f"(split count chosen and 8)", flush=True)
    return err


# Sliding-window flash_decode (phase 11b): Mellum2-12B-A2.5B's sliding
# layers (G 4, rep 8, window 1024 over 4096 positions), and a window that
# does not divide the block on both kernels (rep 8 and rep 12).
FD_WINDOW_CASES = ((4, 8, 1024), (4, 8, 1000), (2, 12, 1000))
FD_WINDOW_TABLE = 256  # blocks of 16 a row: 4096 positions


def phase_flash_decode_window(torch, dev, fd):
    """flash_decode with a sliding window against its plain version on the
    card (bf16 and int8 pools, the split count chosen and each forced one):
    rows shorter than, at and past the window and at the full table.
    Returns the max |kernel - plain|."""
    import numpy as np

    from repro_torch.kernels.flash_decode import kernel as fdk

    worst = 0.0
    cap = LM_BLOCK * FD_WINDOW_TABLE
    for g, rep, window in FD_WINDOW_CASES:
        lens = [0, 1, 17, window - 1, window, window + 1, window + 17,
                2 * window + 5, cap - 1, cap]
        lens += np.random.default_rng(window + rep).integers(
            1, cap + 1, LM_SLOTS - len(lens)).tolist()
        kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        for kv in ("bf16", "int8"):
            q, pool, table = fd_inputs(torch, LM_SLOTS, g, rep, 128, LM_BLOCK,
                                       FD_WINDOW_TABLE, kv, window + rep, dev,
                                       128 ** -0.5)
            ks, vs = pool.get("k_scale"), pool.get("v_scale")
            want = fd.flash_decode_plain(q, pool["k"], pool["v"], table,
                                         kv_lens, ks, vs, window)
            for splits in (None, 1, 2, 4, 8):
                before = fd.launches
                got = fdk.flash_decode(q, pool["k"], pool["v"], table, kv_lens,
                                       k_scale=ks, v_scale=vs, window=window,
                                       splits=splits)
                torch.cuda.synchronize()
                if fd.launches != before + 1:
                    raise AssertionError("phase 11b: not one launch")
                diff = (got - want).abs()
                worst = max(worst, diff.max().item())
                if not bool((diff <= FD_ATOL + FD_RTOL * want.abs()).all()):
                    raise AssertionError(
                        f"phase 11b: flash_decode ({kv}) at G={g} rep={rep} "
                        f"window {window}, splits {splits}: max |kernel - "
                        f"plain| {diff.max().item()}")
        print(f"phase 11b: flash_decode with a window of {window} at B="
              f"{LM_SLOTS} G={g} rep={rep} dh=128 bs={LM_BLOCK} W="
              f"{FD_WINDOW_TABLE}, bf16 and int8 pools, the split count "
              f"chosen and 1, 2, 4, 8: within atol {FD_ATOL}, rtol {FD_RTOL} "
              f"of its plain version (max so far {worst:.3g})", flush=True)
    return worst


def lm_prompts(n, vocab, seed=31, lens=LM_PROMPTS):
    """`n` prompts of lengths uniform in `lens` (inclusive), random token
    ids."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(lens[0], lens[1] + 1, n)
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


def serve_lm(torch, dev, cfg, model, prompts, fd, tag, *, slots=LM_SLOTS,
             new=LM_NEW, max_len=LM_MAX_LEN):
    """Drain `prompts` through LMEngine(slots) on the card, `new` tokens
    each; check every request and the launch count; return the run's
    numbers."""
    from repro_torch import obs, runtime
    from repro_torch.lm.paging import PagedConfig

    rec = obs.Recorder()
    eng = runtime.LMEngine(
        cfg, model, slots=slots, max_len=max_len, obs=rec, device=dev,
        paged=PagedConfig(block_size=LM_BLOCK, prefill_chunk=LM_CHUNK))
    bad = _nan_tap(torch, eng.serve)
    torch.cuda.synchronize()
    fd.launches = 0  # this path's run starts here
    t0 = time.perf_counter()
    ids = [eng.submit(p, max_new_tokens=new) for p in prompts]
    done = {r.id: r for r in eng.drain()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fd.launches  # ... and ends here
    short = [i for i in ids if len(done[i].tokens) != new
             or done[i].truncated]
    if short:
        raise AssertionError(f"{tag}: {len(short)} requests without "
                             f"{new} tokens or truncated")
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
    kern = [e for e in prof.key_averages()  # kernels, not annotated ranges
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
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


def lm_breakdown(torch, dev, cfg, model, lens, fd, card, phase=12):
    """Where a decode step and a prefill chunk spend their time, at the
    run's shape (LM_SLOTS active slots at `lens`; one LM_CHUNK-token chunk
    at position 256) on a pool of the run's size: device time from
    CUDA-graph replay (the kernels back to back, no host), host wall of an
    eager call ended by a sync, and a profiler trace of the eager decode
    step (kernels launched, device busy time, the costliest kernels).
    Returns {"decode step" / "prefill chunk": (device ms, host wall ms),
    "profile": the trace's summary}."""
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
    print(f"phase {phase}: breakdown on {card}: decode step ({LM_SLOTS} "
          f"slots, "
          f"mean length {np.mean(lens):.0f}) device {out['decode step'][0]:.3f} "
          f"ms (CUDA graph), host wall eager {out['decode step'][1]:.3f} ms; "
          f"prefill chunk ({LM_CHUNK} tokens at position 256) device "
          f"{out['prefill chunk'][0]:.3f} ms, host wall eager "
          f"{out['prefill chunk'][1]:.3f} ms", flush=True)
    print(f"phase {phase}: profiler, eager decode step: {prof}", flush=True)
    del pool
    return {**out, "profile": prof}


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
                    steps=LM_NEW, tap=None):
    """The same prompts through two ServeEngines in lockstep, one with the
    kernel and one with the dense path (``use_flash=False``).

    The kernel run is fed the dense run's token at every step, so each of
    the len(prompts) x steps (row, step) pairs is compared, not only those
    before a stream first takes another token.  The contract: at every pair,
    max |dlogit| over the vocabulary is at most DEV_ULPS bf16 ulps of the
    dense row's top logit.  A pair where the tokens differ then has a dense
    top-2 gap of at most 2 * DEV_ULPS (the two logits moved by at most
    DEV_ULPS each): a near tie.

    With a MoE (``tap``, a :class:`MoETap`), a pair may exceed DEV_ULPS
    only on a row whose routing (an expert chosen, or a slot kept) differed
    between the two runs at that step or an earlier one (its KV differs
    from then on); such pairs are named.  A routing difference at a step
    needs a router top-K margin of at most ROUTER_TIE_ULPS bf16 ulps in the
    dense run at that step (the rows of a decode step share one routing
    group, so one flipped choice can move every row's drops).  Returns
    (diverging streams, first step's max |dlogit|, excused pairs)."""
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
    gaps, pinned, excused, tie_steps, flip_steps = [], 0, [], 0, 0
    tainted = torch.zeros(len(prompts), dtype=torch.bool)
    for step in range(steps):
        if tap is not None:
            tap.routes = []
        kern.step()
        if tap is not None:
            routes_k, tap.routes, tap.margins = tap.routes, [], []
        plain.step()
        if tap is not None:
            margin = float(torch.stack(tap.margins).min())
            changed = tap.changed_rows(routes_k, tap.routes).cpu()
            tap.margins = tap.routes = None
            tie_steps += margin <= ROUTER_TIE_ULPS
            if bool(changed.any()):
                flip_steps += 1
                if margin > ROUTER_TIE_ULPS:
                    raise AssertionError(
                        f"greedy ({kv}): the two runs route rows "
                        f"{changed.nonzero().flatten().tolist()} differently "
                        f"at step {step}, where the dense run's smallest "
                        f"router top-K margin is {margin:.0f} bf16 ulps")
            tainted |= changed
        lk, lp = kern.last_logits, plain.last_logits
        top = torch.topk(lp, 2, dim=-1).values
        ulp = torch.exp2(torch.floor(torch.log2(top[:, 0].abs())) - 7)
        dev_ulps = ((lk - lp).abs().amax(-1) / ulp).cpu()
        gap = ((top[:, 0] - top[:, 1]) / ulp).cpu()
        if step == 0:
            d0 = (lk - lp).abs().max().item()
        if bool(tainted.any()):
            for s in range(len(prompts)):
                if tainted[s] and float(dev_ulps[s]) > DEV_ULPS:
                    excused.append(f"(row {s}, step {step}: "
                                   f"{float(dev_ulps[s]):.1f} ulps)")
            dev_ulps = torch.where(tainted & (dev_ulps > DEV_ULPS), 0.0,
                                   dev_ulps)
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
          f"step's max |dlogit| {d0:.4g}"
          + ("" if tap is None else
             f"; {tie_steps} of {steps} steps had a router top-K margin of "
             f"at most {ROUTER_TIE_ULPS} bf16 ulp in the dense run, "
             f"{flip_steps} routed some row differently in the two runs "
             f"({int(tainted.sum())} of {len(prompts)} rows by the end); "
             f"pairs past the limit on "
             f"such rows: {len(excused)} [{', '.join(excused)}]"),
          flush=True)
    return len(diverged), d0, excused


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


def phase_fd_timing(torch, dev, fd, lens, card, *, g=8, rep=3, dh=128,
                    kvs=("bf16", "int8"), phase=15, gate=True):
    """flash_decode at the serving shape, its plain version, its bound and
    one library call (SDPA over K/V already gathered into a contiguous
    window with a length mask; the gather is not timed), bf16 and int8
    pools, device time from CUDA-graph replay, in turns.

    Cold: each graph rotates over FD_COLD_SETS input sets whose live K/V
    together exceed twice the L2, as in serving, where each layer reads its
    own slice of the pool; the bound share and the comparison with SDPA use
    these.  Warm: one input set, replayed, partly from the L2.  Also cold:
    every row at the mean length, and each forced split count.  ``gate``:
    the kernel must be no slower than SDPA cold (phase 15's shapes and
    starcoder2-3b's; Granite's and rep 16 are timed, not gated)."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import kernel as k

    width = -(-LM_MAX_LEN // LM_BLOCK)
    kv_lens = torch.from_numpy(np.asarray(lens, np.int32)).to(dev)
    even = torch.full_like(kv_lens, int(round(float(np.mean(lens)))))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chosen = {kv: k.split_count(
        LM_SLOTS, g, width * LM_BLOCK, sms,
        k.wide_clusters(dev.index or 0, dh, kv == "int8")
        if rep >= k.WIDE_MIN_REP else None) for kv in kvs}
    out = {}
    for kv in kvs:
        b_ms, b_by, nbytes = fd_bound(lens, g, rep, dh, kv == "int8")
        n_sets = (FD_COLD_SETS[kv] if (g, rep, dh) == (8, 3, 128)
                  else int(2 * L2_BYTES // nbytes) + 1)
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
                   "library_warm_ms": l_warm, "splits": chosen[kv],
                   "by_split": by_split}
        print(f"phase {phase}: flash_decode ({kv} pool) at B={LM_SLOTS} G={g} "
              f"rep={rep} dh={dh} bs={LM_BLOCK} W={width}, mean live length "
              f"{np.mean(lens):.0f}, {chosen[kv]} blocks a cluster (split_count, "
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
            raise AssertionError(f"phase {phase}: flash_decode ({kv}) reads "
                                 f"at {b_ms / ms:.1%} of its HBM bound cold: "
                                 "the L2 is not cold")
        if gate and ms > lib_ms:
            raise AssertionError(f"phase {phase}: flash_decode ({kv}) "
                                 f"{ms:.5f} ms cold is slower than SDPA's "
                                 f"{lib_ms:.5f}")
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
MIMO_LOGIT_SCALE = 0.05  # phase 20's logits (max |logit| 0.042-0.070)


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


def _logits_agree(torch, got, want, what, scale: float = 1.0):
    """Every logit finite and within scale x MIMO_ATOL + MIMO_RTOL |want|
    (``scale``: the logits' magnitude over phase 20's, MIMO_LOGIT_SCALE)."""
    for a, (g, w) in enumerate(zip(got, want)):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}: attribute {a} has a non-finite "
                                 "logit")
        diff = (g - w).abs()
        if not bool((diff <= scale * MIMO_ATOL + MIMO_RTOL * w.abs()).all()):
            raise AssertionError(f"{what}: attribute {a} logits differ from "
                                 f"the fft run by up to {diff.max().item()}")


def _losses_agree(torch, mm, model, batch, cfg, fft, scale: float = 1.0):
    """loss_fn through the kernel against the fft run: the loss within
    1e-5 relative, or within what the logits' differences allow where that
    is more (a log-softmax moves by at most twice its logits' largest move,
    and the loss sums one a attribute); a prediction may differ only at a
    near tie (the fft run's top two logits within twice the logits'
    tolerance, scale x MIMO_ATOL + MIMO_RTOL |logit|), and each accuracy
    only by such predictions.  Returns (near ties taken, |loss difference|,
    largest |logit difference|)."""
    loss, accs = mm.loss_fn(model, batch, cfg)
    loss_f, accs_f = mm.loss_fn(model, batch, fft)
    logits = mm.apply(model, batch["images"], cfg)
    logits_f = mm.apply(model, batch["images"], fft)
    moves = [(g - w).abs().max().item() for g, w in zip(logits, logits_f)]
    dloss = abs(loss.item() - loss_f.item())
    if dloss > max(1e-5 * abs(loss_f.item()), 2 * sum(moves)):
        raise AssertionError(f"loss {loss.item()} against the fft run's "
                             f"{loss_f.item()}")
    ties = 0
    for a, name in enumerate(mm.ATTRS):
        flip = logits[a].argmax(-1) != logits_f[a].argmax(-1)
        top2 = logits_f[a].topk(2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]
        slack = 2 * (scale * MIMO_ATOL + MIMO_RTOL * top2[..., 0].abs())
        if bool((flip & (gap > slack)).any()):
            raise AssertionError(f"{name}: a prediction differs from the fft "
                                 "run away from a near tie")
        n = int(flip.sum())
        ties += n
        if abs(accs[name].item() - accs_f[name].item()) > (
                n / flip.numel() + 1e-6):
            raise AssertionError(f"{name} accuracy {accs[name].item()} "
                                 f"against the fft run's {accs_f[name].item()}")
    return ties, dloss, max(moves)


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
        ties = sum(_losses_agree(torch, mm, model, b, cfg, fft)[0]
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


# Phase 25: training the paper's workloads on the card, the trained nets
# served through the ported kernels.
TRAIN_STEPS = 4000  # get_frontend's full run (examples/raven_abduction.py)
TRAIN_PATH = ROOT / "build" / "train" / "nvsa_frontend_torch.pt"
MIMO_TRAIN_STREAMS = (1, 2, 4)
MIMO_TRAIN_STEPS = 600  # train_eval's (examples/mimonet_superposition.py)
PRAE_MIN = 0.85  # tests/test_superposition_prae.py::test_prae_oracle_images
NVSA_IMAGE_BAND = 0.05  # NVSA image-path accuracy against the reference's
MIMO_ACC_BAND = 0.03  # MIMONet held-out accuracy against the reference's
# The reference's figures on the CPU (jax 0.9.0, 8 cores), from its own
# example trainers run by tools/reference_train_figures.py: `--init
# reference --seeds 5` (its own initial draws; MIMONet at seeds 0-4, the
# seed of both the init and the batches) and `--init port` (the port's
# initial weights and codebooks, which this phase trains: the same start,
# seed 0).  Training is chaotic (MIMONet S = 1 moves by several points
# between seeds, and between starts 1e-6 apart), so a figure is the range
# of the reference's runs, and the port's result must lie within the band
# of that range.
REF_PRAE_TEST = (1.0, 1.0)  # prae.accuracy, the reference test's batch
REF_PRAE_256 = (0.97265625, 0.97265625)  # ... RavenConfig(batch_size=256)
# nvsa.solve on those 256 tasks, keys 7, 8, 9: 0.97265625 x 3 (own init),
# 0.9765625, 0.9765625, 0.96875 (the port's init)
REF_NVSA_IMAGE = (0.96875, 0.9765625)
# train_eval's held-out accuracy, seeds 0-4 then the port's init
REF_MIMO = {1: (0.8841145833333334, 0.9583333333333334, 0.9752604166666666,
                0.9505208333333334, 0.9713541666666666, 0.9505208333333334),
            2: (0.9244791666666666, 0.9388020833333334, 0.8860677083333334,
                0.9244791666666666, 0.9173177083333334, 0.9205729166666666),
            4: (0.8785807291666666, 0.8616536458333334, 0.8678385416666666,
                0.8863932291666666, 0.8694661458333334, 0.8828125)}


def _span(figures) -> str:
    return f"{min(figures):.4f}-{max(figures):.4f}"


def _within(x: float, figures, band: float) -> bool:
    """``x`` within ``band`` of the range of the reference's ``figures``."""
    return min(figures) - band <= x <= max(figures) + band


def _example(name: str):
    """``examples/<name>.py`` of this checkout as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_train(torch, dev, rs, cc, card) -> dict:
    """(a) The NVSA/PrAE frontend trained by
    ``examples/torch_raven_abduction.py::get_frontend`` at NVSAConfig()'s
    widths, then served: PrAE, the NVSA image path through the engine and
    the bipolar fused variant (one masked launch a sweep).  (b) MIMONet
    trained by ``examples/torch_mimonet_superposition.py::train_eval`` at
    S = 1, 2, 4 (impl="fft"), then served through circconv_rows
    (impl="pallas").  Every accuracy is held against the reference's CPU
    figure above."""
    import dataclasses

    import numpy as np

    from repro_torch import engine
    from repro_torch.core import factorizer as fz
    from repro_torch.core import vsa
    from repro_torch.data import raven
    from repro_torch.models import cnn, mimonet as mm, nvsa, prae

    t_phase = time.perf_counter()

    def since() -> str:
        return f"[{time.perf_counter() - t_phase:.1f} s into phase 25]"

    out = {}
    # (a) the frontend, trained afresh
    ra = _example("torch_raven_abduction")
    cfg = nvsa.NVSAConfig()
    cbs, _ = nvsa.make_codebooks(0, cfg, device=dev)
    TRAIN_PATH.unlink(missing_ok=True)
    rep: dict = {}
    model = ra.get_frontend(cfg, cbs, TRAIN_STEPS, device=dev,
                            path=str(TRAIN_PATH), report=rep)
    loaded = ra.get_frontend(cfg, cbs, TRAIN_STEPS, device=dev,
                             path=str(TRAIN_PATH))
    for (name, p), (_, q) in zip(model.named_parameters(),
                                 loaded.named_parameters()):
        if p.requires_grad or q.requires_grad or not torch.equal(p, q):
            raise AssertionError(f"frontend {name}: the saved model does not "
                                 "load back frozen and equal")
    hist = rep["history"]
    if not all(np.isfinite(m["loss"]) for _, m in hist) or \
            hist[-1][1]["cosine"] <= hist[0][1]["cosine"]:
        raise AssertionError(f"frontend training did not converge: {hist}")
    out["frontend"] = {"steps_per_s": rep["steps_per_s"],
                       "wall_s": rep["wall_s"], "data_s": rep["data_s"],
                       "history": hist}
    print(f"phase 25a: NVSA/PrAE frontend trained on {card}: "
          f"{cnn.num_params(model):,} fp32 parameters (CNN), D = "
          f"{cfg.vsa.dim}, {TRAIN_STEPS} AdamW steps of "
          f"{ra.BATCH} panels (cosine schedule 3e-3, warmup 100, clip 1.0); "
          + ", ".join(f"step {s}: loss {m['loss']:.4f} cos {m['cosine']:.4f}"
                      for s, m in hist)
          + f"; {rep['steps_per_s']:.1f} steps/s, wall {rep['wall_s']:.2f} s "
          f"= host data {rep['data_s']:.2f} s (render + copy) + steps "
          f"{rep['step_s']:.2f} s; saved and loaded back equal "
          + since(), flush=True)

    test = raven.RavenDataset(raven.RavenConfig(batch_size=32, seed=123)) \
        .next_batch()
    b = _nvsa_tasks(render=True)
    with torch.no_grad():
        prae_test = float(prae.accuracy(model, test, cfg.cnn))
        prae_256 = float(prae.accuracy(model, b, cfg.cnn))
    out["prae"] = {"test_batch": prae_test, "tasks": prae_256}
    print(f"phase 25a: PrAE on the trained frontend: accuracy {prae_test:.4f}"
          f" on the reference test's batch (32 tasks, seed 123; the "
          f"reference's frontends on the CPU: {_span(REF_PRAE_TEST)}), "
          f"{prae_256:.4f} on {NVSA_TASKS} tasks (reference "
          f"{_span(REF_PRAE_256)}); limit >= {PRAE_MIN}", flush=True)
    if min(prae_test, prae_256) < PRAE_MIN:
        raise AssertionError(f"PrAE accuracy {prae_test} / {prae_256} below "
                             f"{PRAE_MIN}")

    # The NVSA image path through registry.build and Engine(slots=256)
    truth = b["answer"]
    imgs = torch.from_numpy(b["images"][:, :8].copy()).to(dev)
    cimgs = torch.from_numpy(b["candidate_images"].copy()).to(dev)
    keys = fz.draw_keys(9, 8 * NVSA_TASKS)

    def serve_image(c, fused):
        spec = engine.registry.build("nvsa_abduction", 0, cfg=c,
                                     fused_step=fused, device=dev)
        sync(torch, dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            ctx, cand = (nvsa.perceive(model, x, c, spec.codebooks)
                         for x in (imgs, cimgs))
        sync(torch, dev)
        t_perceive = time.perf_counter() - t0
        _serve_nvsa(torch, engine, spec, ctx[:4], cand[:4], keys, dev)  # warm
        return spec, ctx, cand, t_perceive

    spec, ctx, cand, t_p = serve_image(cfg, False)
    reqs, eng, wall = _serve_nvsa(torch, engine, spec, ctx, cand, keys, dev)
    acc = float((np.array([r.result["answer"] for r in reqs]) == truth).mean())
    iters = np.stack([r.iterations for r in reqs])
    conv = float(np.stack([r.factorization.converged for r in reqs]).mean())
    out["nvsa_image"] = {"accuracy": acc, "wall_ms": wall * 1e3,
                         "answers_per_s": NVSA_TASKS / wall,
                         "perceive_ms": t_p * 1e3, "converged": conv,
                         "mean_iterations": float(iters.mean()),
                         "sweeps": eng.sweeps_total}
    print(f"phase 25a: NVSA image path on the trained frontend "
          f"(NVSAConfig(), unitary stochastic): {2 * 8 * NVSA_TASKS} panels "
          f"perceived on the card in {t_p * 1e3:.2f} ms, {NVSA_TASKS} tasks "
          f"as requests through Engine(slots={ENGINE_ROWS}): accuracy "
          f"{acc:.4f} (the reference's CPU runs {_span(REF_NVSA_IMAGE)}, "
          f"band {NVSA_IMAGE_BAND}), converged {conv:.4f}, mean iterations "
          f"{float(iters.mean()):.3f}, sweeps_total={eng.sweeps_total}; wall "
          f"{wall * 1e3:.2f} ms, {NVSA_TASKS / wall:.1f} RPM answers/s "
          + since(), flush=True)
    if not _within(acc, REF_NVSA_IMAGE, NVSA_IMAGE_BAND):
        raise AssertionError(f"NVSA image-path accuracy {acc} is not within "
                             f"{NVSA_IMAGE_BAND} of the reference's "
                             f"{_span(REF_NVSA_IMAGE)}")

    # The bipolar fused variant on the same frontend: its queries bind the
    # trained attribute beliefs over the bipolar books
    cfg_b = nvsa.NVSAConfig(vsa=vsa.VSAConfig(NVSA_D, NVSA_D))
    cfg_b = dataclasses.replace(cfg_b, factorizer=dataclasses.replace(
        cfg_b.factorizer, noise_std=0.0, restart_every=0, synchronous=True))
    spec_b, ctx_b, cand_b, _ = serve_image(cfg_b, True)
    rs.masked_launches = 0  # the trained bipolar run starts here
    reqs_b, eng_b, wall_b = _serve_nvsa(torch, engine, spec_b, ctx_b, cand_b,
                                        keys, dev)
    launches = rs.masked_launches  # ... and ends here
    if launches != eng_b.sweeps_total or launches == 0:
        raise AssertionError(f"trained bipolar NVSA: masked launches "
                             f"{launches} != sweeps_total "
                             f"{eng_b.sweeps_total}")
    acc_b = float((np.array([r.result["answer"] for r in reqs_b]) == truth)
                  .mean())
    conv_b = float(np.stack([r.factorization.converged for r in reqs_b])
                   .mean())
    out["bipolar"] = {"accuracy": acc_b, "wall_ms": wall_b * 1e3,
                      "answers_per_s": NVSA_TASKS / wall_b,
                      "sweeps": eng_b.sweeps_total, "launches": launches,
                      "converged": conv_b}
    print(f"phase 25a: bipolar fused NVSA (D={NVSA_D}, lanes 1, Jacobi, "
          f"noise 0) on the trained frontend: {NVSA_TASKS} requests, "
          f"accuracy {acc_b:.4f}, converged {conv_b:.4f}; sweeps_total="
          f"{eng_b.sweeps_total} masked kernel launches={launches}; wall "
          f"{wall_b * 1e3:.2f} ms, {NVSA_TASKS / wall_b:.1f} RPM answers/s "
          + since(), flush=True)

    # (b) MIMONet trained at S = 1, 2, 4 (impl="fft"), served through the
    # kernel (impl="pallas")
    mx = _example("torch_mimonet_superposition")
    out["mimonet"], out["mimonet_launches"] = {}, 0
    for S in MIMO_TRAIN_STREAMS:
        rep = {}
        acc_f, tp_f = mx.train_eval(S, steps=MIMO_TRAIN_STEPS, device=dev,
                                    report=rep)
        net, fft, held = rep["model"], rep["cfg"], rep["test"]
        pal = dataclasses.replace(fft, vsa=dataclasses.replace(
            fft.vsa, impl="pallas"))
        cc.rows_launches = cc.single_launches = 0  # the trained run ...
        acc_p = mx.accuracy(net, held, pal)
        tp_p = mx.panels_per_s(net, held["images"], pal)
        rows, single = cc.rows_launches, cc.single_launches  # ... ends here
        batches = 7  # accuracy's one, panels_per_s' warm-up and 5 timed
        if (rows, single) != (2 * batches, 0):
            raise AssertionError(f"trained MIMONet S={S}: (rows, single) "
                                 f"launches {(rows, single)}, expected "
                                 f"({2 * batches}, 0)")
        out["mimonet_launches"] += rows
        with torch.no_grad():
            want = mm.apply(net, held["images"], fft)
            # Trained logits are far larger than phase 20's (of order
            # MIMO_LOGIT_SCALE), and an fp32 bind's rounding grows with them:
            # phase 20's tolerances, scaled by the logits' magnitude.
            scale = max(1.0, max(w.abs().max().item() for w in want)
                        / MIMO_LOGIT_SCALE)
            _logits_agree(torch, mm.apply(net, held["images"], pal), want,
                          f"trained S={S}", scale)
            ties, dloss, dlogit = _losses_agree(torch, mm, net, held, pal,
                                                fft, scale)
        cc.rows_launches = rows  # the comparison's launches are not counted
        out["mimonet"][S] = {"accuracy": acc_f, "accuracy_pallas": acc_p,
                             "panels_per_s": tp_f,
                             "panels_per_s_pallas": tp_p,
                             "train_s": rep["wall_s"],
                             "data_s": rep["data_s"],
                             "steps_per_s": rep["steps_per_s"],
                             "final_loss": rep["final_loss"],
                             "launches": rows, "near_ties": ties,
                             "max_logit": scale * MIMO_LOGIT_SCALE,
                             "max_logit_diff": dlogit, "loss_diff": dloss}
        print(f"phase 25b: MIMONet S={S} trained on {card}: "
              f"{sum(p.numel() for p in net.parameters()):,} fp32 "
              f"parameters, {MIMO_TRAIN_STEPS} AdamW steps of 64 items "
              f"(impl='fft') in {rep['wall_s']:.2f} s ({rep['steps_per_s']:.1f}"
              f" steps/s; host data {rep['data_s']:.2f} s), final loss "
              f"{rep['final_loss']:.4f}; held-out attribute accuracy "
              f"{acc_f:.4f} under impl='fft' (the reference's CPU runs "
              f"{_span(REF_MIMO[S])}, band {MIMO_ACC_BAND}), {acc_p:.4f} under "
              f"impl='pallas' ({ties} near ties); panels/s {tp_f:.1f} (fft), "
              f"{tp_p:.1f} (pallas); circconv_rows launches {rows} "
              f"(2 a batch), single {single}; logits (max |logit| "
              f"{scale * MIMO_LOGIT_SCALE:.4g}) within atol "
              f"{scale * MIMO_ATOL:.3g} ({MIMO_ATOL} x max |logit| / "
              f"{MIMO_LOGIT_SCALE}), rtol {MIMO_RTOL} of the fft run (max "
              f"|diff| {dlogit:.3g}), the loss {dloss:.3g} apart "
              + since(), flush=True)
        if not _within(acc_f, REF_MIMO[S], MIMO_ACC_BAND):
            raise AssertionError(f"MIMONet S={S}: accuracy {acc_f} is not "
                                 f"within {MIMO_ACC_BAND} of the "
                                 f"reference's {_span(REF_MIMO[S])}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 25: done in {out['phase_s']:.1f} s", flush=True)
    return out


# The rest of the LM stack (phases 26-30): Granite-MoE 3B served paged at
# full size, starcoder2-3b (rep 12) through LMEngine, every other
# architecture at full width (depth cut where one card cannot hold it), and
# all ten against the CPU at smoke shapes.
GRANITE, STARCODER = "granite-moe-3b-a800m", "starcoder2-3b"
GRANITE_PARAMS = 3_374_295_552
STARCODER_REQUESTS = 16
STARCODER_INT8_REQUESTS = 8
# A MoE router choice within this many bf16 ulps (the K-th largest router
# logit over the next) may flip between two runs whose bf16 logits differ
# by an ulp; a pair past DEV_ULPS is excused only at such a step.
ROUTER_TIE_ULPS = 1
ARCH_BATCH, ARCH_SEQ = 4, 512  # forward + loss_fn
ARCH_DECODE, ARCH_PROMPT = 16, 16  # greedy decode steps; prompt tokens
# Full width at a cut depth where one card cannot hold the model (bf16):
# qwen2.5-32b 4 of 64 layers, qwen2-vl-72b 2 of 80, dbrx-132b 2 of 40, and
# jamba one period of 8 of 72 layers with 4 of 16 experts (top-2 kept; one
# full period is 88.6 GB).  minicpm-2b, whisper-small, xlstm-125m whole.
ARCH_CUTS = {"qwen2.5-32b": {"n_layers": 4}, "qwen2-vl-72b": {"n_layers": 2},
             "dbrx-132b": {"n_layers": 2},
             "jamba-1.5-large-398b": {"n_layers": 8, "experts": 4},
             "minicpm-2b": {}, "whisper-small": {}, "xlstm-125m": {}}
CPU_DECODE = 8  # phase 29: decode steps, card against the CPU
# fp32, card against the CPU, of each row's largest |logit|: the forward and
# the loss at the CPU parity tests' 1e-5; decode steps at 2e-5, since the
# recurrent state carries each step's rounding on (first reading: jamba's
# Mamba hybrid, 1.05e-5 at step 7 of 8).
CPU_FP32_RTOL, CPU_FP32_DECODE_RTOL = 1e-5, 2e-5


class MoETap:
    """Wraps ``repro_torch.nn.moe.moe`` (the blocks look it up at call
    time): keeps each call's dropped share on the device, by prefill
    (S > 1) and decode (S = 1); while ``margins`` is a list, the smallest
    top-K router margin of each call in bf16 ulps of the K-th logit; while
    ``routes`` is a list, each call's routing as the layer computed it:
    the chosen experts [B, S, K] and whether each choice kept its slot."""

    def __init__(self, torch):
        from repro_torch.nn import moe as Moe

        self.torch, self.mod, self.orig = torch, Moe, Moe.moe
        self.dropped = {"prefill": [], "decode": []}
        self.margins = self.routes = None
        Moe.moe = self

    def __call__(self, p, x, cfg):
        torch, Moe = self.torch, self.mod
        y, aux = self.orig(p, x, cfg)
        self.dropped["decode" if x.shape[1] == 1 else "prefill"].append(
            aux["dropped_frac"].detach())
        if self.margins is None and self.routes is None:
            return y, aux
        K, E = cfg.top_k, cfg.num_experts
        logits = (x @ p["router"].to(x.dtype)).float()
        if self.margins is not None:
            top = torch.topk(logits, K + 1, dim=-1).values
            kth = top[..., K - 1]
            ulp = torch.exp2(torch.floor(torch.log2(
                kth.abs().clamp_min(1e-30))) - 7)
            self.margins.append(((kth - top[..., K]) / ulp).min())
        if self.routes is not None:  # the layer's own routing, recomputed
            B, S = x.shape[:2]
            top_p, top_e = Moe.top_k(Moe.softmax(logits), K)
            top_p = top_p / (top_p.sum(-1, keepdim=True) + 1e-9)
            fold = B if (S == 1 and B > 1) else 1
            cap = int(max(1, round(S * fold * K * cfg.capacity_factor / E)))
            keep, order = Moe._route_local(x, top_e, top_p, E=E, K=K,
                                           cap=cap, fold=fold)[3:]
            kept = torch.empty_like(keep).scatter_(1, order, keep)
            self.routes.append((top_e, kept.reshape(B, S, K)))
        return y, aux

    @staticmethod
    def changed_rows(a: list, b: list):
        """[B] bool: rows whose routing (experts or kept slots) differs in
        any call between two runs' ``routes``."""
        out = None
        for (ea, ka), (eb, kb) in zip(a, b):
            d = ((ea != eb) | (ka != kb)).flatten(1).any(1)
            out = d if out is None else out | d
        return out

    def reset(self):
        self.dropped = {"prefill": [], "decode": []}

    def share(self, kind) -> float:
        d = self.dropped[kind]
        return float(self.torch.stack(d).mean()) if d else float("nan")

    def close(self):
        self.mod.moe = self.orig


def phase_granite(torch, dev, fd, card) -> dict:
    """Granite-MoE 3B at full size (32 layers, d 1536, 24/8 heads of 64, 40
    experts top-8 of width 512, vocab 49155; random bf16 weights drawn on
    the card) through LMEngine(slots=32, paged bs 16, chunk 64): Llama's 64
    requests, every one complete, no non-finite logit, flash_decode
    launches = 32 x decode steps; the dropped shares; the breakdown; the
    greedy contract on 8 prompts with the router-tie excuse."""
    from repro_torch.configs import registry
    from repro_torch.nn import transformer as T

    cfg = registry.get(GRANITE).full()
    t0 = time.perf_counter()
    model = T.init(cfg, 0, dev)
    torch.cuda.synchronize()
    n_params = T.param_count(model)
    if n_params != GRANITE_PARAMS:
        raise AssertionError(f"phase 26: {n_params:,} parameters, not "
                             f"{GRANITE_PARAMS:,}")
    print(f"phase 26: {cfg.name}: {n_params:,} parameters ({cfg.n_layers} "
          f"layers, d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, {cfg.moe.num_experts} experts top-"
          f"{cfg.moe.top_k} of width {cfg.moe.d_ff}), random bf16 weights "
          f"drawn on the card in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 1e9:.2f} GB)", flush=True)
    tap = MoETap(torch)
    try:
        prompts = lm_prompts(LM_REQUESTS, cfg.vocab, seed=41)
        serve_lm(torch, dev, cfg, model, prompts[:2], fd, "granite warm-up")
        tap.reset()
        run = serve_lm(torch, dev, cfg, model, prompts, fd, "granite run")
        drop = {k: tap.share(k) for k in ("prefill", "decode")}
        snap, spent, wall = run["snap"], run["spent"], run["wall"]
        steps = run["dispatches"]
        host_ms = spent["decode-burst"] / steps * 1e3
        out = {"launches": run["launches"], "steps": steps, "wall": wall,
               "tokens_per_s": LM_REQUESTS * LM_NEW / wall,
               "p50": snap["latency_p50_ms"], "p99": snap["latency_p99_ms"],
               "dropped": drop, "host_ms": host_ms}
        print(f"phase 26: {LM_REQUESTS} greedy requests (prompts "
              f"{LM_PROMPTS[0]}-{LM_PROMPTS[1]} tokens, {LM_NEW} new each) "
              f"through LMEngine(slots={LM_SLOTS}, paged bs={LM_BLOCK}, "
              f"chunk={LM_CHUNK}, max_len={LM_MAX_LEN}) on {card}: all "
              f"{LM_NEW} tokens, none truncated, no non-finite logit; wall "
              f"{wall * 1e3:.1f} ms, {out['tokens_per_s']:.1f} generated "
              f"tokens/s, p50 {out['p50']:.1f} ms, p99 {out['p99']:.1f} ms; "
              f"prefill (fill) {spent['fill'] * 1e3:.1f} ms in "
              f"{run['engine'].serve.prefill_dispatches} chunks, decode "
              f"{spent['decode-burst'] * 1e3:.1f} ms in {steps} steps, host "
              f"wall per decode step {host_ms:.3f} ms; dropped share of "
              f"(token, expert) assignments {drop['prefill']:.4f} at prefill "
              f"(chunk padding included), {drop['decode']:.4f} at decode "
              f"(idle slots included); flash_decode launches "
              f"{run['launches']} = {cfg.n_layers} x {steps}", flush=True)
        del run
        lens = [min(len(p) + LM_NEW // 2, LM_MAX_LEN - 1)
                for p in prompts[:LM_SLOTS]]
        out["breakdown"] = lm_breakdown(torch, dev, cfg, model, lens, fd,
                                        card, phase=26)
        out["lens"] = lens
        _, _, excused = greedy_contract(torch, dev, cfg, model, prompts[:8],
                                        "bf16", 26, tap=tap)
        out["excused"] = excused
    finally:
        tap.close()
    del model
    torch.cuda.empty_cache()
    return out


def phase_starcoder(torch, dev, fd, card) -> dict:
    """starcoder2-3b at full size (30 layers, d 3072, 24 query heads over 2
    KV heads of 128: rep 12, the tensor-core kernel) through LMEngine: 16
    requests, complete, no non-finite logit, flash_decode launches = 30 x
    decode steps; then 8 with the int8 KV pool, the same checks."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.nn import transformer as T

    cfg = registry.get(STARCODER).full()
    model = T.init(cfg, 0, dev)
    prompts = lm_prompts(STARCODER_REQUESTS, cfg.vocab, seed=43)
    run = serve_lm(torch, dev, cfg, model, prompts, fd, "starcoder2 run")
    # the timing shape (phase 30): 32 slots at mid-decode lengths of prompts
    # drawn as the run's are
    out = {"launches": run["launches"], "steps": run["dispatches"],
           "wall": run["wall"],
           "tokens_per_s": STARCODER_REQUESTS * LM_NEW / run["wall"],
           "lens": [min(len(p) + LM_NEW // 2, LM_MAX_LEN - 1)
                    for p in lm_prompts(LM_SLOTS, cfg.vocab, seed=43)]}
    print(f"phase 27: {cfg.name}: {T.param_count(model):,} parameters, rep "
          f"{cfg.n_heads // cfg.n_kv_heads} (G {cfg.n_kv_heads}, dh "
          f"{cfg.head_dim}); {STARCODER_REQUESTS} greedy requests through "
          f"LMEngine(slots={LM_SLOTS}, paged bs={LM_BLOCK}, chunk="
          f"{LM_CHUNK}) on {card}: all {LM_NEW} tokens, no non-finite logit; "
          f"wall {run['wall'] * 1e3:.1f} ms, {out['tokens_per_s']:.1f} "
          f"generated tokens/s; flash_decode launches {run['launches']} = "
          f"{cfg.n_layers} x {run['dispatches']}", flush=True)
    del run
    run8 = serve_lm(torch, dev, dataclasses.replace(cfg, kv_cache_dtype="int8"),
                    model, prompts[:STARCODER_INT8_REQUESTS], fd,
                    "starcoder2 int8 run")
    out["int8_launches"] = run8["launches"]
    print(f"phase 27: {cfg.name}, int8 KV pool: {STARCODER_INT8_REQUESTS} "
          f"greedy requests on {card}: all {LM_NEW} tokens, no non-finite "
          f"logit; wall {run8['wall'] * 1e3:.1f} ms; flash_decode launches "
          f"{run8['launches']} = {cfg.n_layers} x {run8['dispatches']}",
          flush=True)
    del run8, model
    torch.cuda.empty_cache()
    return out


def cut_config(cfg, cut: dict):
    """A full config at a cut depth (and, for jamba, fewer experts)."""
    import dataclasses

    kw = {}
    if "n_layers" in cut:
        kw["n_layers"] = cut["n_layers"]
    if "experts" in cut:
        kw["moe"] = dataclasses.replace(cfg.moe, num_experts=cut["experts"])
    return dataclasses.replace(cfg, **kw) if kw else cfg


def arch_inputs(torch, cfg, B, S, dev, seed=0) -> dict:
    """A batch for ``forward``/``loss_fn``: tokens, and (qwen2-vl) a 16 x 16
    grid of vision patches with M-RoPE positions (t 0, h row, w column;
    text after at 16 + j on all three streams), (whisper) encoder frames."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g,
                                 device=dev)}
    if cfg.mrope_sections is not None:
        P = cfg.vision_patches
        side = int(round(P ** 0.5))
        i = torch.arange(P, device=dev)
        j = torch.arange(S - P, device=dev) + side
        pos = torch.stack([torch.cat([torch.zeros_like(i), j]),
                           torch.cat([i // side, j]),
                           torch.cat([i % side, j])])
        b["positions"] = pos[None].expand(B, 3, S).contiguous()
        b["vision_embeds"] = torch.randn((B, P, cfg.d_model), generator=g,
                                         device=dev).to(torch.bfloat16)
    if cfg.encoder is not None:
        e = cfg.encoder
        b["encoder_frames"] = torch.randn((B, e.n_frames, e.d_model),
                                          generator=g, device=dev
                                          ).to(torch.bfloat16)
    return b


def _decode_direct(torch, dev, cfg, model, batch, steps):
    """``decode_step`` from a fresh cache, greedy (the reference serves
    neither M-RoPE nor encoder-decoder stacks through ServeEngine)."""
    from repro_torch.nn import transformer as T

    B = batch["tokens"].shape[0]
    cache = T.init_cache(cfg, B, steps + 1, device=dev)
    enc = (T._encoder_forward(model, cfg, batch["encoder_frames"])
           if cfg.encoder is not None else None)
    tok = batch["tokens"][:, :1]
    bad = 0
    for t in range(steps):
        pos = (torch.full((B, 3, 1), t, dtype=torch.long, device=dev)
               if cfg.mrope_sections is not None else None)
        logits, cache = T.decode_step(model, cfg, cache, tok, positions=pos,
                                      enc_out=enc)
        bad += int((~torch.isfinite(logits)).sum())
        tok = logits[:, -1].argmax(-1, keepdim=True)
    return bad


def _decode_served(torch, dev, cfg, model, prompts, steps):
    """The contiguous ServeEngine, one slot a prompt, ``steps`` greedy
    steps; non-finite logits of the active rows counted."""
    from repro_torch.launch.serve import ServeEngine

    eng = ServeEngine(cfg, model, len(prompts), ARCH_PROMPT + steps + 1,
                      device=dev)
    for s, p in enumerate(prompts):
        eng.add_request(s, p)
    bad = 0
    for _ in range(steps):
        eng.step()
        act = torch.from_numpy(eng.active.copy()).to(dev)
        bad += int(((~torch.isfinite(eng.last_logits)) & act[:, None]).sum())
    if any(len(g) != steps + 1 for g in eng.generated):
        raise AssertionError(f"{cfg.name}: a slot stopped early")
    return bad


def phase_arch_full(torch, dev, card) -> dict:
    """Every other architecture at full width (ARCH_CUTS): forward +
    loss_fn on 4 x 512 tokens (finite logits and loss; tokens/s, peak
    memory) and 16 greedy decode steps (the contiguous ServeEngine where
    the reference serves the model, decode_step otherwise)."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.nn import transformer as T

    out = {}
    for arch, cut in ARCH_CUTS.items():
        cfg = cut_config(registry.get(arch).full(), cut)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = T.init(cfg, 0, dev)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        weights_gb = torch.cuda.memory_allocated() / 1e9
        batch = arch_inputs(torch, cfg, ARCH_BATCH, ARCH_SEQ, dev)
        T.loss_fn(model, cfg, batch)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, aux = T.forward(model, cfg, batch["tokens"],
                                positions=batch.get("positions"),
                                vision_embeds=batch.get("vision_embeds"),
                                encoder_frames=batch.get("encoder_frames"))
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        finite = bool(torch.isfinite(logits).all())
        del logits
        loss, metrics = T.loss_fn(model, cfg, batch)
        if not finite or not bool(torch.isfinite(loss)):
            raise AssertionError(f"phase 28: {arch}: non-finite logits or "
                                 "loss")
        peak = torch.cuda.max_memory_allocated() / 1e9
        t0 = time.perf_counter()
        served = cfg.encoder is None and cfg.mrope_sections is None
        if served:
            rng = np.random.default_rng(47)
            prompts = [rng.integers(0, cfg.vocab, ARCH_PROMPT)
                       for _ in range(ARCH_BATCH)]
            bad = _decode_served(torch, dev, cfg, model, prompts,
                                 ARCH_DECODE)
        else:
            bad = _decode_direct(torch, dev, cfg, model, batch, ARCH_DECODE)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        if bad:
            raise AssertionError(f"phase 28: {arch}: {bad} non-finite "
                                 "decode logits")
        out[arch] = {"params": T.param_count(model), "layers": cfg.n_layers,
                     "forward_tokens_per_s": ARCH_BATCH * ARCH_SEQ / t_fwd,
                     "loss": float(loss), "peak_gb": peak,
                     "decode_tokens_per_s": ARCH_BATCH * ARCH_DECODE / t_dec}
        moe = ""
        if cfg.moe is not None:
            moe = f", dropped share {float(metrics['dropped_frac']):.4f}"
        print(f"phase 28: {arch} at full width ({cfg.n_layers} layers"
              f"{', cut' if cut else ', whole'}; {out[arch]['params']:,} "
              f"parameters, {weights_gb:.2f} GB, drawn in {t_init:.1f} s) on "
              f"{card}: forward + loss_fn on {ARCH_BATCH} x {ARCH_SEQ} "
              f"tokens finite, loss {float(loss):.4f}{moe}; forward "
              f"{t_fwd * 1e3:.1f} ms, {out[arch]['forward_tokens_per_s']:.1f}"
              f" tokens/s; peak memory {peak:.2f} GB; {ARCH_DECODE} greedy "
              f"decode steps of {ARCH_BATCH} rows "
              f"({'ServeEngine, contiguous' if served else 'decode_step'}) "
              f"finite: {out[arch]['decode_tokens_per_s']:.1f} tokens/s "
              f"({t_dec * 1e3:.1f} ms with prefill)", flush=True)
        del model, batch, loss, metrics
        torch.cuda.empty_cache()
    return out


def _arch_run(torch, cfg, model, batch, tap, dev):
    """Forward logits, loss and CPU_DECODE decode steps fed the batch's
    tokens, each with its MoE calls' routing (``MoETap.routes``)."""
    from repro_torch.nn import transformer as T

    def call(fn):
        tap.routes = []
        out = fn()
        routes, tap.routes = tap.routes, None
        return out, [(e.cpu(), k.cpu()) for e, k in routes]

    (logits, _), routes_f = call(lambda: T.forward(
        model, cfg, batch["tokens"], positions=batch.get("positions"),
        vision_embeds=batch.get("vision_embeds"),
        encoder_frames=batch.get("encoder_frames")))
    loss, _ = T.loss_fn(model, cfg, batch)
    B = batch["tokens"].shape[0]
    cache = T.init_cache(cfg, B, CPU_DECODE + 1, device=dev)
    enc = (T._encoder_forward(model, cfg, batch["encoder_frames"])
           if cfg.encoder is not None else None)
    steps = []
    for t in range(CPU_DECODE):
        pos = (torch.full((B, 3, 1), t, dtype=torch.long, device=dev)
               if cfg.mrope_sections is not None else None)
        (lg, cache), routes = call(lambda: T.decode_step(
            model, cfg, cache, batch["tokens"][:, t:t + 1], positions=pos,
            enc_out=enc))
        steps.append((lg[:, 0].cpu(), routes))
    return (logits.cpu(), routes_f), float(loss), steps


def phase_arch_card_cpu(torch, dev, card) -> dict:
    """All ten architectures at smoke shapes, the same weights on the card
    and on the CPU: forward logits, loss and CPU_DECODE decode steps, at
    fp32 (CPU_FP32_RTOL of each row's largest |logit|; decode steps
    CPU_FP32_DECODE_RTOL) and bf16 (DEV_ULPS bf16 ulps of it).  A row whose
    MoE routing (an expert chosen, a slot kept) differs between the two
    runs, at that step or an earlier one, is excused and named."""
    import dataclasses

    from repro_torch.configs.registry import ARCHS
    from repro_torch.nn import transformer as T

    cpu = torch.device("cpu")
    tap = MoETap(torch)
    out = {"worst_fp32": 0.0, "worst_fp32_decode": 0.0,
           "worst_bf16_ulps": 0.0, "excused": []}
    try:
        for arch in sorted(ARCHS):
            for dtype in ("fp32", "bf16"):
                cfg = ARCHS[arch].smoke()
                if dtype == "fp32":
                    cfg = dataclasses.replace(cfg, activ_dtype=torch.float32)
                model_c = T.init(cfg, torch.Generator().manual_seed(5), cpu)
                model_g = T.init(cfg, torch.Generator().manual_seed(5),
                                 cpu).to(dev)
                batch_c = arch_inputs(torch, cfg, 2, 16, cpu, seed=6)
                batch_g = {k: v.to(dev) for k, v in batch_c.items()}
                (lc, rc), loss_c, steps_c = _arch_run(torch, cfg, model_c,
                                                      batch_c, tap, cpu)
                (lg, rg), loss_g, steps_g = _arch_run(torch, cfg, model_g,
                                                      batch_g, tap, dev)
                pairs = [(lc, lg, rc, rg, "forward", False)] + [
                    (a, b, ra, rb, f"decode step {t}", True)
                    for t, ((a, ra), (b, rb)) in enumerate(zip(steps_c,
                                                               steps_g))]
                tainted = torch.zeros(2, dtype=torch.bool)
                for want, got, ra, rb, what, decode in pairs:
                    changed = (MoETap.changed_rows(ra, rb) if ra
                               else torch.zeros(2, dtype=torch.bool))
                    if decode:  # a row's cache carries a difference on
                        tainted |= changed
                        changed = tainted
                    want = want.reshape(2, -1, cfg.vocab)
                    got = got.reshape(2, -1, cfg.vocab)
                    top = want.abs().amax(-1)
                    if dtype == "fp32":
                        d = ((got - want).abs().amax(-1) / top).amax(-1)
                        limit = (CPU_FP32_DECODE_RTOL if decode
                                 else CPU_FP32_RTOL)
                        key = "worst_fp32_decode" if decode else "worst_fp32"
                    else:
                        ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
                        d = ((got - want).abs().amax(-1) / ulp).amax(-1)
                        limit, key = DEV_ULPS, "worst_bf16_ulps"
                    for b in range(2):
                        if float(d[b]) > limit and changed[b]:
                            out["excused"].append(
                                f"{arch} {dtype} {what} row {b}: "
                                f"{float(d[b]):.3g}")
                            d[b] = 0.0
                    if float(d.max()) > limit:
                        raise AssertionError(
                            f"phase 29: {arch} {dtype} {what}: card and CPU "
                            f"differ by {float(d.max()):.3g} "
                            f"({'of' if dtype == 'fp32' else 'bf16 ulps of'}"
                            f" the row's largest |logit|) > {limit}")
                    out[key] = max(out[key], float(d.max()))
                rtol = CPU_FP32_RTOL if dtype == "fp32" else 1e-2
                if abs(loss_g - loss_c) > rtol * abs(loss_c):
                    raise AssertionError(f"phase 29: {arch} {dtype}: loss "
                                         f"{loss_g} on the card, {loss_c} on "
                                         "the CPU")
                del model_g
    finally:
        tap.close()
    torch.cuda.empty_cache()
    print(f"phase 29: all {len(ARCHS)} architectures at smoke shapes, the "
          f"same weights on {card} and on the CPU: forward logits, loss and "
          f"{CPU_DECODE} decode steps; fp32 forward within "
          f"{out['worst_fp32']:.3g} of each row's largest |logit| (limit "
          f"{CPU_FP32_RTOL}), decode steps within "
          f"{out['worst_fp32_decode']:.3g} (limit {CPU_FP32_DECODE_RTOL}); "
          f"bf16 within {out['worst_bf16_ulps']:.2f} ulps of it (limit "
          f"{DEV_ULPS}) on rows the two runs route alike; rows routed "
          f"otherwise past the limit: {len(out['excused'])} "
          f"[{'; '.join(out['excused'])}]", flush=True)
    return out


# Phase 31: LM training by the reference's recipe (launch/train.py: batch 8
# of 128 tokens from TokenDataset, AdamW at fp32 state, cosine 3e-4 with
# total // 20 warmup steps, clip 1.0, remat "full") at full width, the
# trained Llama served through flash_decode; every architecture's gradients
# and steps at smoke size against the CPU; int8 gradient compression.
LLAMA = "llama3.2-3b"
LLAMA_PARAMS = 3_606_752_256
LLAMA_TRAIN_STEPS, GRANITE_TRAIN_STEPS = 30, 10
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 128
TRAINED_REQUESTS, TRAINED_SLOTS, TRAINED_NEW = 16, 16, 16
TRAINED_PROMPTS = (16, 256)
# The longest prompt, its 16 tokens and an adSCH burst's overshoot.
TRAINED_MAX_LEN = 320
# Card against the CPU at smoke shapes (the CPU parity tests' tolerances,
# PERF.md section 2): fp32 loss 1e-5 relative and every leaf's gradient
# within 2e-5 of its largest |g| (at least 1e-3 of the model's largest);
# bf16 loss 1e-2 relative, leaves 0.06, global norm 1 %; parameters after
# 3 steps within 1e-3 (AdamW) or 0.1 (Adafactor) of how far the model
# moved, in L2 over every leaf, and each leaf whose largest |g| is at
# least 1e-3 of the model's within 1e-2 (AdamW) or 0.1 of its own move.
# Both optimizers divide each entry's step by its own gradient's scale, so
# a leaf whose gradient nearly cancels carries its gradient's larger
# relative rounding into its update (first readings: qwen2-vl's k bias,
# 0.0043 of its move; xLSTM's input-gate bias, whose gradient is rounding
# noise around 0, 2.05, hence the floor);
# Adafactor's first update is g / |g| elementwise, so an entry whose
# gradient cancels to the rounding level moves +-lr either way: a share f
# of such entries moves a leaf by 2 sqrt(f) of its move, and 0.1 allows
# f = 0.25 % (first reading: jamba's embedding, 0.0578).
TRAIN_BATCH_SMOKE, TRAIN_SEQ_SMOKE = 2, 16
GRAD_FP32_RTOL, GRAD_BF16_RTOL, GRAD_FLOOR, GNORM_BF16_RTOL = (
    2e-5, 0.06, 1e-3, 0.01)
STEP_PARAM_RTOL = {"adamw": 1e-3, "adafactor": 0.1}  # the whole model
STEP_LEAF_RTOL = {"adamw": 1e-2, "adafactor": 0.1}
CARD_CPU_STEPS = 3
LSQ_STEPS, LSQ_SHARDS = 400, 8  # tests/test_distributed.py's problem


class TimedBatches:
    """An iterable of batches that sums the host time spent producing them
    (``data_s``): the token stream's numpy draw and the copy to the card."""

    def __init__(self, inner):
        self.inner, self.data_s = inner, 0.0

    def __iter__(self):
        it = iter(self.inner)
        while True:
            t0 = time.perf_counter()
            b = next(it)
            self.data_s += time.perf_counter() - t0
            yield b


def train_full(torch, dev, arch, steps, card, phase, profile=True) -> dict:
    """`steps` steps of launch/train.py's step at full width through the
    loop (no checkpoint files), fp32 masters and AdamW state drawn on the
    card; with `profile`, the last step runs under the profiler (and is
    left out of the steady step time).  Checks every loss and gradient
    norm finite; returns the figures and the trained model (its optimizer
    state freed)."""
    import gc

    from repro_torch.configs import registry
    from repro_torch.data.tokens import TokenConfig, TokenDataset
    from repro_torch.launch import train as TR
    from repro_torch.nn import transformer as T
    from repro_torch.train.loop import LoopConfig, run

    spec = registry.get(arch)
    cfg = spec.full()
    if not cfg.remat or cfg.remat_policy != "full":
        raise AssertionError(f"phase {phase}: {arch}'s full config must "
                             "remat its periods in full")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = T.init(cfg, 0, dev, trainable=True)
    opt, step = TR.build_train_step(model, spec, steps)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    steady_gb = torch.cuda.memory_allocated() / 1e9
    n_params = T.param_count(model)
    data = TimedBatches(TR.TokenBatches(cfg, TokenDataset(TokenConfig(
        cfg.vocab, LM_TRAIN_SEQ, LM_TRAIN_BATCH)), dev))
    step_s, trace = [], {}

    def traced(state, batch):
        """The last step runs under the profiler (its time is left out of
        the steady mean)."""
        if not profile or len(step_s) < steps - 1:
            return step(state, batch)
        res = []
        trace["profile"] = device_profile(
            torch, lambda: res.append(step(state, batch)), reps=1)
        return res[0]

    state = {"params": list(model.parameters()), "opt": opt.state_tree()}
    t0 = time.perf_counter()
    _, history = run(traced, state, data, LoopConfig(total_steps=steps,
                                                     log_every=1),
                     metrics_hook=lambda i, m, dt, slow: step_s.append(dt))
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    metrics = [m for _, m in history]
    bad = [i for i, m in enumerate(metrics) if not all(
        math.isfinite(m[k]) for k in ("loss", "ce", "grad_norm"))]
    if bad or len(metrics) != steps or len(step_s) != steps:
        raise AssertionError(f"phase {phase}: {arch}: non-finite loss or "
                             f"gradient norm at steps {bad}")
    del opt, step, state
    gc.collect()
    torch.cuda.empty_cache()
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    steady = step_s[1:-1] if profile else step_s[1:]
    steady_ms = 1e3 * sum(steady) / max(len(steady), 1)
    out = {"arch": arch, "params": n_params, "steps": steps,
           "init_s": t_init, "wall_s": wall, "steps_per_s": steps / wall,
           "first_step_ms": step_s[0] * 1e3, "step_ms": steady_ms,
           "tokens_per_s": tokens / (steady_ms / 1e3),
           "data_s": data.data_s, "step_s": sum(step_s),
           "steady_gb": steady_gb, "peak_gb": peak_gb, "card_gb": total_gb,
           "ce_first": metrics[0]["ce"], "ce_last": metrics[-1]["ce"],
           "max_grad_norm": max(m["grad_norm"] for m in metrics),
           "profile": trace.get("profile"),
           "dropped": (sum(m["dropped_frac"] for m in metrics) / steps
                       / cfg.n_layers if cfg.moe is not None else None)}
    print(f"phase {phase}: {cfg.name}: {n_params:,} parameters, fp32 masters "
          f"and AdamW moments drawn on {card} in {t_init:.1f} s "
          f"({steady_gb:.2f} GB); {steps} steps of batch {LM_TRAIN_BATCH} x "
          f"{LM_TRAIN_SEQ} (remat full, clip 1.0, cosine 3e-4, warmup "
          f"{max(steps // 20, 1)}): wall {wall:.2f} s, "
          f"{out['steps_per_s']:.3f} steps/s; first step "
          f"{out['first_step_ms']:.1f} ms, then {steady_ms:.1f} ms a step "
          f"(steps 1-{steps - 1 - profile}), "
          f"{out['tokens_per_s']:.0f} tokens/s; host data "
          f"{data.data_s:.2f} s against {out['step_s']:.2f} s of steps; "
          f"peak {peak_gb:.2f} GB of {total_gb:.1f} GB; ce "
          f"{out['ce_first']:.4f} at step 0, {out['ce_last']:.4f} at step "
          f"{steps - 1}; largest grad_norm {out['max_grad_norm']:.4f}"
          + ("" if out["dropped"] is None else
             f"; dropped share of (token, expert) assignments "
             f"{out['dropped']:.4f} a MoE layer, mean over the steps"),
          flush=True)
    if profile:
        print(f"phase {phase}: profiler, step {steps - 1}: "
              f"{out['profile']}", flush=True)
    return out, model


def _smoke_grads(torch, cfg, model, batch, tap):
    """(loss, aux, every leaf's gradient on the CPU, the MoE routes of the
    forward pass)."""
    from repro_torch.nn import transformer as T

    tap.routes = []
    loss, aux = T.loss_fn(model, cfg, batch)
    loss.backward()
    routes, tap.routes = tap.routes, None
    grads = [p.grad.detach().cpu() for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    return (float(loss.detach()), aux, grads,
            [(e.cpu(), k.cpu()) for e, k in routes])


def _leaf_worst(got: list, want: list, names: list) -> tuple:
    """The largest max |got - want| of a leaf over its scale (its largest
    |g|, at least GRAD_FLOOR of the model's largest), and that leaf."""
    top = max(float(w.abs().max()) for w in want)
    worst = (0.0, None)
    for g, w, name in zip(got, want, names):
        scale = max(float(w.abs().max()), GRAD_FLOOR * top)
        d = float((g - w).abs().max()) / scale
        if d >= worst[0]:
            worst = (d, name)
    return worst


def phase_train_card_cpu(torch, dev, card) -> dict:
    """All ten architectures at smoke shapes in the training layout, the
    same fp32 masters and batch on the card and on the CPU: the loss and
    every leaf's gradient of one step at fp32 and bf16, then the parameters
    after CARD_CPU_STEPS steps of the spec's recipe at fp32.  A bf16 MoE
    run whose routing differs between the two is excused and named."""
    import dataclasses

    from repro_torch.configs.registry import ARCHS
    from repro_torch.data.tokens import TokenConfig, TokenDataset
    from repro_torch.launch import train as TR
    from repro_torch.nn import transformer as T

    cpu = torch.device("cpu")
    tap = MoETap(torch)
    out = {"fp32": 0.0, "bf16": 0.0, "gnorm_bf16": 0.0, "params": 0.0,
           "leaf": 0.0, "leaf_name": None, "excused": []}
    try:
        for arch in sorted(ARCHS):
            spec = ARCHS[arch]
            for dtype in (torch.float32, torch.bfloat16):
                cfg = dataclasses.replace(spec.smoke(), activ_dtype=dtype)
                models = {d: T.init(cfg, torch.Generator().manual_seed(5),
                                    cpu, trainable=True).to(d)
                          for d in (cpu, dev)}
                names = [n for n, _ in models[cpu].named_parameters()]
                batch = next(iter(TR.TokenBatches(cfg, TokenDataset(
                    TokenConfig(cfg.vocab, TRAIN_SEQ_SMOKE,
                                TRAIN_BATCH_SMOKE, seed=9)), cpu)))
                runs = {d: _smoke_grads(torch, cfg, m, {
                    k: v.to(d) for k, v in batch.items()}, tap)
                    for d, m in models.items()}
                (lc, _, gc_, rc), (lg, _, gg, rg) = runs[cpu], runs[dev]
                worst = _leaf_worst(gg, gc_, names)
                if dtype == torch.float32:
                    top = max(float(g.abs().max()) for g in gc_)
                    held = [float(g.abs().max()) >= GRAD_FLOOR * top
                            for g in gc_]
                    if abs(lg - lc) > 1e-5 * abs(lc) or \
                            worst[0] > GRAD_FP32_RTOL:
                        raise AssertionError(
                            f"phase 31c: {arch} fp32: loss {lg} on the "
                            f"card, {lc} on the CPU; leaf {worst[1]} "
                            f"differs by {worst[0]:.3g} > {GRAD_FP32_RTOL}")
                    out["fp32"] = max(out["fp32"], worst[0])
                    continue
                if rc and bool(MoETap.changed_rows(rc, rg).any()):
                    out["excused"].append(f"{arch} bf16: {worst[0]:.3g}")
                    continue
                gn = [math.sqrt(sum(float(x.double().square().sum())
                                    for x in g)) for g in (gg, gc_)]
                dn = abs(gn[0] - gn[1]) / gn[1]
                if (abs(lg - lc) > 1e-2 * abs(lc) or worst[0] > GRAD_BF16_RTOL
                        or dn > GNORM_BF16_RTOL or not gn[0] > 0
                        or not all(bool(torch.isfinite(x).all()) for x in gg)):
                    raise AssertionError(
                        f"phase 31c: {arch} bf16: loss {lg} / {lc}, global "
                        f"norm {gn[0]} / {gn[1]}, leaf {worst[1]} differs "
                        f"by {worst[0]:.3g} (card / CPU)")
                out["bf16"] = max(out["bf16"], worst[0])
                out["gnorm_bf16"] = max(out["gnorm_bf16"], dn)
            cfg = dataclasses.replace(spec.smoke(), activ_dtype=torch.float32)
            after = {}
            for d in (cpu, dev):
                model = T.init(cfg, torch.Generator().manual_seed(5), cpu,
                               trainable=True).to(d)
                start = [p.detach().cpu().clone() for p in model.parameters()]
                _, step = TR.build_train_step(model, spec, CARD_CPU_STEPS)
                it = iter(TR.TokenBatches(cfg, TokenDataset(TokenConfig(
                    cfg.vocab, TRAIN_SEQ_SMOKE, TRAIN_BATCH_SMOKE, seed=9)),
                    d))
                for _ in range(CARD_CPU_STEPS):
                    step(None, next(it))
                after[d] = [p.detach().cpu() for p in model.parameters()]
            diff = moved = 0.0
            for name, a, b, s, h in zip(names, after[dev], after[cpu], start,
                                        held):
                leaf, move = float((a - b).norm()), float((b - s).norm())
                diff, moved = diff + leaf ** 2, moved + move ** 2
                if not h:
                    continue
                d = leaf / max(move, 1e-30)
                if d > STEP_LEAF_RTOL[spec.optimizer]:
                    raise AssertionError(
                        f"phase 31c: {arch}: {name} after {CARD_CPU_STEPS} "
                        f"steps differs by {d:.3g} of its move (card / CPU)")
                if d > out["leaf"]:
                    out["leaf"], out["leaf_name"] = d, f"{arch} {name}"
            d = math.sqrt(diff / moved)
            if d > STEP_PARAM_RTOL[spec.optimizer]:
                raise AssertionError(
                    f"phase 31c: {arch}: the parameters after "
                    f"{CARD_CPU_STEPS} steps differ by {d:.3g} of the "
                    "model's move (card / CPU)")
            out["params"] = max(out["params"], d)
    finally:
        tap.close()
    torch.cuda.empty_cache()
    print(f"phase 31c: all {len(ARCHS)} architectures at smoke shapes in the "
          f"training layout, the same fp32 masters and batch on {card} and "
          f"on the CPU: one step's gradients within {out['fp32']:.3g} of each "
          f"leaf's largest |g| at fp32 (limit {GRAD_FP32_RTOL}), "
          f"{out['bf16']:.3g} in bf16 (limit {GRAD_BF16_RTOL}; global norm "
          f"within {out['gnorm_bf16']:.3g}, limit {GNORM_BF16_RTOL}); "
          f"parameters after {CARD_CPU_STEPS} steps of each spec's recipe "
          f"within {out['params']:.3g} of the model's move (limits "
          f"{STEP_PARAM_RTOL}), every leaf with a gradient above the floor "
          f"within {out['leaf']:.3g} of its own ({out['leaf_name']}; limits "
          f"{STEP_LEAF_RTOL}); bf16 runs "
          f"routed "
          f"otherwise: {len(out['excused'])} [{'; '.join(out['excused'])}]",
          flush=True)
    return out


def least_squares(torch, dev, compressed: bool, steps=LSQ_STEPS,
                  shards=LSQ_SHARDS) -> tuple:
    """The reference test's least-squares problem (W* [16, 4], X [64, 16],
    Y = X W*, SGD at 0.05) on `shards` logical data shards on `dev`, the
    shards' gradients averaged exactly or as int8 with error feedback
    through the mesh's data axis.  Returns (final loss, data reductions,
    wire bytes a step)."""
    import numpy as np

    from repro_torch.distributed import compression as C
    from repro_torch.launch.mesh import make_host_mesh

    rng = np.random.default_rng(0)
    wt = torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32))
    X = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    X, Y = X.to(dev), (X @ wt).to(dev)
    mesh = make_host_mesh(shards, 1, device=dev)
    w = torch.zeros((16, 4), device=dev)
    errs = [C.init_error_state({"w": w}) for _ in range(shards)]
    rows = X.shape[0] // shards
    for _ in range(steps):
        grads = []
        for d in range(shards):
            wd = w.clone().requires_grad_(True)
            x, y = X[d * rows:(d + 1) * rows], Y[d * rows:(d + 1) * rows]
            torch.mean((x @ wd - y) ** 2).backward()
            grads.append({"w": wd.grad})
        if compressed:
            qs, ss = [], []
            for d in range(shards):
                q, s_, errs[d] = C.compress_gradients(grads[d], errs[d])
                qs.append(q)
                ss.append(s_)
            gm = C.allreduce_compressed(qs, ss, mesh.axis("data"))[0]["w"]
        else:
            gm = mesh.reduce("data", [[g["w"]] for g in grads])[0][0] / shards
        w = w - 0.05 * gm
    return (float(torch.mean((X @ w - Y) ** 2)), mesh.reductions["data"],
            shards * C.wire_bytes({"w": w}, compressed))


def phase_lm_train(torch, dev, fd, card) -> dict:
    """(a) Llama 3.2 3B trained LLAMA_TRAIN_STEPS steps at full width, its
    ce lowered, then served: the optimizer state freed, the serving copy
    (bf16 matmul weights) through LMEngine(slots=16) with flash_decode
    launches counted, and the greedy contract on 8 prompts; (b) Granite-MoE
    3B, GRANITE_TRAIN_STEPS steps; (c) the ten architectures against the
    CPU; (d) int8 gradient compression on 8 logical data shards."""
    import gc

    from repro_torch.nn import transformer as T

    llama, model = train_full(torch, dev, LLAMA, LLAMA_TRAIN_STEPS, card,
                              "31a")
    if llama["params"] != LLAMA_PARAMS:
        raise AssertionError(f"phase 31a: {llama['params']:,} parameters, "
                             f"not {LLAMA_PARAMS:,}")
    if not llama["ce_last"] < llama["ce_first"]:
        raise AssertionError(f"phase 31a: ce {llama['ce_first']} at step 0, "
                             f"{llama['ce_last']} at the last: not lowered")
    served = T.serving_copy(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    cfg = served.cfg
    if {p.dtype for p in served.parameters()} != {torch.bfloat16,
                                                  torch.float32} or any(
            p.requires_grad for p in served.parameters()):
        raise AssertionError("phase 31a: the serving copy is not the frozen "
                             "bf16 serving layout")
    prompts = lm_prompts(TRAINED_REQUESTS, cfg.vocab, seed=47,
                         lens=TRAINED_PROMPTS)
    kw = dict(slots=TRAINED_SLOTS, new=TRAINED_NEW, max_len=TRAINED_MAX_LEN)
    serve_lm(torch, dev, cfg, served, prompts[:2], fd, "trained warm-up",
             **kw)
    run = serve_lm(torch, dev, cfg, served, prompts, fd, "trained llama",
                   **kw)
    llama.update(launches=run["launches"], serve_wall_s=run["wall"],
                 serve_tokens_per_s=TRAINED_REQUESTS * TRAINED_NEW
                 / run["wall"], decode_steps=run["dispatches"])
    print(f"phase 31a: the trained copy (bf16 serving layout, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card) served "
          f"{TRAINED_REQUESTS} greedy requests (prompts {TRAINED_PROMPTS[0]}-"
          f"{TRAINED_PROMPTS[1]} tokens, {TRAINED_NEW} new) through "
          f"LMEngine(slots={TRAINED_SLOTS}, paged bs={LM_BLOCK}, chunk="
          f"{LM_CHUNK}): all complete, no non-finite logit; wall "
          f"{run['wall'] * 1e3:.1f} ms, {llama['serve_tokens_per_s']:.1f} "
          f"generated tokens/s; flash_decode launches {run['launches']} = "
          f"{cfg.n_layers} x {run['dispatches']}", flush=True)
    del run
    llama["diverged"], llama["d0"], _ = greedy_contract(
        torch, dev, cfg, served, prompts[:8], "bf16", "31a",
        steps=TRAINED_NEW)
    del served
    gc.collect()
    torch.cuda.empty_cache()

    granite, model = train_full(torch, dev, GRANITE, GRANITE_TRAIN_STEPS,
                                card, "31b", profile=False)
    if granite["params"] != GRANITE_PARAMS:
        raise AssertionError(f"phase 31b: {granite['params']:,} parameters")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    card_cpu = phase_train_card_cpu(torch, dev, card)

    t0 = time.perf_counter()
    exact, n_exact, b_exact = least_squares(torch, dev, False)
    int8, n_int8, b_int8 = least_squares(torch, dev, True)
    if not (exact < 1e-2 and int8 < 5e-2):
        raise AssertionError(f"phase 31d: final losses exact {exact}, int8 "
                             f"{int8}: the reference test's bounds are 1e-2 "
                             "and 5e-2")
    print(f"phase 31d: the reference test's least squares on {LSQ_SHARDS} "
          f"logical data shards on {card}, {LSQ_STEPS} SGD steps each: final "
          f"loss {exact:.3g} exact (bound 1e-2), {int8:.3g} int8 with error "
          f"feedback (bound 5e-2); {n_exact} and {n_int8} data-axis "
          f"reductions; {b_exact} and {b_int8} payload bytes a step; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"llama": llama, "granite": granite, "card_cpu": card_cpu,
            "compression": {"exact": exact, "int8": int8,
                            "reductions": [n_exact, n_int8],
                            "bytes": [b_exact, b_int8]},
            "launches": llama["launches"]}


DIST_STAGES, DIST_MICRO, DIST_MB, DIST_SEQ = 4, 8, 2, 512
BOUND_PREFILL_SEQ = 4096


def drawn(torch, cfg, dev, seed=0):
    """The model in the serving layout with random weights drawn by a
    generator on ``dev``: on the card in about a second, where a CPU
    generator takes tens of seconds for Llama 3.2 3B's 3.6e9 normals."""
    from repro_torch.nn import transformer as T

    t0 = time.perf_counter()
    model = T.init(cfg, seed, device=dev)
    sync(torch, dev)
    return model, time.perf_counter() - t0


def training_layout(model):
    """``model`` (serving layout) cast to the training layout on its
    device: every leaf an fp32 trainable master."""
    from repro_torch.nn import transformer as T

    t = model.tree()

    def cast(tree, path=()):
        return T.cast_tree(model.cfg, tree, path, trainable=True)

    return T.LM(model.cfg, cast(t["embed"], ("embed",)),
                [cast(b) for b in t["blocks"]],
                cast(t["final_ln"], ("final_ln",)),
                cast(t["lm_head"], ("lm_head",)), None, trainable=True)


def wall_ms(torch, dev, fn) -> float:
    """One call of ``fn`` on the host's clock, ended by a sync."""
    sync(torch, dev)
    t0 = time.perf_counter()
    fn()
    sync(torch, dev)
    return (time.perf_counter() - t0) * 1e3


def event_ms(torch, fn) -> float:
    """The stream's time between two CUDA events around one call of
    ``fn``: the card's time for it, the gaps where it waits on the host
    included."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def pipeline_full(torch, dev, cfg, model) -> dict:
    """Phase 32a: Llama's blocks as DIST_STAGES stages on a ``pipe`` mesh
    of logical stages on ``dev``, against ``sequential_apply``."""
    from repro_torch.distributed import pipeline as pp
    from repro_torch.launch.mesh import Mesh
    from repro_torch.nn import transformer as T

    per = cfg.n_layers // DIST_STAGES
    stages = [list(range(i * per, (i + 1) * per)) for i in range(DIST_STAGES)]
    positions = torch.arange(DIST_SEQ, device=dev)[None].expand(DIST_MB,
                                                                 DIST_SEQ)

    def layer_fn(layers, x):
        for i in layers:
            x, _ = T._apply_block(model.blocks[i], cfg.kind(i), cfg, x,
                                  positions, None)
        return x

    gen = torch.Generator().manual_seed(32)
    tokens = torch.randint(0, cfg.vocab, (DIST_MICRO, DIST_MB, DIST_SEQ),
                           generator=gen).to(dev)
    mesh = Mesh([dev] * DIST_STAGES, axes=("pipe",))
    with torch.no_grad():
        xs = torch.stack([T._embed(model, cfg, t) for t in tokens])
        pp.sequential_apply(layer_fn, stages, xs[:1])  # warm-up
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out, walls = {}, {"seq": [], "pipe": []}
        runs = {"seq": lambda: pp.sequential_apply(layer_fn, stages, xs),
                "pipe": lambda: pp.pipeline_apply(layer_fn, stages, xs,
                                                  mesh=mesh)}
        for name in ("seq", "pipe", "pipe", "seq"):  # in turns: host noise
            walls[name].append(wall_ms(torch, dev, lambda: out.__setitem__(
                name, runs[name]())))
        seq_ms, pipe_ms = min(walls["seq"]), min(walls["pipe"])
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        logits_p = T._logits(model, cfg, out["pipe"][0])
        logits_s = T._logits(model, cfg, out["seq"][0])
    if not torch.equal(out["pipe"], out["seq"]) or not torch.equal(
            logits_p, logits_s):
        diff = float((out["pipe"].float() - out["seq"].float()).abs().max())
        raise AssertionError(f"phase 32a: the pipeline differs from "
                             f"sequential_apply by {diff}")
    if not bool(torch.isfinite(logits_p).all()):
        raise AssertionError("phase 32a: non-finite logits")
    bubble = pp.bubble_fraction(DIST_STAGES, DIST_MICRO)
    want = 2 * (DIST_MICRO + DIST_STAGES - 2)  # two pipelined runs
    if mesh.transfers["pipe"] != want:
        raise AssertionError(f"phase 32a: {mesh.transfers['pipe']} ppermutes,"
                             f" the schedule has {want}")
    ratio = pipe_ms / seq_ms
    if ratio > (DIST_MICRO + DIST_STAGES - 1) / DIST_MICRO:
        raise AssertionError(f"phase 32a: the pipeline took {ratio:.3f}x the "
                             f"sequential wall, above (M + P - 1) / M")
    print(f"phase 32a: Llama 3.2 3B's {cfg.n_layers} blocks as "
          f"{DIST_STAGES} stages of {per} on a pipe axis of {DIST_STAGES} "
          f"logical stages on one card, {DIST_MICRO} microbatches of "
          f"{DIST_MB} x {DIST_SEQ} tokens: bitwise equal to sequential_apply "
          f"(block outputs and logits); wall {pipe_ms:.2f} ms pipelined, "
          f"{seq_ms:.2f} ms sequential, the lower of two in turns ("
          f"{' / '.join(f'{w:.2f}' for w in walls['pipe'])} and "
          f"{' / '.join(f'{w:.2f}' for w in walls['seq'])}; {ratio:.4f}x; "
          f"bound (M + P - 1) / M "
          f"= {(DIST_MICRO + DIST_STAGES - 1) / DIST_MICRO:.4f}); bubble "
          f"fraction {bubble:.6f} = 3/11; {mesh.transfers['pipe'] // 2} "
          f"ppermutes a run;"
          f" peak {peak_gb:.3f} GB above the weights and inputs", flush=True)
    return {"pipe_ms": pipe_ms, "seq_ms": seq_ms, "ratio": ratio,
            "bubble": bubble, "ppermutes": mesh.transfers["pipe"] // 2,
            "peak_gb": peak_gb}


def roofline_line(torch, what, cost, device_ms, host_ms, how) -> dict:
    from repro_torch.launch import roofline as R

    t = R.roofline_terms(cost.flops, cost.hbm_bytes, 0.0, 1)
    bound_ms = max(t["compute_s"], t["memory_s"]) * 1e3
    ratio = device_ms / bound_ms
    print(f"phase 32b: {what}: {cost.flops:.4g} FLOP, {cost.hbm_bytes:.4g} "
          f"HBM bytes -> bound {bound_ms:.3f} ms ({t['bottleneck']}; compute "
          f"{t['compute_s'] * 1e3:.3f}, memory {t['memory_s'] * 1e3:.3f}); "
          f"device {device_ms:.3f} ms ({how}), host wall {host_ms:.3f} ms; "
          f"device / bound {ratio:.3f}", flush=True)
    if device_ms < bound_ms:
        raise AssertionError(f"phase 32b: {what} took {device_ms:.3f} ms of "
                             f"device time, below its bound {bound_ms:.3f} "
                             "ms: the cost model under-counts")
    return {"flops": cost.flops, "hbm_bytes": cost.hbm_bytes,
            "bound_ms": bound_ms, "bound_by": t["bottleneck"],
            "device_ms": device_ms, "host_ms": host_ms, "ratio": ratio}


def lm_bounds(torch, dev, cfg, model, card) -> tuple:
    """Phase 32b: the roofline bounds of Llama's prefill, decode and train
    steps against the steps on the card.  Returns (figures, the model
    in the training layout; the serving model is dropped)."""
    import gc

    from repro_torch.compat import cost_analysis
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch import costmodel as CM
    from repro_torch.launch import train as TR
    from repro_torch.nn import transformer as T

    n_params = T.count_params_cfg(cfg)[0]
    out = {}
    gen = torch.Generator().manual_seed(33)
    prompt = torch.randint(0, cfg.vocab, (1, BOUND_PREFILL_SEQ),
                           generator=gen).to(dev)
    with torch.no_grad():
        def prefill():
            return T.forward(model, cfg, prompt)[0]

        logits = prefill()
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("phase 32b: non-finite prefill logits")
        del logits
        host = wall_ms(torch, dev, prefill)
        dev_ms = graph_ms(prefill, iters=1, replays=3)
        out["prefill"] = roofline_line(
            torch, f"prefill 1 x {BOUND_PREFILL_SEQ}", CM.step_cost(
                cfg, n_params, "prefill", 1, BOUND_PREFILL_SEQ,
                param_bytes=2), dev_ms, host, "CUDA-graph replay")
        counted = cost_analysis(prefill)["flops"]
        analytic = CM.forward_flops(cfg, 1, BOUND_PREFILL_SEQ)
        out["prefill"].update(counted_flops=counted, analytic_flops=analytic)
        print(f"phase 32b: compat.cost_analysis of that prefill on the card "
              f"counts {counted:.6g} FLOP against costmodel.forward_flops "
              f"{analytic:.6g} ({counted / analytic:.4f}x: flash attention "
              f"computes the causal blocks in full)", flush=True)

        cache = T.init_cache(cfg, LM_SLOTS, LM_MAX_LEN, device=dev)
        for per in cache:
            per["self"]["len"].fill_(LM_MAX_LEN - 64)
        step_tok = torch.randint(0, cfg.vocab, (LM_SLOTS, 1),
                                 generator=gen).to(dev)

        def decode():
            return T.decode_step(model, cfg, cache, step_tok)[0]

        host = wall_ms(torch, dev, decode)
        dev_ms = graph_ms(decode, iters=1, replays=5)
        out["decode"] = roofline_line(
            torch, f"decode step at {LM_SLOTS} slots of {LM_MAX_LEN}",
            CM.step_cost(cfg, n_params, "decode", LM_SLOTS, LM_MAX_LEN,
                         param_bytes=2), dev_ms, host, "CUDA-graph replay")
        del cache
    trainable = training_layout(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, step = TR.build_train_step(trainable, ARCHS[LLAMA], LLAMA_TRAIN_STEPS)
    batch = {"tokens": torch.randint(0, cfg.vocab, (LM_TRAIN_BATCH,
                                                    LM_TRAIN_SEQ),
                                     generator=gen).to(dev)}
    for _ in range(2):  # warm-up: the optimizer's first steps
        step(None, batch)
    host = wall_ms(torch, dev, lambda: step(None, batch))
    dev_ms = min(event_ms(torch, lambda: step(None, batch)) for _ in range(3))
    out["train"] = roofline_line(
        torch, f"train step {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}",
        CM.step_cost(cfg, n_params, "train", LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                     param_bytes=4), dev_ms, host,
        "CUDA events, the best of 3; the card's waits on the host included")
    out["train"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out, trainable


def kernel_launches(rs, sim, fd, cc) -> tuple:
    """Every kernel wrapper's launch count in this process."""
    return (rs.launches, rs.masked_launches, rs.local_launches, sim.launches,
            fd.launches, cc.rows_launches, cc.single_launches)


def phase_dist(torch, dev, card) -> dict:
    """Phase 32: the pipeline at Llama 3.2 3B's full width, and the LM
    steps' roofline bounds against the card."""
    import gc

    from repro_torch.configs.registry import ARCHS

    cfg = ARCHS[LLAMA].full()
    t0 = time.perf_counter()
    model, drawn_s = drawn(torch, cfg, dev)
    print(f"phase 32: Llama 3.2 3B's random bf16 weights drawn on {card} in "
          f"{drawn_s:.1f} s", flush=True)
    out = {"pipeline": pipeline_full(torch, dev, cfg, model)}
    bounds, trainable = lm_bounds(torch, dev, cfg, model, card)
    del model, trainable
    gc.collect()
    torch.cuda.empty_cache()
    out.update(bounds=bounds, seconds=time.perf_counter() - t0)
    print(f"phase 32: {out['seconds']:.1f} s", flush=True)
    return out


EXAMPLES = ("quickstart", "lvrf_ood", "engine_serving", "runtime_serving",
            "fleet_overload", "tracing")
KERNEL_COUNTERS = ("resonator_step_batch", "resonator_step_batch_masked",
                   "resonator_step_batch_local", "similarity_int8",
                   "flash_decode", "circconv_rows", "circconv_single")


def zero_launches(rs, sim, fd, cc) -> None:
    rs.launches = rs.masked_launches = rs.local_launches = 0
    sim.launches = fd.launches = cc.rows_launches = cc.single_launches = 0


def run_example(name: str, tmp: str, paged: bool) -> tuple:
    """``examples/torch_<name>.py`` run as a user runs it: ``runpy`` as
    ``__main__`` with ``--device cuda`` (a trace path under ``tmp`` for the
    two that write one), ``REPRO_LM_PAGED=1`` when ``paged``.  Returns (the
    figures its ``main`` returned, its wall in seconds)."""
    import os
    import runpy

    path = ROOT / "examples" / f"torch_{name}.py"
    argv = [str(path), "--device", "cuda"]
    if name in ("fleet_overload", "tracing"):
        argv.insert(1, os.path.join(tmp, f"{name}{'_paged' * paged}.json"))
    saved_argv, saved_env = sys.argv, os.environ.pop("REPRO_LM_PAGED", None)
    if paged:
        os.environ["REPRO_LM_PAGED"] = "1"
    sys.argv = argv
    t0 = time.perf_counter()
    try:
        figures = runpy.run_path(str(path), run_name="__main__")["figures"]
    finally:
        sys.argv = saved_argv
        os.environ.pop("REPRO_LM_PAGED", None)
        if saved_env is not None:
            os.environ["REPRO_LM_PAGED"] = saved_env
    return figures, time.perf_counter() - t0


def phase_examples(torch, rs, sim, fd, cc, card) -> dict:
    """Phase 33: the six user examples on the card, each with every kernel
    counter set to 0 just before it and read just after; the two runtime
    examples contiguous and then paged."""
    import tempfile

    runs = [(name, False) for name in EXAMPLES]
    runs.insert(4, ("runtime_serving", True))
    runs.append(("tracing", True))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, paged in runs:
            zero_launches(rs, sim, fd, cc)
            figures, wall = run_example(name, tmp, paged)
            torch.cuda.synchronize()
            launches = dict(zip(KERNEL_COUNTERS,
                                kernel_launches(rs, sim, fd, cc)))
            key = name + " paged" * paged
            out[key] = {"wall_s": wall, "launches": launches,
                        "figures": figures}
            fired = {k: v for k, v in launches.items() if v}
            print(f"phase 33: {key}: {wall:.3f} s on {card}; kernel launches "
                  f"{fired or 'none'}; figures "
                  f"{json.dumps(figures, default=str)}", flush=True)

    def only(key, **want):
        got = {k: v for k, v in out[key]["launches"].items() if v}
        if got != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"phase 33: {key} launched {got}, "
                                 f"expected {want or 'no kernel'}")

    q = out["quickstart"]["figures"]
    only("quickstart",
         similarity_int8=q["num_factors"] * q["int8_iterations"])
    for key in ("lvrf_ood", "engine_serving", "fleet_overload",
                "runtime_serving", "tracing"):
        only(key)
    for name in ("runtime_serving", "tracing"):
        plain, paged = out[name]["figures"], out[f"{name} paged"]["figures"]
        if paged["lm_decode_steps"] < 8 or not paged["lm_paged"] or \
                plain["lm_paged"]:
            raise AssertionError(f"phase 33: {name}: no paged decode")
        only(f"{name} paged",
             flash_decode=paged["lm_layers"] * paged["lm_decode_steps"])
        if plain["lm_tokens"] != paged["lm_tokens"]:
            raise AssertionError(f"phase 33: {name}: paged tokens "
                                 f"{paged['lm_tokens']} != contiguous "
                                 f"{plain['lm_tokens']}")
        for run in (plain, paged):
            if run["lvrf_decoded"] != run["lvrf_truth"]:
                raise AssertionError(f"phase 33: {name}: an LVRF row "
                                     "decoded wrong")
    for key in ("tracing", "tracing paged"):
        t = out[key]["figures"]
        if (t["faults"], t["recoveries"], t["resolved"]) != (1, 1, 16):
            raise AssertionError(f"phase 33: {key}: faults {t['faults']}, "
                                 f"recoveries {t['recoveries']}, resolved "
                                 f"{t['resolved']} (want 1, 1, 16)")
    if out["fleet_overload"]["figures"]["resolved"] != 68:
        raise AssertionError("phase 33: fleet_overload left a request "
                             "unresolved")
    print(f"phase 33: the six examples in "
          f"{sum(r['wall_s'] for r in out.values()):.1f} s on {card}",
          flush=True)
    return out


def phase_spills(build) -> list:
    """ptxas's registers, stack frame and spills of flash_decode's
    tensor-core instantiations (rep 9-16, one a head width and pool type),
    from the build's ``-Xptxas -v`` output; a spill fails."""
    import re

    wide = []
    for u in build.resource_usage(build.compile_log("flash_decode")):
        m = re.search(r"flash_decode_wide_kernelILi(\d+)ELb([01])E",
                      u["function"])
        if m:
            wide.append({"dh": int(m.group(1)),
                         "pool": "int8" if m.group(2) == "1" else "bf16", **u})
    print("phase 1: ptxas -v, flash_decode's tensor-core kernel (rep 9-16): "
          + "; ".join(f"dh {u['dh']} {u['pool']}: {u.get('registers')} "
                      f"registers, {u.get('stack')} bytes stack frame, "
                      f"{u.get('spill_stores')} bytes spill stores, "
                      f"{u.get('spill_loads')} bytes spill loads"
                      for u in wide), flush=True)
    if len(wide) != 8 or any(u.get("spill_stores", 1) or u.get("spill_loads", 1)
                             for u in wide):
        raise AssertionError("phase 1: flash_decode's tensor-core kernel "
                             "spills, or ptxas did not report all 8 "
                             "instantiations")
    return wide


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
    phase_spills(_build)

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
    phase_flash_decode_window(torch, dev, fd)
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
    trained = phase_train(torch, dev, rs, cc, card)
    granite = phase_granite(torch, dev, fd, card)
    starcoder = phase_starcoder(torch, dev, fd, card)
    phase_arch_full(torch, dev, card)
    phase_arch_card_cpu(torch, dev, card)
    cfg_times = {
        GRANITE: phase_fd_timing(torch, dev, fd, granite["lens"], card, g=8,
                                 rep=3, dh=64, kvs=("bf16",), phase=30,
                                 gate=False)["bf16"],
        STARCODER: phase_fd_timing(torch, dev, fd, starcoder["lens"], card,
                                   g=2, rep=12, dh=128, kvs=("bf16", "int8"),
                                   phase=30)}
    rep16 = phase_fd_timing(torch, dev, fd, starcoder["lens"], card, g=2,
                            rep=16, dh=128, kvs=("bf16",), phase=30,
                            gate=False)["bf16"]
    lm_train = phase_lm_train(torch, dev, fd, card)
    launched = kernel_launches(rs, sim, fd, cc)
    phase_dist(torch, dev, card)
    if kernel_launches(rs, sim, fd, cc) != launched:
        raise AssertionError("phase 32 launched a kernel: its pipeline and "
                             "steps reach no pallas_call in the reference")
    examples = phase_examples(torch, rs, sim, fd, cc, card)

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
         "trained_launches": trained["bipolar"]["launches"],
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
         "launches": sim_launches, "max_abs_err": sim_err, **sim_times,
         "quickstart_launches":
             examples["quickstart"]["launches"]["similarity_int8"]},
    ] + [
        {"name": f"flash_decode[{kv}]", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode/kernel.py:87",
         "launches": fd_launches[kv], "max_abs_err": fd_err[kv],
         **fd_times[kv],
         **({"runtime_launches": rt_run["launches"]["flash_decode"],
             "trained_launches": lm_train["launches"],
             "examples_launches": {
                 key: examples[key]["launches"]["flash_decode"]
                 for key in ("runtime_serving paged", "tracing paged")}}
            if kv == "bf16" else {})}
        for kv in ("bf16", "int8")
    ] + [
        {"name": f"flash_decode[{kv}, {arch}]", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode/kernel.py:87",
         "launches": launches, "max_abs_err": fd_err[f"{arch}, {kv}"],
         **times,
         "shape": "B 32, G {}, rep {}, dh {}".format(*FD_CONFIG_SHAPES[arch]),
         **({"rep16_" + key: rep16[key] for key in
             ("ms", "plain_ms", "bound_ms", "library_ms", "by_split")}
            if (arch, kv) == (STARCODER, "bf16") else {})}
        for arch, kv, launches, times in (
            (GRANITE, "bf16", granite["launches"], cfg_times[GRANITE]),
            (STARCODER, "bf16", starcoder["launches"],
             cfg_times[STARCODER]["bf16"]),
            (STARCODER, "int8", starcoder["int8_launches"],
             cfg_times[STARCODER]["int8"]))
    ] + [
        {"name": "circconv_rows", "route": "cuda",
         "source": "src/repro_torch/kernels/circconv/csrc/circconv.cu",
         "replaces": "src/repro/kernels/circconv/kernel.py:55",
         "launches": mimo["launches"], "max_abs_err": cc_err["rows"],
         "trained_launches": trained["mimonet_launches"],
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
