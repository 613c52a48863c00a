"""Request-level neurosymbolic serving through the PyTorch port's engine API.

The port of ``examples/engine_serving.py``.  Serves two very differently
shaped workloads through the SAME ``Engine.submit/step/drain`` interface,
NVSA RPM abduction (unitary block-code attribute factorization +
probabilistic abduction) and LVRF row decoding (bipolar MAP), then runs the
NVSA stage graph as the adSCH-planned pipelined stream.  NVSA's default
config is unitary and LVRF's spec is not fused, so no hand-written kernel
runs here: the sweeps are matmuls and FFTs.

:func:`main` returns every figure it prints.  ``arrays`` may supply the
reference's inputs: ``nvsa_codebooks`` [3, 10, 1024] and ``nvsa_mask``
[3, 10], ``cnn_params`` (the reference's CNN tree), ``lvrf_atoms``
(``{"values", "positions"}``), and the stream's ``images`` [T, B, 9, 32,
32] and ``candidates`` [T, B, 8, 32, 32].  Without it they come from seeds
0, 1, 2 and 3.  The stochastic NVSA sweeps draw from ``core/rng.py``, not
``jax.random``.

    PYTHONPATH=src python examples/torch_engine_serving.py [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import convert, engine
from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.models import cnn, lvrf, nvsa

T, B = 3, 2  # the stream: T task batches of B tasks


def main(device=DEFAULT_DEVICE, *, arrays: dict | None = None) -> dict:
    dev = resolve(device)
    out = {}
    # --- 1. NVSA abduction requests --------------------------------------
    cfg = nvsa.NVSAConfig()
    if arrays is not None:
        cbs, mask = convert.spec_arrays_from_reference(
            arrays["nvsa_codebooks"], arrays["nvsa_mask"], dev)
        params = convert.cnn_params_from_reference(arrays["cnn_params"], dev)
    else:
        cbs = mask = None
        params = cnn.init(cfg.cnn, 1, device=dev)
    spec = engine.registry.build("nvsa_abduction", 0, cfg=cfg, params=params,
                                 batch=B, codebooks=cbs, mask=mask,
                                 device=dev)
    eng = engine.Engine(spec, slots=16, device=dev)
    print(f"[nvsa] slots=16 sweeps_per_step={eng.sweeps_per_step} "
          "(adSCH-derived)")
    cbs, mask = spec.codebooks, spec.valid_mask
    rng = np.random.default_rng(0)
    tasks = []
    for _ in range(4):  # four RPM tasks: 8 context queries + 8 candidates
        attrs = rng.integers(0, (5, 6, 10), (8, 3))
        ctx = nvsa.target_query(cbs, torch.from_numpy(attrs), cfg)
        cand = nvsa.target_query(
            cbs, torch.from_numpy(rng.integers(0, (5, 6, 10), (8, 3))), cfg)
        eng.submit(ctx, meta={"cand": cand})
        tasks.append(attrs)
    answers, iters, converged = [], [], []
    for req in eng.drain():
        print(f"[nvsa] task {req.id}: answer={req.result['answer']} "
              f"iters/query={req.iterations.tolist()} "
              f"latency={req.latency_s * 1e3:.1f}ms")
        answers.append(req.result["answer"])
        iters.append(req.iterations.tolist())
        converged.append(np.asarray(req.result["converged"]).tolist())
    stats = eng.stats()
    print("[nvsa]", stats)
    out["nvsa"] = {"sweeps_per_step": eng.sweeps_per_step,
                   "answers": answers, "iterations": iters,
                   "converged": converged,
                   "tasks": [a.tolist() for a in tasks],
                   "sweeps_total": eng.sweeps_total}

    # --- 2. LVRF row decoding through the same API -------------------------
    lcfg = lvrf.LVRFConfig()
    atoms = (convert.lvrf_atoms_from_reference(arrays["lvrf_atoms"], dev)
             if arrays is not None else lvrf.init_atoms(0, lcfg, device=dev))
    lspec = engine.registry.build("lvrf_rows", 0, atoms=atoms, device=dev)
    leng = engine.Engine(lspec, slots=8, device=dev)
    vals = rng.integers(0, lcfg.n_values, (6, 3))
    for i in range(6):
        leng.submit(lvrf.encode_row(atoms, torch.from_numpy(vals[i]), lcfg))
    decoded = [np.asarray(r.result["values"][0]).tolist()
               for r in leng.drain()]
    print(f"[lvrf] decoded rows: {decoded} (truth {vals.tolist()})")
    out["lvrf"] = {"decoded": decoded, "truth": vals.tolist()}

    # --- 3. Stream serving: adSCH-planned pipelined stream -----------------
    plan = engine.plan_interleave(spec.graph)
    print(f"[stream] adSCH plan: lags={plan.lags} "
          f"gain={plan.gains[0]:.2f}x depth={plan.depth}")
    runner = engine.build_pipeline(spec.graph, plan=plan)
    if arrays is not None:
        imgs = convert.from_numpy(arrays["images"], dev)
        cands = convert.from_numpy(arrays["candidates"], dev)
    else:
        imgs = torch.rand((T, B, 9, 32, 32),
                          generator=torch.Generator().manual_seed(2)).to(dev)
        cands = torch.rand((T, B, 8, 32, 32),
                           generator=torch.Generator().manual_seed(3)).to(dev)
    answers = np.asarray(torch.as_tensor(runner((imgs, cands), 7)).cpu())
    print(f"[stream] {T} task batches -> answers {answers.tolist()}")
    out["stream"] = {"lags": list(plan.lags), "gain": float(plan.gains[0]),
                     "depth": plan.depth, "answers": answers.tolist()}
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    figures = main(ap.parse_args().device)
