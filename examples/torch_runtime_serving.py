"""Mixed neurosymbolic + LM traffic through ONE online serving runtime of the
PyTorch port.

The port of ``examples/runtime_serving.py``.  Three very differently shaped
engines behind the same async ``Runtime``: NVSA RPM abduction (unitary
block-code factorization), LVRF row decoding (bipolar MAP), and transformer
greedy decode (``LMEngine`` over ``launch/serve.ServeEngine``).  Requests
are submitted from the caller thread and complete on the background
stepper, which picks the next engine by adSCH-modeled step cost x queue
depth; the LVRF engine additionally opts into EWMA-driven slot re-tuning:
its ``slots`` change mid-run with zero effect on results (warm handoff).

With ``REPRO_LM_PAGED=1`` the LM engine serves from the paged KV pool and
every decode step of every attention layer is one launch of the
``flash_decode`` kernel on the card; the tokens and decodes must not change.

:func:`main` returns every figure it prints.  ``arrays`` may supply the
reference's inputs: ``nvsa_codebooks`` / ``nvsa_mask``, ``lvrf_atoms``,
``lm_params`` (the reference's ``transformer.init`` tree as numpy) and
``prompts`` (three token arrays).  Without it they come from seeds 0-2.

    PYTHONPATH=src python examples/torch_runtime_serving.py [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import convert, engine
from repro_torch import runtime as rt
from repro_torch.configs.registry import ARCHS
from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.kernels import _build
from repro_torch.models import lvrf, nvsa
from repro_torch.nn import transformer as T


def main(device=DEFAULT_DEVICE, *, arrays: dict | None = None) -> dict:
    dev = resolve(device)
    rng = np.random.default_rng(0)

    # --- the three engines ------------------------------------------------
    ncfg = nvsa.NVSAConfig()
    cbs = mask = None
    lcfg = lvrf.LVRFConfig()
    mcfg = ARCHS["llama3.2-3b"].smoke()
    if arrays is not None:
        cbs, mask = convert.spec_arrays_from_reference(
            arrays["nvsa_codebooks"], arrays["nvsa_mask"], dev)
        atoms = convert.lvrf_atoms_from_reference(arrays["lvrf_atoms"], dev)
        model = convert.lm_params_from_reference(arrays["lm_params"], mcfg,
                                                 device=dev)
        prompts = convert.from_numpy(list(arrays["prompts"]), dev)
    else:
        atoms = lvrf.init_atoms(0, lcfg, device=dev)
        model = T.init(mcfg, 0, device=dev)
        prompts = [torch.randint(0, mcfg.vocab, (6,),
                                 generator=torch.Generator().manual_seed(i))
                   for i in range(3)]
    nspec = engine.registry.build("nvsa_abduction", 0, cfg=ncfg,
                                  codebooks=cbs, mask=mask, device=dev)
    lspec = engine.registry.build("lvrf_rows", 0, atoms=atoms, device=dev)
    # deliberately over-provisioned for an assumed 1000 rps of row traffic;
    # the live EWMA estimate will say otherwise and the runtime shrinks it
    lvrf_eng = engine.Engine(lspec, slots=16, device=dev)
    lm_eng = rt.LMEngine(mcfg, model, slots=2, max_len=48, device=dev)
    if dev.type == "cuda" and lm_eng.paged is not None:
        _build.load("flash_decode")  # before the stepper's watchdog starts
    print(f"[lm] decode_per_step={lm_eng.decode_per_step} (adSCH-derived "
          "from the registered lm_decode StageGraph)")

    runtime = rt.Runtime()
    runtime.register("nvsa", engine.Engine(nspec, slots=8, device=dev))
    # re-tune on EWMA drift, pricing candidates by TIMING the sweep (the
    # analytic cell-pool model is device-seconds of the paper's hardware;
    # measured cost is the honest basis on the machine serving this)
    runtime.register("lvrf", lvrf_eng, retune=rt.RetunePolicy(
        threshold=2.0, check_every=1, baseline_rps=1000.0,
        candidates=(4, 8, 16), use_measured_cost=True))
    runtime.register("lm", lm_eng)

    # --- mixed traffic, async ---------------------------------------------
    attrs = torch.from_numpy(rng.integers(0, (5, 6, 10), (8, 3)))
    cand = nvsa.target_query(nspec.codebooks, torch.from_numpy(
        rng.integers(0, (5, 6, 10), (8, 3))), ncfg)
    vals = rng.integers(0, lcfg.n_values, (12, 3))
    rows = lvrf.encode_row(atoms, torch.from_numpy(vals), lcfg)  # up front
    with runtime:
        g_nvsa = runtime.submit(
            "nvsa", nvsa.target_query(nspec.codebooks, attrs, ncfg),
            meta={"cand": cand})
        g_lvrf = [runtime.submit("lvrf", rows[i]) for i in range(12)]
        g_lm = [runtime.submit("lm", p, max_new_tokens=8) for p in prompts]
        print("[submit] 1 NVSA task + 12 LVRF rows + 3 LM prompts in flight "
              "(returns immediately; stepper thread serves)")

        req = runtime.result(g_nvsa, timeout=600)
        print(f"[nvsa] answer={req.result['answer']} "
              f"iters/query={req.iterations.tolist()} "
              f"latency={req.latency_s * 1e3:.0f}ms")
        nvsa_out = {"answer": req.result["answer"],
                    "iterations": req.iterations.tolist(),
                    "converged": np.asarray(req.result["converged"]).tolist()}
        decoded = [np.asarray(runtime.result(g, timeout=600)
                              .result["values"][0]).tolist() for g in g_lvrf]
        print(f"[lvrf] decoded rows: {decoded[:4]}... "
              f"(truth {vals[:4].tolist()}...)")
        tokens = []
        for g in g_lm:
            r = runtime.result(g, timeout=600)
            print(f"[lm] request {r.id}: tokens={r.result['tokens']}")
            tokens.append(list(r.result["tokens"]))
        stats = runtime.stats()

    tel = stats["lvrf"]["telemetry"]
    print(f"[retune] lvrf slots now {lvrf_eng.slots} after "
          f"{tel['retunes']} EWMA-triggered re-tune(s) (arrival estimate "
          f"{tel['arrival_rate_rps']:.1f} rps)")
    per_engine = {}
    for name in ("nvsa", "lvrf", "lm"):
        t = stats[name]["telemetry"]
        print(f"[stats] {name}: completed={t['completed']} "
              f"p50={t['latency_p50_ms'] and round(t['latency_p50_ms'])}ms "
              f"util={t['utilization']:.2f}")
        per_engine[name] = {"completed": t["completed"],
                            "latency_p50_ms": t["latency_p50_ms"],
                            "utilization": t["utilization"]}
    return {"nvsa": nvsa_out, "lvrf_decoded": decoded,
            "lvrf_truth": vals.tolist(), "lm_tokens": tokens,
            "lm_paged": lm_eng.paged is not None,
            "lm_decode_per_step": lm_eng.decode_per_step,
            "lm_layers": mcfg.n_layers,
            "lm_decode_steps": lm_eng.serve.decode_dispatches,
            "lvrf_slots": lvrf_eng.slots, "retunes": tel["retunes"],
            "arrival_rate_rps": tel["arrival_rate_rps"], "stats": per_engine}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    figures = main(ap.parse_args().device)
