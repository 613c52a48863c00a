"""One Chrome trace for a mixed neurosymbolic + LM chaos run on the PyTorch
port.

The port of ``examples/tracing.py``: three differently shaped engines (NVSA
abduction, LVRF row decoding, transformer greedy decode) behind one
``Runtime(obs=Recorder())``, with seeded fault injection on the LVRF engine
and EWMA-driven re-tuning opted in, all recorded on ONE monotonic clock and
exported as a single Trace Event Format JSON.

Open the output in Perfetto (https://ui.perfetto.dev) or chrome://tracing:

  * the ``requests`` track shows every request-lifecycle span (submit to
    resolution) with ``admit`` instants where the stepper ingested it;
  * the ``nvsa`` / ``lvrf`` / ``lm`` tracks show each engine's step /
    sweep-burst / decode-burst / retire spans and, on lvrf, the
    ``chaos-inject`` instant, the ``recover`` replay span, and the
    ``resize`` warm handoff;
  * the ``supervisor`` track shows the ``fault-cycle`` span (fault ->
    quarantined -> recovered child instants) and the ``retune`` decision
    span with its plan_drift_ratio args.

With ``REPRO_LM_PAGED=1`` every LM decode step of every attention layer is
one launch of the ``flash_decode`` kernel on the card.  The seeded
``FaultPlan`` draws from numpy streams as the reference's does, so its
faults and recoveries are the reference's.

:func:`main` returns every figure it prints.  ``arrays`` may supply the
reference's inputs: ``nvsa_codebooks`` / ``nvsa_mask``, ``lvrf_atoms``,
``lm_params`` (the reference's ``transformer.init`` tree as numpy) and
``prompts`` (three token arrays).  Without it they come from seeds 0-2.

    PYTHONPATH=src python examples/torch_tracing.py [out.json]
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import convert, engine, obs
from repro_torch import runtime as rt
from repro_torch.configs.registry import ARCHS
from repro_torch.core import factorizer as fz
from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.kernels import _build
from repro_torch.models import lvrf, nvsa
from repro_torch.nn import transformer as T
from repro_torch.runtime import faults as flt


def main(device=DEFAULT_DEVICE, *, arrays: dict | None = None,
         out_path: str = "trace.json") -> dict:
    dev = resolve(device)
    rng = np.random.default_rng(0)
    rec = obs.Recorder()

    # --- three engines, one recorder -------------------------------------
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

    # over-provisioned against an assumed 1000 rps: the EWMA drift check
    # shrinks it mid-run, putting a resize span on the trace (warm handoff)
    lvrf_eng = engine.Engine(lspec, slots=16, device=dev)
    # seeded chaos on the lvrf engine: one injected step fault -> the trace
    # shows chaos-inject, then the supervisor's fault-cycle through recovery
    lvrf_chaos = flt.ChaosEngine(lvrf_eng, flt.FaultPlan(
        seed=1, step_error_rate=0.4, max_faults=1))
    lm_eng = rt.LMEngine(mcfg, model, slots=2, max_len=48, device=dev)
    if dev.type == "cuda" and lm_eng.paged is not None:
        _build.load("flash_decode")  # before the stepper's watchdog starts

    runtime = rt.Runtime(obs=rec, failure=rt.FailurePolicy(
        max_restarts=8, backoff_initial_s=0.01, backoff_max_s=0.05))
    runtime.register("nvsa", engine.Engine(nspec, slots=8, device=dev))
    runtime.register("lvrf", lvrf_chaos, retune=rt.RetunePolicy(
        threshold=2.0, check_every=1, baseline_rps=1000.0,
        candidates=(4, 8, 16), use_measured_cost=True))
    runtime.register("lm", lm_eng)

    # --- mixed traffic under chaos ---------------------------------------
    attrs = torch.from_numpy(rng.integers(0, (5, 6, 10), (8, 3)))
    ctx = nvsa.target_query(nspec.codebooks, attrs, ncfg)
    nkeys = fz.draw_keys(5, 8)
    vals = rng.integers(0, lcfg.n_values, (10, 3))
    rows = lvrf.encode_row(atoms, torch.from_numpy(vals), lcfg)
    # junk queries never converge: they burn toward max_iters, keeping lvrf
    # busy long enough for the seeded fault to land mid-trajectory (so the
    # recover span has rows to replay) and for the measured step-cost EWMA
    # to accumulate past the excluded first step (so plan_drift_ratio
    # resolves)
    junk = torch.from_numpy(rng.normal(size=(2, lcfg.vsa.dim))
                            .astype(np.float32)).to(dev)
    lkeys = fz.draw_keys(6, 12)

    with runtime:
        g_nvsa = runtime.submit("nvsa", ctx, keys=nkeys)
        g_junk = [runtime.submit("lvrf", junk[j], keys=lkeys[10 + j][None])
                  for j in range(2)]  # first: they hold slots mid-trajectory
        g_rows = [runtime.submit("lvrf", rows[i], keys=lkeys[i][None])
                  for i in range(10)]
        g_lm = [runtime.submit("lm", p, max_new_tokens=8) for p in prompts]
        done = runtime.drain(timeout=600, return_exceptions=True)
        stats = runtime.stats()

    tel = stats["lvrf"]["telemetry"]
    faults = tel["faults"]
    n_exc = sum(isinstance(d, Exception) for d in done)
    print(f"[run] {len(done)} futures resolved ({n_exc} structured faults); "
          f"lvrf faults={faults} recoveries={tel['recoveries']} "
          f"slots {16}->{lvrf_eng.slots} (retunes={tel['retunes']})")
    drift = tel["plan_drift_ratio"]
    print(f"[plan] lvrf modeled unit cost {tel['modeled_unit_s']} s vs "
          f"measured -> plan_drift_ratio={drift and round(drift, 2)}")

    errors = obs.validate(rec.spans.snapshot())
    assert not errors, errors
    rec.write_chrome_trace(out_path)
    spans = rec.spans.snapshot()
    per_track: dict = {}
    for s in spans:
        per_track[s.track] = per_track.get(s.track, 0) + 1
    print(f"[trace] {len(spans)} spans across tracks {per_track} -> "
          f"{out_path}")
    print("[trace] open in https://ui.perfetto.dev or chrome://tracing")

    # what each request came back with (drain answers in submission order)
    by_gid = dict(zip([g_nvsa, *g_junk, *g_rows, *g_lm], done))
    lvrf_decoded = [None if isinstance(by_gid[g], Exception) else
                    np.asarray(by_gid[g].result["values"][0]).tolist()
                    for g in g_rows]
    lm_tokens = [None if isinstance(by_gid[g], Exception) else
                 list(by_gid[g].result["tokens"]) for g in g_lm]
    return {"resolved": len(done), "structured_faults": n_exc,
            "faults": faults, "recoveries": tel["recoveries"],
            "lvrf_slots": lvrf_eng.slots, "retunes": tel["retunes"],
            "modeled_unit_s": tel["modeled_unit_s"],
            "plan_drift_ratio": drift, "validate_errors": errors,
            "spans": len(spans), "tracks": per_track,
            "lvrf_decoded": lvrf_decoded, "lvrf_truth": vals.tolist(),
            "lm_tokens": lm_tokens, "lm_paged": lm_eng.paged is not None,
            "lm_layers": mcfg.n_layers,
            "lm_decode_steps": lm_eng.serve.decode_dispatches,
            "trace": out_path}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default="trace.json")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args()
    figures = main(args.device, out_path=args.out)
