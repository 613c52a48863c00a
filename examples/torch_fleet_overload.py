"""Overload-resilient fleet control on the PyTorch port, end to end.

The port of ``examples/fleet_overload.py``.  One 4-slot LVRF engine is hit
with ~8x its capacity in slot-hogging best-effort work, then an interactive
minority arrives behind the bulk.  The same workload runs twice:

  * **fleet policy on**: priority-class admission (backlog priced in
    estimated wait from the measured step-cost EWMA), bit-safe preemption
    (victims re-queue from their pinned key and replay bit-equal), and
    debounced brownout that trims best-effort iteration budgets into
    structured ``DegradedResult``s;
  * **no policy**: the FIFO baseline, where interactive latency inherits
    the whole best-effort queue.

The policy run records on an ``obs.Recorder`` and exports a Chrome trace:
open it in Perfetto (https://ui.perfetto.dev) and look at the
``supervisor`` track for the fleet's own narration: ``admission`` instants
(degrade decisions with their est-wait args), ``preempt`` instants (victim
+ rows), and the ``brownout`` span bracketing the hot period.  The LVRF
spec is not fused, so no hand-written kernel runs here.

:func:`main` returns every figure it prints.  ``arrays`` may supply the
reference's ``lvrf_atoms``; the rows come from ``default_rng(0)`` in the
reference's order.  Attainment, p95 and the fleet's counts follow the
host's clock.

    PYTHONPATH=src python examples/torch_fleet_overload.py [out.json]
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import convert, engine, obs
from repro_torch import runtime as rt
from repro_torch.core import factorizer as fz
from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.models import lvrf

N_JUNK, N_GOOD = 24, 10


def main(device=DEFAULT_DEVICE, *, arrays: dict | None = None,
         out_path: str = "fleet_trace.json") -> dict:
    dev = resolve(device)
    rng = np.random.default_rng(0)
    lcfg = lvrf.LVRFConfig()
    atoms = (convert.lvrf_atoms_from_reference(arrays["lvrf_atoms"], dev)
             if arrays is not None else lvrf.init_atoms(0, lcfg, device=dev))
    spec = engine.registry.build("lvrf_rows", 0, atoms=atoms, device=dev)

    # good queries converge in a step or two; junk never converges and
    # burns its full iteration budget: the slot-hogging bulk
    vals = rng.integers(0, lcfg.n_values, (N_GOOD, 3))
    good = lvrf.encode_row(atoms, torch.from_numpy(vals), lcfg)
    junk = torch.from_numpy(rng.normal(size=(N_JUNK, lcfg.vsa.dim))
                            .astype(np.float32)).to(dev)
    gkeys, jkeys = fz.draw_keys(3, N_GOOD), fz.draw_keys(4, N_JUNK)

    # --- calibrate the SLO target in measured step times -----------------
    cal = engine.Engine(spec, slots=4, sweeps_per_step=2, device=dev)
    cal.submit(junk[0], keys=jkeys[0][None])
    cal.drain()  # warm up before timing
    t0 = time.perf_counter()
    cal.submit(junk[1], keys=jkeys[1][None])
    steps0 = cal.steps_total
    cal.drain()
    t_step = (time.perf_counter() - t0) / max(1, cal.steps_total - steps0)
    # interactive must land well under the ~120-step FIFO queue wait but
    # above the few steps the priority/preempt path needs
    target_s = 30.0 * t_step + 0.008
    print(f"[cal] warm step {t_step * 1e3:.2f} ms -> "
          f"interactive target {target_s * 1e3:.1f} ms")

    def run(fleet, rec=None):
        eng = engine.Engine(spec, slots=4, sweeps_per_step=2, device=dev)
        # warm this instance's step AND preempt paths before the clock
        # matters: first executions are scheduling-policy noise, not signal
        w = [eng.submit(junk[i], keys=jkeys[i][None], priority=3)
             for i in range(2)]
        eng.step()
        eng.preempt(w[0])
        eng.submit(good[0], keys=gkeys[0][None], priority=0)
        eng.drain()

        r = rt.Runtime(obs=rec, slo={"interactive": obs.SLOTarget(target_s),
                                     "best_effort": obs.SLOTarget(target_s)},
                       fleet=fleet)
        r.register("lvrf", eng)
        with r:
            # first wave saturates the engine...
            jids = [r.submit("lvrf", junk[i], keys=jkeys[i][None],
                             class_="best_effort")
                    for i in range(N_JUNK // 2)]
            deadline = time.monotonic() + 300.0
            while time.monotonic() < deadline:
                live = sum(i["rows"] for i in eng.live_requests().values())
                if live == 4 and eng.in_flight == N_JUNK // 2:
                    break
                time.sleep(0.002)
            # ...the second wave arrives against a warm EWMA and a deep
            # backlog, so the fleet prices its wait honestly (degrade /
            # brownout territory); the interactive minority lands last
            jids += [r.submit("lvrf", junk[i], keys=jkeys[i][None],
                              class_="best_effort")
                     for i in range(N_JUNK // 2, N_JUNK)]
            gids = [r.submit("lvrf", good[i], keys=gkeys[i][None],
                             class_="interactive") for i in range(N_GOOD)]
            reqs = [r.result(g, timeout=300.0) for g in jids + gids]
            snap = r.stats()
        return snap, reqs

    policy = rt.FleetPolicy(
        classes=(rt.PriorityClass("interactive", priority=0),
                 rt.PriorityClass("best_effort", priority=3, preemptible=True,
                                  degradable=True,
                                  degrade_wait_s=8.0 * t_step)),
        default_class="best_effort", max_preempt_per_tick=4,
        rebalance_every=0,
        brownout=rt.BrownoutPolicy(enter_wait_s=8.0 * t_step, enter_ticks=2,
                                   max_iters_factor=0.25))

    rec = obs.Recorder()
    snap_p, reqs_p = run(policy, rec)
    snap_b, reqs_b = run(None)

    # --- what the policy bought -------------------------------------------
    slo_out = {}
    for label, snap in (("policy", snap_p), ("baseline", snap_b)):
        slo = snap["slo"]
        print(f"[{label:8s}] interactive attainment "
              f"{slo['interactive']['attainment']:.2f} "
              f"(p95 {slo['interactive']['latency_p95_s'] * 1e3:.1f} ms) | "
              f"best_effort attainment {slo['best_effort']['attainment']:.2f} "
              f"(p95 {slo['best_effort']['latency_p95_s'] * 1e3:.1f} ms)")
        slo_out[label] = {c: {"attainment": slo[c]["attainment"],
                              "latency_p95_s": slo[c]["latency_p95_s"]}
                          for c in ("interactive", "best_effort")}

    fleet = snap_p["fleet"]
    degraded = sum(isinstance(req.result, rt.DegradedResult)
                   for req in reqs_p)
    print(f"[fleet] preempted rows {dict(fleet['preempted_rows'])} | "
          f"degraded admissions {dict(fleet['degraded'])} "
          f"({degraded} DegradedResults) | brownouts {fleet['brownouts']} | "
          f"admitted {dict(fleet['admitted'])}")
    assert all(req.result is not None for req in reqs_p + reqs_b), \
        "every request must resolve to a structured result"
    assert len(reqs_p) == len(reqs_b) == N_JUNK + N_GOOD

    # --- the narrated trace -----------------------------------------------
    errors = obs.validate(rec.spans.snapshot())
    assert not errors, errors
    rec.write_chrome_trace(out_path)
    spans = rec.spans.snapshot()
    per_track: dict = {}
    for s in spans:
        per_track[s.track] = per_track.get(s.track, 0) + 1
    n_preempt = sum(s.name == "preempt" for s in spans)
    print(f"[trace] {len(spans)} spans across tracks {per_track} "
          f"({n_preempt} preempt instants on the supervisor track) -> "
          f"{out_path}")
    print("[trace] open in https://ui.perfetto.dev or chrome://tracing")
    return {"t_step_s": t_step, "target_s": target_s, "slo": slo_out,
            "preempted_rows": dict(fleet["preempted_rows"]),
            "degraded_admissions": dict(fleet["degraded"]),
            "degraded_results": degraded, "brownouts": fleet["brownouts"],
            "admitted": dict(fleet["admitted"]),
            "interactive_decoded": [np.asarray(req.result["values"][0])
                                    .tolist() for req in reqs_p[N_JUNK:]],
            "resolved": len(reqs_p) + len(reqs_b),
            "requests": len(reqs_p), "validate_errors": errors,
            "spans": len(spans), "tracks": per_track,
            "preempt_instants": n_preempt, "trace": out_path}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default="fleet_trace.json")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args()
    figures = main(args.device, out_path=args.out)
