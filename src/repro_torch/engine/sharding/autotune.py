"""Slot-count autotuning from the adSCH cost model + arrival rate.

The port of the reference package's ``engine/sharding/autotune.py``.  The
model is the steady state of continuous batching: with ``n`` live rows per
data shard the engine retires on average ``n * data_shards / mean_iters``
requests per full-batch sweep, and a sweep costs ``t_sweep(n)`` seconds,
priced either analytically (the scheduler's makespan for one sweep's op
graph, collectives included) or by timing a real sweep
(:func:`measure_sweep_seconds`).

``choose_slots`` then picks the smallest slot count whose service rate
covers the arrival rate with headroom: smallest because every extra slot
adds queueing latency for nothing once the engine keeps up.  Without an
arrival target it returns the diminishing-returns knee of the throughput
curve.
"""
from __future__ import annotations

import time

import torch

from repro_torch.cogsim import model as hw_model
from repro_torch.core import factorizer as fz
from repro_torch.core import scheduler as sch
from repro_torch.device import DEFAULT_DEVICE, resolve

DEFAULT_CANDIDATES = (4, 8, 16, 32, 64, 128, 256)


def modeled_sweep_seconds(cfg: fz.FactorizerConfig, slots_per_shard: int,
                          hw=hw_model.COGSYS, *, data_shards: int = 1,
                          model_shards: int = 1,
                          fused: bool | None = None) -> float:
    """adSCH makespan of ONE per-device sweep (collectives included).

    UNITS: **modeled device-seconds** on the paper's cell pool (makespan
    cycles / ``hw.freq_hz``) — NOT wall-clock seconds of the machine that is
    actually serving.  A service rate built on this is only comparable to
    other modeled rates (relative slot-count decisions); mixing it with a
    wall-clock arrival rate (the runtime's EWMA) compares incompatible
    units — use a measured sweep cost for that (see :func:`choose_slots`
    ``measured_sweep_s`` and :func:`retune_slots` ``measured_step_unit_s``).

    ``fused`` defaults to the config's own fused-sweep eligibility
    (:func:`repro_torch.core.factorizer.fused_sweep_eligible`), so a fused spec's
    halved codebook HBM term prices into the verdicts automatically.
    """
    ops = fz.sweep_cost_ops(cfg, slots_per_shard * data_shards,
                            data_shards=data_shards,
                            model_shards=model_shards, fused=fused)
    return sch.schedule(ops, hw).makespan / hw.freq_hz


def measure_sweep_seconds(spec, slots_per_shard: int, *, iters: int = 5,
                          device=DEFAULT_DEVICE) -> float:
    """Time one single-device sweep of ``spec`` at this slot count on
    ``device``: CUDA events around ``iters`` sweeps on the card, the host
    clock on the CPU (after one warm-up sweep).

    Host-mode measurement for :func:`choose_slots`'s ``measured_sweep_s``;
    per-shard cost on a homogeneous mesh is the same program at the local
    slot count.
    """
    dev = resolve(device)
    rs = fz.make_resonator(spec.codebooks.to(dev), spec.cfg,
                           None if spec.valid_mask is None
                           else spec.valid_mask.to(dev))
    qs = torch.zeros((slots_per_shard, spec.dim), dtype=torch.float32,
                     device=dev)
    s = rs.init(qs, fz.draw_keys(0, slots_per_shard))
    s = rs.sweep(qs, s)  # warm-up: first loads, plans, allocations
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            s = rs.sweep(qs, s)
        stop.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(stop) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        s = rs.sweep(qs, s)
    return (time.perf_counter() - t0) / iters


def service_rate_rps(spec, slots_per_shard: int, *, data_shards: int = 1,
                     model_shards: int = 1, hw=hw_model.COGSYS,
                     mean_iters: float | None = None,
                     measured_sweep_s=None) -> float:
    """Steady-state requests/s the engine retires at this slot count.

    UNITS: with ``measured_sweep_s`` the result is wall-clock requests/s —
    directly comparable to an EWMA arrival rate.  Without it the sweep cost
    is :func:`modeled_sweep_seconds` (**modeled device-seconds**), so the
    "rate" is a model-relative quantity: fine for comparing candidates
    against each other, NOT against a wall-clock ``arrival_rps``.
    """
    if measured_sweep_s is not None:
        t = measured_sweep_s(slots_per_shard) if callable(measured_sweep_s) \
            else float(measured_sweep_s)
    else:
        t = modeled_sweep_seconds(spec.cfg, slots_per_shard, hw,
                                  data_shards=data_shards,
                                  model_shards=model_shards)
    iters = mean_iters if mean_iters is not None else \
        max(1, spec.cfg.max_iters // 3)  # observed mean convergence ~ max/3
    return slots_per_shard * data_shards / (iters * max(t, 1e-12))


def choose_slots(spec, *, arrival_rps: float | None = None,
                 data_shards: int = 1, model_shards: int = 1,
                 hw=hw_model.COGSYS, candidates=DEFAULT_CANDIDATES,
                 mean_iters: float | None = None, measured_sweep_s=None,
                 headroom: float = 1.25, knee_gain: float = 1.15) -> int:
    """Pick slots-per-shard for a (possibly sharded) engine.

    With ``arrival_rps``: the smallest candidate whose modeled service rate
    covers ``headroom * arrival_rps`` (more slots past that point only adds
    batch-formation latency); the max-throughput candidate if none keeps up.
    Without: the knee of the throughput curve — the smallest candidate whose
    doubling no longer buys ``knee_gain`` more requests/s.

    ``measured_sweep_s`` (a seconds value or a ``f(slots_per_shard)``
    callable, e.g. :func:`measure_sweep_seconds`) replaces the analytic
    sweep cost with a measured one.  UNITS: only with a measured cost are
    the candidate service rates wall-clock and hence commensurable with a
    wall-clock ``arrival_rps``; the analytic basis is modeled
    device-seconds — see :func:`modeled_sweep_seconds` — and should be
    reserved for offline sizing where both sides come from the model.
    """
    cands = sorted(set(int(c) for c in candidates))
    if not cands:
        raise ValueError("choose_slots needs at least one candidate")
    rate = {n: service_rate_rps(spec, n, data_shards=data_shards,
                                model_shards=model_shards, hw=hw,
                                mean_iters=mean_iters,
                                measured_sweep_s=measured_sweep_s)
            for n in cands}
    if arrival_rps is not None:
        for n in cands:
            if rate[n] >= headroom * arrival_rps:
                return n
        return max(cands, key=lambda n: rate[n])
    for a, b in zip(cands, cands[1:]):
        if rate[b] < knee_gain * rate[a]:
            return a
    return cands[-1]


def retune_slots(engine, arrival_rps: float, *,
                 candidates=DEFAULT_CANDIDATES, mean_iters: float | None = None,
                 headroom: float = 1.25, measured_sweep_s=None,
                 measured_step_unit_s: float | None = None) -> int | None:
    """Online re-tune entry point: re-run :func:`choose_slots` against a live
    engine's current shape and a FRESH arrival-rate estimate (the runtime's
    EWMA over submit timestamps).

    Returns the new GLOBAL slot count when it differs from the engine's
    current one (ready to hand to :meth:`repro_torch.engine.Engine.resize`), else
    ``None``.  Works for both the single-device ``Engine`` (shards default
    to 1) and ``ShardedEngine`` (slots-per-shard re-chosen, scaled back up
    by the data axis so divisibility is preserved by construction).

    UNITS — the pitfall this signature exists to avoid: ``arrival_rps`` is
    WALL-CLOCK (EWMA over submit timestamps), but the default analytic sweep
    cost is **modeled device-seconds** on the paper's cell pool
    (:func:`modeled_sweep_seconds`), typically orders of magnitude below the
    wall cost of the machine actually serving — an analytic re-tune then
    concludes the smallest candidate always keeps up and never moves slots.
    Prefer a measured cost basis whenever one exists:

    * ``measured_step_unit_s`` — wall seconds of ONE step unit (sweep) at
      the engine's CURRENT slots-per-shard, e.g. the runtime's step-time
      EWMA.  Candidate
      costs are this measurement scaled by the analytic model's
      *dimensionless ratio* ``modeled(n) / modeled(current)`` — wall-clock
      units, no extra measurement stalls.
    * ``measured_sweep_s`` — replaces the sweep cost exactly as in
      :func:`choose_slots`; pass ``True`` to time the spec's actual
      sweep per candidate (:func:`measure_sweep_seconds`) — the
      honest (but stalling) basis when re-tuning on the serving machine.
      Takes precedence over ``measured_step_unit_s``.
    """
    if engine.spec.cfg is None:
        return None  # not a factorizer engine; nothing for choose_slots to price
    data = getattr(engine, "data_shards", 1)
    model = (engine.model_shards
             if getattr(engine, "_rows", False) else 1)
    if measured_sweep_s is True:
        spec, dev = engine.spec, engine.device
        measured_sweep_s = lambda n: measure_sweep_seconds(spec, n,
                                                           device=dev)
    elif measured_sweep_s is None and measured_step_unit_s is not None:
        cfg, hw = engine.spec.cfg, engine.hw
        cur = max(1, engine.slots // data)
        base = modeled_sweep_seconds(cfg, cur, hw, data_shards=data,
                                     model_shards=model)

        def measured_sweep_s(n, _t0=float(measured_step_unit_s), _base=base):
            scale = (modeled_sweep_seconds(cfg, n, hw, data_shards=data,
                                           model_shards=model) / _base
                     if _base > 0 else n / cur)
            return _t0 * scale
    per_shard = choose_slots(engine.spec, arrival_rps=arrival_rps,
                             data_shards=data, model_shards=model,
                             hw=engine.hw, candidates=candidates,
                             mean_iters=mean_iters, headroom=headroom,
                             measured_sweep_s=measured_sweep_s)
    total = per_shard * data
    return None if total == engine.slots else total
