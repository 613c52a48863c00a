"""repro_torch.runtime — the online serving runtime above the engines.

The port of the reference package's ``runtime``: a background stepper
thread drives any mix of :class:`repro_torch.engine.Engine`,
:class:`repro_torch.engine.ShardedEngine` and :class:`LMEngine` instances
through the structural :class:`Steppable` protocol, with

  * futures-based async ``submit`` (``Runtime.submit`` returns immediately,
    ``Runtime.result(id)`` blocks),
  * cost-weighted stepping (adSCH-modeled step cost x queue depth picks the
    next engine, so cheap symbolic bursts aren't starved by LM decode),
  * per-engine EWMA arrival-rate telemetry over submit timestamps,
  * online re-tuning: drift past a :class:`RetunePolicy` threshold re-runs
    ``choose_slots`` and applies the verdict via the engines' warm-handoff
    ``resize`` — in-flight trajectories preserved bit for bit,
  * per-engine supervision under a :class:`FailurePolicy`: a faulting
    engine is quarantined (exponential backoff) and recovered by rebuild +
    replay from pinned keys — bit-equal to a fault-free run — while the
    other engines keep serving; deadlines (``submit(deadline_s=)``),
    bounded-queue shedding, and a heartbeat watchdog guarantee every
    future resolves with a result or a structured
    :class:`~repro_torch.runtime.faults.FaultError`, never a hang.  The
    seeded chaos harness lives in :mod:`repro_torch.runtime.faults`
    (:class:`FaultPlan` / :class:`ChaosEngine`), and
  * fleet-level overload policy under a :class:`FleetPolicy`
    (``Runtime(fleet=...)``): priority-class admission control, bit-safe
    preemption of low-priority live rows, a global slot budget rebalanced
    between engines through ``resize``, and brownout modes that trim
    best-effort budgets with a structured :class:`DegradedResult` marker
    (:mod:`repro_torch.runtime.fleet`).

Every engine call runs on the stepper thread, so every kernel launch does
too, on that thread's default CUDA stream.  Build the kernels before
``start()`` on a fresh checkout (``kernels/_build.py::load``): an nvcc build
inside the first step counts against the watchdog.

Typical use::

    from repro_torch import engine, runtime as rt
    r = rt.Runtime()
    r.register("lvrf", engine.Engine(spec, slots=256),
               retune=rt.RetunePolicy(threshold=1.5))
    r.register("lm", rt.LMEngine(cfg, params, slots=8, max_len=160))
    with r:
        rid = r.submit("lvrf", row_vec)
        tid = r.submit("lm", prompt_tokens, max_new_tokens=16)
        print(r.result(rid).result, r.result(tid).result["tokens"])
"""
from repro_torch.runtime.faults import (ChaosEngine, DeadlineExceededError,
                                        EngineDeadError, FaultError,
                                        FaultPlan, InjectedFault, ShedError,
                                        WedgedError, maybe_chaos_wrap)
from repro_torch.runtime.fleet import (AdmissionDecision, BrownoutPolicy,
                                       DegradedResult, FleetController,
                                       FleetPolicy, PriorityClass)
from repro_torch.runtime.lm import LMEngine, LMRequest
from repro_torch.runtime.protocol import (Steppable, step_cost_seconds,
                                          supports_cancel,
                                          supports_health_check,
                                          supports_preempt, supports_recover,
                                          supports_resize)
from repro_torch.runtime.runtime import FailurePolicy, RetunePolicy, Runtime
from repro_torch.runtime.telemetry import (ArrivalEstimator, EngineTelemetry,
                                           should_retune)

__all__ = [
    "AdmissionDecision", "ArrivalEstimator", "BrownoutPolicy", "ChaosEngine",
    "DeadlineExceededError", "DegradedResult", "EngineDeadError",
    "EngineTelemetry", "FailurePolicy", "FaultError", "FaultPlan",
    "FleetController", "FleetPolicy", "InjectedFault", "LMEngine",
    "LMRequest", "PriorityClass", "RetunePolicy", "Runtime", "ShedError",
    "Steppable", "WedgedError", "maybe_chaos_wrap", "should_retune",
    "step_cost_seconds", "supports_cancel", "supports_health_check",
    "supports_preempt", "supports_recover", "supports_resize",
]
