"""Per-engine online telemetry: EWMA arrival rates + rolling counters.

The port of the reference package's ``runtime/telemetry.py``.

The workload-aware half of the runtime ("the arrival-rate
*estimator* (EWMA over submit timestamps feeding re-tuning)").  Everything
here is plain host arithmetic — observations are wall-clock submit/complete
timestamps, never device values — so the stepper thread can update it at
request granularity for free.

Clocks are injectable (every method takes an explicit ``now``) so the
convergence and drift-trigger behavior is exactly testable with synthetic
arrival processes.
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.engine.engine import LAT_WINDOW_CAP, rolling_latency_ms


class ArrivalEstimator:
    """EWMA arrival-rate estimator over submit timestamps.

    Tracks an exponentially-weighted mean of the inter-arrival gaps and
    reports ``rate() = 1 / ewma_gap``.  The gap mean — not the naive EWMA of
    instantaneous ``1/gap`` — is the right estimand for bursty traffic: for
    a Poisson process the gaps are exponential with mean ``1/lambda``, so
    the estimate converges to the true rate, while ``E[1/gap]`` diverges.

    Warmup averages the first ``1/alpha`` gaps uniformly (bias-corrected
    EWMA) so early estimates aren't anchored to the first gap.  When asked
    for the rate mid-silence, the still-open gap since the last arrival is
    folded in once it exceeds the current mean — an idle engine's estimate
    decays toward zero instead of freezing at its last busy value.
    """

    def __init__(self, alpha: float = 0.1):
        if not 0 < alpha <= 1:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self._gap: float | None = None  # EWMA of inter-arrival gaps, seconds
        self._last: float | None = None
        self.observed = 0

    def observe(self, now: float | None = None, n: int = 1) -> None:
        """Record ``n`` arrivals at time ``now`` (defaults to monotonic)."""
        now = time.monotonic() if now is None else float(now)
        if self._last is not None and now >= self._last and self.observed > 0:
            # n simultaneous arrivals = n gaps summing to the elapsed time
            for _ in range(max(1, int(n))):
                gap = max((now - self._last) / max(1, int(n)), 1e-9)
                if self._gap is None:
                    self._gap = gap
                else:
                    a = max(self.alpha, 1.0 / (self.observed + 1))  # warmup
                    self._gap = (1 - a) * self._gap + a * gap
                self.observed += 1
        else:
            self.observed += max(1, int(n))
        self._last = now

    def rate(self, now: float | None = None) -> float:
        """Current estimate in arrivals/second (0.0 until two arrivals)."""
        if self._gap is None:
            return 0.0
        gap = self._gap
        if now is not None or self._last is not None:
            now = time.monotonic() if now is None else float(now)
            open_gap = now - (self._last or now)
            if open_gap > gap:  # silence longer than the mean: decay
                gap = (1 - self.alpha) * gap + self.alpha * open_gap
        return 1.0 / gap


def should_retune(rate: float, tuned_rate: float | None,
                  threshold: float) -> bool:
    """Drift trigger: has the estimate moved past ``threshold`` (a ratio,
    > 1) in EITHER direction since the last tune?

    Exactly the predicate the re-tuner uses: ``False`` until a baseline
    exists or while ``max(r, 1/r) < threshold``, ``True`` once the ratio
    reaches it (rate doubled OR halved at threshold 2.0).
    """
    if threshold <= 1.0:
        raise ValueError(f"threshold must be > 1, got {threshold}")
    if tuned_rate is None or tuned_rate <= 0 or rate <= 0:
        return False
    r = rate / tuned_rate
    return max(r, 1.0 / r) >= threshold


@dataclasses.dataclass
class EngineTelemetry:
    """Rolling per-engine counters the runtime updates at request/step
    granularity (all host-side)."""

    arrivals: ArrivalEstimator = dataclasses.field(
        default_factory=ArrivalEstimator)
    submitted: int = 0
    completed: int = 0
    steps: int = 0
    retunes: int = 0
    # fault-tolerance counters (the supervisor updates these):
    faults: int = 0  # quarantine entries (step exceptions + failed probes)
    recoveries: int = 0  # successful rebuild + replay cycles
    replayed: int = 0  # in-flight rows re-queued across those recoveries
    deadline_misses: int = 0  # futures failed by submit(deadline_s=) expiry
    # submissions refused before service — the bounded pending queue,
    # fleet admission control, and rejections at ingest (dead engine,
    # chaos submit faults) all land here:
    shed: int = 0
    preempted: int = 0  # live rows preempted + re-queued by fleet control
    degraded: int = 0  # submissions admitted with brownout-trimmed budgets
    tuned_rate: float | None = None  # arrival estimate at the last (re)tune
    queue_depth: int = 0  # latest observed engine.in_flight
    utilization: float = 0.0  # EWMA of busy-slot fraction per step
    util_alpha: float = 0.2
    # EWMA of measured WALL-CLOCK seconds per step unit (one resonator sweep
    # for factorizer engines) — the cost basis online re-tunes prefer over
    # the analytic model, whose rates are modeled device-seconds and not
    # commensurable with the wall-clock arrival EWMA (see
    # repro.engine.sharding.autotune.retune_slots).
    _step_unit_s: float | None = None
    step_alpha: float = 0.2
    # adSCH's modeled device-seconds per step unit for the engine's CURRENT
    # program (refreshed every busy step — resizes change it); the
    # denominator of plan_drift_ratio.
    modeled_unit_s: float | None = None
    _lat_window: list = dataclasses.field(default_factory=list)
    _lat_sum: float = 0.0

    def on_submit(self, now: float | None = None, n: int = 1) -> None:
        self.submitted += n
        self.arrivals.observe(now, n=n)

    def on_step(self, busy_fraction: float, queue_depth: int, *,
                step_s: float | None = None, units: int = 0,
                modeled_unit_s: float | None = None) -> None:
        """``step_s``/``units``: measured wall seconds of this engine step
        and the step units (sweeps) it executed — skipped for idle steps.
        ``modeled_unit_s``: adSCH's modeled seconds for one such unit, the
        planner-drift denominator."""
        self.steps += 1
        self.queue_depth = queue_depth
        self.utilization += self.util_alpha * (
            float(busy_fraction) - self.utilization)
        if step_s is not None and units > 0:
            per = float(step_s) / units
            self._step_unit_s = per if self._step_unit_s is None else \
                (1 - self.step_alpha) * self._step_unit_s + \
                self.step_alpha * per
        if modeled_unit_s is not None:
            self.modeled_unit_s = float(modeled_unit_s)

    def step_unit_s(self) -> float | None:
        """Measured wall seconds per step unit (None until a busy step)."""
        return self._step_unit_s

    def plan_drift_ratio(self) -> float | None:
        """Measured / modeled seconds per step unit — how far reality has
        drifted from adSCH's plan for this engine (>1: the plan is
        optimistic, e.g. interpret-mode kernels or host overhead; <1:
        pessimistic).  None until both sides exist.  This is the
        unit-mismatch lesson made continuously observable: the re-tuner
        already refuses to mix modeled and measured cost bases, and this
        ratio is the standing measurement of how wrong mixing them would
        be."""
        if self._step_unit_s is None or not self.modeled_unit_s:
            return None
        return self._step_unit_s / self.modeled_unit_s

    def on_complete(self, latency_s: float) -> None:
        self.completed += 1
        self._lat_window.append(float(latency_s))
        del self._lat_window[:-LAT_WINDOW_CAP]
        self._lat_sum += float(latency_s)

    def mark_tuned(self, rate: float) -> None:
        self.tuned_rate = rate

    def drift_exceeded(self, threshold: float,
                       now: float | None = None) -> bool:
        return should_retune(self.arrivals.rate(now), self.tuned_rate,
                             threshold)

    def snapshot(self, now: float | None = None, *,
                 reset: bool = False) -> dict:
        """Counters + ROLLING latency percentiles (same percentile
        definition as ``Engine.snapshot`` — the two are reported side by
        side); all-time totals keep accumulating.  Non-destructive by
        default (the window is capped at ``LAT_WINDOW_CAP``, so undrained
        readers stay bounded); ``reset=True`` drains the window for
        interval-over-interval reporting."""
        lats = self._lat_window
        if reset:
            self._lat_window = []
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "steps": self.steps,
            "retunes": self.retunes,
            "faults": self.faults,
            "recoveries": self.recoveries,
            "replayed": self.replayed,
            "deadline_misses": self.deadline_misses,
            "shed": self.shed,
            "preempted": self.preempted,
            "degraded": self.degraded,
            "queue_depth": self.queue_depth,
            "utilization": round(self.utilization, 4),
            "arrival_rate_rps": self.arrivals.rate(now),
            "tuned_rate_rps": self.tuned_rate,
            "step_unit_s": self._step_unit_s,
            "modeled_unit_s": self.modeled_unit_s,
            "plan_drift_ratio": self.plan_drift_ratio(),
            "window_completed": len(lats),
            **rolling_latency_ms(lats),
            "latency_mean_all_ms": (self._lat_sum / self.completed * 1e3
                                    if self.completed else None),
        }
