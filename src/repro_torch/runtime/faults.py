"""Fault model: structured serving errors + a deterministic chaos harness.

The port of the reference package's ``runtime/faults.py``.

Two halves, one contract.  The **error hierarchy** is how the supervised
runtime (:mod:`repro_torch.runtime.runtime`) reports every non-result outcome:
a future that cannot produce an answer resolves to a :class:`FaultError`
subclass carrying the failing engine and fault ``kind`` — never a bare hang.
The **chaos harness** is how that contract is exercised: :class:`ChaosEngine`
wraps any :class:`repro_torch.runtime.protocol.Steppable` and injects the
fault classes the characterization papers name for heterogeneous neurosymbolic
serving (a wedged kernel class, a poisoned request, silently corrupted state)
on a schedule that is a pure function of a :class:`FaultPlan` seed — so a
chaos test failure replays exactly.

Determinism contract: injection decisions are drawn from three independent
``numpy`` ``default_rng`` streams (steps / submits / corruption-row choice),
one draw per call of that type, so the k-th ``step()`` of a plan makes the
same decision regardless of how submits interleave with steps.  At all-zero
rates the wrapper is transparent: it forwards every protocol call and — via
``__getattr__`` — every attribute (``slots``, ``state``, ``resize``,
``recover``, ...) to the wrapped engine, which is what lets the whole
runtime suite run once with wrapping force-enabled (``REPRO_CHAOS_WRAP=1``,
see :func:`maybe_chaos_wrap`) to prove the harness itself perturbs nothing.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from repro_torch import obs as obs_mod

__all__ = [
    "ChaosEngine", "DeadlineExceededError", "EngineDeadError", "FaultError",
    "FaultPlan", "InjectedFault", "ShedError", "WedgedError",
    "maybe_chaos_wrap",
]


# ---------------------------------------------------------------------------
# Structured serving faults
# ---------------------------------------------------------------------------

class FaultError(RuntimeError):
    """Base of every structured serving fault the runtime resolves a future
    with.  ``kind`` names the fault class (stable strings — telemetry and
    tests key on them), ``engine`` the engine it happened on (None for
    runtime-global faults)."""

    kind = "fault"

    def __init__(self, message: str, *, engine: str | None = None):
        super().__init__(message)
        self.engine = engine


class InjectedFault(FaultError):
    """A fault the chaos harness injected on purpose (never raised by real
    serving code — seeing one outside a chaos run is itself a bug)."""

    kind = "injected"


class DeadlineExceededError(FaultError):
    """The request's ``submit(deadline_s=)`` budget elapsed before a result;
    its slot was reclaimed through the preemption-safe cancel path."""

    kind = "deadline"


class ShedError(FaultError):
    """Admission control rejected the request: the runtime's bounded pending
    queue was full (fail-fast overload shedding, raised from ``submit``)."""

    kind = "shed"


class EngineDeadError(FaultError):
    """The engine exhausted its :class:`~repro.runtime.runtime.FailurePolicy`
    restart budget (or cannot recover) and was removed from service; the
    request will never be served by it."""

    kind = "dead"


class WedgedError(FaultError):
    """A step wedged past the heartbeat watchdog's timeout.  The stepper
    thread is stuck inside the engine, so the engine is declared dead and a
    replacement stepper takes over the healthy engines."""

    kind = "wedged"


# ---------------------------------------------------------------------------
# Deterministic fault injection
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded injection schedule for one :class:`ChaosEngine`.

    Rates are per-call Bernoulli probabilities evaluated on independent
    deterministic streams; ``max_faults`` caps the TOTAL injections (all
    classes combined) so a finite run always drains — the shape chaos tests
    want: a burst of faults, then a verifiable recovery.
    """

    seed: int = 0
    step_error_rate: float = 0.0  # step() raises InjectedFault
    hang_rate: float = 0.0  # step() sleeps hang_s first (slow/wedged step)
    hang_s: float = 0.0
    submit_reject_rate: float = 0.0  # submit() raises InjectedFault
    corrupt_rate: float = 0.0  # a live resonator row turns non-finite
    # submit storm: one caller submit fans out into storm_burst extra
    # phantom copies on the inner engine — a stampeding-client / retry-loop
    # overload that inflates the backlog the fleet's admission control
    # prices (the phantoms complete engine-side but belong to no future)
    storm_rate: float = 0.0
    storm_burst: int = 0
    max_faults: int | None = None

    def __post_init__(self):
        for f in ("step_error_rate", "hang_rate", "submit_reject_rate",
                  "corrupt_rate", "storm_rate"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f} must be a probability, got {v}")
        if self.hang_rate > 0 and self.hang_s <= 0:
            raise ValueError("hang_rate > 0 needs a positive hang_s")
        if self.storm_rate > 0 and self.storm_burst < 1:
            raise ValueError("storm_rate > 0 needs storm_burst >= 1")


class ChaosEngine:
    """Fault-injecting ``Steppable`` wrapper around any engine.

    Satisfies the protocol structurally and forwards everything else to the
    wrapped engine, so the runtime (and its re-tuner, supervisor, and
    telemetry) cannot tell a wrapped engine from a bare one until a fault
    fires.  Injection sites:

      * **submit rejection** — ``submit()`` raises :class:`InjectedFault`
        before the inner engine sees the payload (a poisoned request);
      * **submit storm** — ``submit()`` fans the payload into
        ``storm_burst`` extra phantom submissions on the inner engine (a
        stampeding retry loop): backlog inflates, which is exactly the
        signal fleet admission control sheds on;
      * **step exception** — ``step()`` raises before the inner step runs
        (a crashed kernel; inner state is untouched, exactly like a device
        error surfacing through a kernel launch);
      * **hung/slow step** — ``step()`` sleeps ``hang_s`` first.  Below the
        runtime's watchdog timeout this models a slow step (served late but
        correctly); above it, a wedged one;
      * **state corruption** — after a successful inner step, one live row
        of the engine's resonator ``state.est`` is set to NaN (silent
        corruption the cadenced health check must catch; skipped for
        engines without resonator state, e.g. the LM adapter).

    ``injected`` counts fire-events per class; ``stats()`` reports them
    under ``"chaos"`` next to the inner engine's counters.
    """

    def __init__(self, engine, plan: FaultPlan, *, sleep=time.sleep):
        self.inner = engine
        self.plan = plan
        self._sleep = sleep
        self._step_rng = np.random.default_rng([plan.seed, 0])
        self._submit_rng = np.random.default_rng([plan.seed, 1])
        self._row_rng = np.random.default_rng([plan.seed, 2])
        self.injected = {"step_error": 0, "hang": 0, "submit_reject": 0,
                         "corrupt": 0, "storm": 0}

    # -- injection machinery ----------------------------------------------

    def _budget_left(self) -> bool:
        return (self.plan.max_faults is None
                or sum(self.injected.values()) < self.plan.max_faults)

    def _fire(self, rng, rate: float, kind: str) -> bool:
        """One deterministic draw; counts and reports whether `kind` fires.

        The draw happens whenever the rate is non-zero — even when the fault
        budget is exhausted — so stream positions (and hence the schedule of
        LATER calls) never depend on ``max_faults``.
        """
        if rate <= 0.0:
            return False
        hit = bool(rng.random() < rate)
        if hit and self._budget_left():
            self.injected[kind] += 1
            return True
        return False

    def _corrupt_state(self) -> bool:
        """Poke NaN into one live resonator row of the wrapped engine."""
        state = getattr(self.inner, "state", None)
        owner = getattr(self.inner, "_owner", None)
        if state is None or owner is None or not hasattr(state, "est"):
            return False
        live = [s for s, o in enumerate(owner) if o is not None]
        if not live:
            return False
        row = live[int(self._row_rng.integers(len(live)))]
        # a functional update, as the reference's: a clone on the state's
        # device, never a write into a tensor that resize() or a refill
        # may still hold
        est = state.est.clone()
        est[row] = float("nan")
        self.inner.state = state._replace(est=est)
        return True

    # -- Steppable protocol ------------------------------------------------

    def _mark(self, kind: str) -> None:
        """Stamp an injection instant on the wrapped engine's obs track so a
        chaos trace shows the cause next to the fault-cycle it triggers (the
        recorder rides on the inner engine — the harness itself holds no
        observability state)."""
        obs = getattr(self.inner, "obs", obs_mod.NULL)
        if obs.enabled:
            obs.instant("chaos-inject",
                        track=getattr(self.inner, "obs_track", "chaos"),
                        cat="chaos", args={"kind": kind})
            obs.count("chaos_injected", 1, kind=kind)

    def submit(self, payload, **kwargs) -> int:
        # fixed draw order (reject, then storm) on the submit stream, so
        # the k-th submit's decisions stay a pure function of (seed, k)
        if self._fire(self._submit_rng, self.plan.submit_reject_rate,
                      "submit_reject"):
            self._mark("submit_reject")
            raise InjectedFault("injected submit rejection")
        if self._fire(self._submit_rng, self.plan.storm_rate, "storm"):
            # phantom duplicates hit the inner engine directly: they burn
            # slots and inflate in_flight (the overload signal admission
            # control reads) but no future ever owns their ids — the
            # runtime's finish loop drops unknown local ids on the floor
            self._mark("storm")
            for _ in range(self.plan.storm_burst):
                self.inner.submit(payload, **kwargs)
        return self.inner.submit(payload, **kwargs)

    def step(self) -> list:
        # One draw per injection class per step, fixed order, so the k-th
        # step's decisions are a pure function of (seed, k).
        hang = self._fire(self._step_rng, self.plan.hang_rate, "hang")
        err = self._fire(self._step_rng, self.plan.step_error_rate,
                         "step_error")
        corrupt = self.plan.corrupt_rate > 0 and \
            bool(self._step_rng.random() < self.plan.corrupt_rate)
        if hang:
            self._mark("hang")
            self._sleep(self.plan.hang_s)
        if err:
            self._mark("step_error")
            raise InjectedFault("injected step failure")
        out = self.inner.step()
        if corrupt and self._budget_left() and self._corrupt_state():
            self.injected["corrupt"] += 1
            self._mark("corrupt")
        return out

    def drain(self, *args, **kwargs) -> list:
        return self.inner.drain(*args, **kwargs)

    @property
    def in_flight(self) -> int:
        return self.inner.in_flight

    def stats(self) -> dict:
        return {**self.inner.stats(), "chaos": dict(self.injected)}

    def snapshot(self, reset: bool = False) -> dict:
        """Mirror the inner engine's non-destructive snapshot seam (falling
        back to its ``stats()``), keeping the chaos counters attached —
        ``Runtime.stats`` reads through this."""
        inner = self.inner.snapshot(reset) \
            if hasattr(self.inner, "snapshot") else self.inner.stats()
        return {**inner, "chaos": dict(self.injected)}

    # Everything else — resize/recover/cancel/health_check/step_cost_s,
    # slots, state, sweeps_total, completed, ... — forwards untouched, so
    # optional-capability probes (supports_resize &c.) see exactly the
    # wrapped engine's surface.
    def __getattr__(self, name):
        return getattr(self.inner, name)


def maybe_chaos_wrap(engine, *, env: str = "REPRO_CHAOS_WRAP"):
    """Wrap `engine` in a zero-rate :class:`ChaosEngine` when the env var is
    set (the transparency run: the full runtime suite must pass bit-for-bit
    with the harness interposed at fault-rate zero).  Already-wrapped
    engines pass through."""
    if not os.environ.get(env) or isinstance(engine, ChaosEngine):
        return engine
    return ChaosEngine(engine, FaultPlan(seed=0))
