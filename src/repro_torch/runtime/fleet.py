"""Fleet controller: priority admission, bit-safe preemption, global slot
budget, and graceful brownout.

The port of the reference package's ``runtime/fleet.py``.

The per-engine machinery this layers on already exists: measured
``step_unit_s`` EWMAs (``runtime.telemetry``), the ``resize`` warm handoff,
and the re-queue-from-pinned-key replay contract that makes preemption
bit-safe (``Engine.preempt`` / ``LMEngine.preempt``).  What was missing is
the *fleet* view — until now overload meant a blunt ``max_pending``
fail-fast with no notion of who matters, and every engine hoarded its own
autotuned slots.  The :class:`FleetController` closes that gap with four
policies, every decision narrated as supervisor-track obs events:

1. **Priority-class admission** — :meth:`admit` estimates the queue wait a
   new request would see (measured seconds-per-step-unit x backlog /
   slots) and sheds or degrades *by class* instead of tail-dropping
   everyone.
2. **Bit-safe preemption** — :meth:`control` preempts low-priority live
   rows when higher-priority work is queued behind them; the preempted
   trajectory replays bit-equal from its pinned key (the same contract as
   ``resize`` shrink and ``recover``).
3. **Global slot budget** — a cadenced re-tuner moves a fixed slot budget
   *between* engines through the ``resize`` warm handoff when pressure (or
   per-class SLO attainment from ``Runtime.stats()["slo"]``) diverges.
4. **Brownout** — sustained overload flips a fleet-wide degraded mode:
   best-effort admissions get trimmed budgets (resonator ``max_iters``,
   LM ``max_new_tokens``) and their results carry a structured
   :class:`DegradedResult` marker instead of being dropped.

The controller is deliberately host-side arithmetic on injected
callables — no tensors, no threads of its own, every method takes an explicit
``now`` — so the SAME controller instance drives both the threaded
``Runtime`` (wall clock, telemetry EWMAs) and a deterministic
single-threaded harness (virtual clock, modeled unit costs).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch import obs as obs_mod
from repro_torch.runtime.protocol import (step_cost_seconds, supports_preempt,
                                    supports_resize)

__all__ = [
    "AdmissionDecision", "BrownoutPolicy", "DegradedResult",
    "FleetController", "FleetPolicy", "PriorityClass",
]


@dataclasses.dataclass(frozen=True)
class PriorityClass:
    """Admission/preemption policy for one request class.

    ``priority`` is the engine queue order (lower serves first).  The two
    wait thresholds are compared against the admission-time queue-wait
    estimate: past ``degrade_wait_s`` the class is admitted with trimmed
    budgets, past ``admit_wait_s`` it is shed outright.  ``None`` disables
    a threshold (always admit / never degrade on wait alone).
    """

    name: str
    priority: int = 1
    admit_wait_s: float | None = None
    degrade_wait_s: float | None = None
    preemptible: bool = False  # live rows may yield to lower `priority` work
    degradable: bool = False  # brownout / degrade_wait_s may trim budgets

    def __post_init__(self):
        for f in ("admit_wait_s", "degrade_wait_s"):
            v = getattr(self, f)
            if v is not None and v < 0:
                raise ValueError(f"{f} must be >= 0, got {v}")


@dataclasses.dataclass(frozen=True)
class BrownoutPolicy:
    """Fleet-wide degraded mode under *sustained* overload.

    Entry/exit are streak-debounced: the max per-engine wait estimate must
    exceed ``enter_wait_s`` for ``enter_ticks`` consecutive control ticks
    to enter, and fall below ``exit_wait_s`` (default ``enter_wait_s / 2``
    — hysteresis) for ``exit_ticks`` to leave.  While browned out, every
    degradable-class admission is trimmed: resonator requests to
    ``max_iters_factor`` of their engine's configured budget, LM requests
    to ``lm_token_cap`` new tokens.
    """

    enter_wait_s: float
    exit_wait_s: float | None = None
    enter_ticks: int = 2
    exit_ticks: int = 2
    max_iters_factor: float = 0.25
    lm_token_cap: int = 8

    def __post_init__(self):
        if self.enter_wait_s <= 0:
            raise ValueError(
                f"enter_wait_s must be > 0, got {self.enter_wait_s}")
        if self.exit_wait_s is not None and \
                self.exit_wait_s > self.enter_wait_s:
            raise ValueError("exit_wait_s must be <= enter_wait_s "
                             "(hysteresis), got "
                             f"{self.exit_wait_s} > {self.enter_wait_s}")
        if not 0 < self.max_iters_factor <= 1:
            raise ValueError(f"max_iters_factor must be in (0, 1], got "
                             f"{self.max_iters_factor}")
        if self.lm_token_cap < 1:
            raise ValueError(
                f"lm_token_cap must be >= 1, got {self.lm_token_cap}")


@dataclasses.dataclass(frozen=True)
class FleetPolicy:
    """Everything the controller needs, declared up front.

    ``classes`` name the priority classes; requests whose class is not
    listed resolve to ``default_class`` (or a neutral always-admit class).
    ``control_every`` thins the per-step control tick; ``rebalance_every``
    (in control ticks) cadences the slot re-tuner, which moves
    ``rebalance_step`` slots from the least- to the most-pressured engine
    whenever pressure diverges by more than ``rebalance_ratio`` x (or the
    receiver's class attainment fell below ``attainment_floor``), never
    shrinking a donor below ``min_slots``.
    """

    classes: tuple = ()
    default_class: str | None = None
    control_every: int = 1
    preempt: bool = True
    max_preempt_per_tick: int = 4
    rebalance_every: int = 16
    rebalance_step: int = 1
    rebalance_ratio: float = 2.0
    min_slots: int = 1
    attainment_floor: float = 0.9
    brownout: BrownoutPolicy | None = None

    def __post_init__(self):
        names = [pc.name for pc in self.classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate class names in {names}")
        if self.default_class is not None and \
                self.default_class not in names:
            raise ValueError(
                f"default_class {self.default_class!r} not in {names}")
        if self.control_every < 1:
            raise ValueError(
                f"control_every must be >= 1, got {self.control_every}")
        if self.rebalance_every < 0:
            raise ValueError(f"rebalance_every must be >= 0, got "
                             f"{self.rebalance_every}")
        if self.rebalance_step < 1 or self.min_slots < 1:
            raise ValueError("rebalance_step and min_slots must be >= 1")
        if self.rebalance_ratio < 1.0:
            raise ValueError(
                f"rebalance_ratio must be >= 1, got {self.rebalance_ratio}")


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    """One admission verdict: ``admit``, ``degrade`` (admit with ``trims``
    budget caps), or ``shed``.  ``apply`` merges the trims into submit
    kwargs with min-semantics, so an explicit tighter caller budget is
    never loosened."""

    action: str  # "admit" | "degrade" | "shed"
    class_: str
    priority: int
    est_wait_s: float
    reason: str = ""
    mode: str = ""  # degrade flavor: "overload" | "brownout"
    trims: dict = dataclasses.field(default_factory=dict)

    def apply(self, kwargs: dict) -> dict:
        out = dict(kwargs)
        for k, v in self.trims.items():
            cur = out.get(k)
            out[k] = min(cur, v) if isinstance(cur, (int, float)) else v
        return out


@dataclasses.dataclass
class DegradedResult:
    """Structured marker wrapping a brownout-trimmed request's result: the
    caller got an answer, but a degraded one (fewer resonator iterations /
    shorter LM generation), and can tell — instead of silently receiving a
    worse result or an unstructured error."""

    result: Any
    class_: str
    mode: str  # "overload" (per-class wait) | "brownout" (fleet-wide)
    trims: dict


class FleetController:
    """Fleet-wide admission / preemption / rebalance / brownout policy.

    Construction takes a :class:`FleetPolicy`; :meth:`bind` injects the
    environment (engine map plus optional measurement callables).  The
    runtime binds its live telemetry, the structural harness binds its
    virtual clock — the decision logic is identical.

    Not thread-safe by itself: the Runtime serializes ``control`` onto its
    stepper thread and ``admit`` onto callers holding no engine state
    (admission reads engine backlogs racily — a stale-by-one estimate only
    shifts a threshold comparison, never correctness).
    """

    def __init__(self, policy: FleetPolicy, *, obs=None, clock=None):
        self.policy = policy
        self.classes = {pc.name: pc for pc in policy.classes}
        self.obs = obs if obs is not None else obs_mod.NULL
        self._clock = clock if clock is not None else self.obs.clock
        self._engines: dict = {}
        self._unit_s_fn: Callable | None = None
        self._backlog_fn: Callable | None = None
        self._class_of: Callable | None = None
        self._slo_fn: Callable | None = None
        self._serving_fn: Callable | None = None
        self._telemetry: dict | None = None
        # decision counters (per class name), structural-gate material:
        self.admitted: dict[str, int] = {}
        self.shed: dict[str, int] = {}
        self.degraded: dict[str, int] = {}
        self.preempted: dict[str, int] = {}  # rows, not requests
        self.rebalances = 0
        self.brownouts = 0  # brownout ENTRIES
        self.slot_moves: dict[str, int] = {}  # engine -> net slots moved
        self.mode = "normal"  # | "brownout"
        self._steps = 0
        self._ticks = 0
        self._hot = 0  # consecutive over-threshold ticks (brownout entry)
        self._cool = 0  # consecutive under-threshold ticks (brownout exit)
        self._brown_sid = None  # open brownout span id
        self._class_engine: dict[str, str] = {}  # class -> last engine hit

    # -- wiring ------------------------------------------------------------

    def bind(self, engines: dict, *, unit_s_fn=None, backlog_fn=None,
             class_of=None, slo_fn=None, serving_fn=None, telemetry=None,
             obs=None, clock=None) -> "FleetController":
        """Inject the environment.  ``engines`` is held by reference (the
        Runtime registers engines after construction).  Optional callables:

        - ``unit_s_fn(name) -> float | None`` — measured seconds per step
          unit (telemetry EWMA / virtual-clock unit); ``None`` falls back
          to the adSCH-modeled ``step_cost_s``.
        - ``backlog_fn(name) -> int`` — rows waiting or in service
          (default: ``engine.in_flight``), plus any staged-but-uningested
          submissions the caller knows about.
        - ``class_of(name, local_id) -> str | None`` — request class of a
          live engine-local id, for preemption victim filtering (unknown
          classes are treated as preemptible).
        - ``slo_fn() -> dict`` — per-class SLO snapshot
          (``SLOTracker.snapshot`` schema) steering the rebalancer.
        - ``serving_fn(name) -> bool`` — False skips quarantined/dead
          engines.
        - ``telemetry`` — ``{name: EngineTelemetry}`` for preempt counters.
        """
        self._engines = engines
        self._unit_s_fn = unit_s_fn
        self._backlog_fn = backlog_fn
        self._class_of = class_of
        self._slo_fn = slo_fn
        self._serving_fn = serving_fn
        self._telemetry = telemetry
        if obs is not None:
            self.obs = obs
        if clock is not None:
            self._clock = clock
        return self

    def _now(self, now) -> float:
        return float(now) if now is not None else self._clock()

    def _serving(self, name: str) -> bool:
        return self._serving_fn is None or bool(self._serving_fn(name))

    @staticmethod
    def _bump(table: dict, key: str, n: int = 1) -> None:
        table[key] = table.get(key, 0) + n

    def class_spec(self, class_: str) -> PriorityClass:
        """Resolve a class name to its policy (falling back to
        ``default_class``, then to a neutral always-admit class)."""
        pc = self.classes.get(class_)
        if pc is None and self.policy.default_class is not None:
            pc = self.classes[self.policy.default_class]
        return pc if pc is not None else PriorityClass(class_)

    # -- admission ---------------------------------------------------------

    def est_wait_s(self, name: str) -> float:
        """Queue-wait estimate for a new arrival on engine ``name``:
        measured seconds per step unit x units per step x backlog rows /
        slots — i.e. "backlog/slots steps at the measured step cost".
        Each queued occupant is priced at ~one step of service, so this is
        a *pressure signal* (a monotone lower bound), not a completion
        forecast; thresholds are calibrated against it, not against true
        latency."""
        eng = self._engines.get(name)
        if eng is None:
            return 0.0
        backlog = int(self._backlog_fn(name)) if self._backlog_fn \
            else int(getattr(eng, "in_flight", 0))
        if backlog <= 0:
            return 0.0
        slots = max(1, int(getattr(eng, "slots", 1)))
        units = int(getattr(eng, "sweeps_per_step", 0)
                    or getattr(eng, "decode_per_step", 0) or 1)
        unit_s = self._unit_s_fn(name) if self._unit_s_fn else None
        if unit_s is None:
            unit_s = step_cost_seconds(eng) / units
        return float(unit_s) * units * backlog / slots

    def admit(self, engine: str, class_: str, *, priority=None,
              now=None) -> AdmissionDecision:
        """Admission verdict for one submission, counted and narrated.
        ``priority`` overrides the class's queue priority when given."""
        now = self._now(now)
        spec = self.class_spec(class_)
        prio = spec.priority if priority is None else int(priority)
        wait = self.est_wait_s(engine)
        self._class_engine[class_] = engine
        action, reason, mode, trims = "admit", "", "", {}
        if spec.admit_wait_s is not None and wait > spec.admit_wait_s:
            action = "shed"
            reason = (f"est wait {wait:.3g}s > admit_wait_s "
                      f"{spec.admit_wait_s:.3g}s")
        elif spec.degradable and self.mode == "brownout":
            action, mode = "degrade", "brownout"
            trims = self._trims_for(engine)
            reason = "fleet brownout active"
        elif spec.degradable and spec.degrade_wait_s is not None \
                and wait > spec.degrade_wait_s:
            action, mode = "degrade", "overload"
            trims = self._trims_for(engine)
            reason = (f"est wait {wait:.3g}s > degrade_wait_s "
                      f"{spec.degrade_wait_s:.3g}s")
        table = {"admit": self.admitted, "shed": self.shed,
                 "degrade": self.degraded}[action]
        self._bump(table, class_)
        args = {"engine": engine, "class": class_, "action": action,
                "priority": prio, "est_wait_s": round(wait, 6)}
        if mode:
            args["mode"] = mode
            args["trims"] = dict(trims)
        self.obs.instant("admission", track="supervisor", cat="fleet",
                         args=args)
        self.obs.count("fleet_admission", 1, **{"class": class_,
                                                "action": action})
        return AdmissionDecision(action, class_, prio, wait, reason=reason,
                                 mode=mode, trims=trims)

    def _trims_for(self, name: str) -> dict:
        """Budget caps for a degraded admission on engine ``name``: LM
        engines get a token cap, factorizer engines an iteration cap at a
        fraction of their configured ``max_iters``."""
        eng = self._engines.get(name)
        bp = self.policy.brownout
        if getattr(eng, "engine_kind", "") == "lm":
            return {"max_new_tokens": bp.lm_token_cap if bp else 8}
        factor = bp.max_iters_factor if bp else 0.25
        cfg = getattr(getattr(eng, "spec", None), "cfg", None)
        max_it = getattr(cfg, "max_iters", None)
        if max_it:
            return {"max_iters": max(1, int(max_it * factor))}
        return {}

    # -- control loop ------------------------------------------------------

    def control(self, now=None) -> None:
        """One control tick — the runtime calls this after every engine
        step (the structural harness, on its virtual clock).  Preemption
        and the brownout state machine run per tick; the slot rebalancer
        at its own slower cadence."""
        self._steps += 1
        if self._steps % self.policy.control_every:
            return
        now = self._now(now)
        self._ticks += 1
        if self.policy.preempt:
            for name in list(self._engines):
                if self._serving(name):
                    self._maybe_preempt(name, now)
        self._update_brownout(now)
        if self.policy.rebalance_every and \
                self._ticks % self.policy.rebalance_every == 0:
            self._maybe_rebalance(now)

    # -- preemption --------------------------------------------------------

    def _maybe_preempt(self, name: str, now: float) -> None:
        """Clear slots for queued higher-priority work: preempt live
        requests of strictly worse priority (worst first, newest first),
        capped at the rows the queued work actually needs beyond free
        slots and at ``max_preempt_per_tick``.  Victims re-queue at their
        own priority, so the preempted rows cannot re-trigger this check —
        the loop is thrash-free by construction."""
        eng = self._engines[name]
        if not supports_preempt(eng):
            return
        live_of = getattr(eng, "live_requests", None)
        queued_of = getattr(eng, "queued_requests", None)
        if live_of is None or queued_of is None:
            return
        queued, live = queued_of(), live_of()
        if not queued or not live:
            return
        best = min(info["priority"] for info in queued.values())
        victims = []
        for rid, info in live.items():
            if info["priority"] <= best:
                continue
            if self._class_of is not None:
                cls = self._class_of(name, rid)
                if cls is not None and not self.class_spec(cls).preemptible:
                    continue
            victims.append((info["priority"], rid))
        if not victims:
            return
        free = max(0, int(getattr(eng, "slots", 0))
                   - sum(info["rows"] for info in live.values()))
        need = sum(info["rows"] for info in queued.values()
                   if info["priority"] == best) - free
        budget = min(self.policy.max_preempt_per_tick, max(0, need))
        victims.sort(key=lambda v: (-v[0], -v[1]))  # worst prio, newest
        rows = 0
        for prio, rid in victims:
            if rows >= budget:
                break
            n = int(eng.preempt(rid))
            if not n:
                continue
            rows += n
            cls = (self._class_of(name, rid)
                   if self._class_of is not None else None) or f"p{prio}"
            self._bump(self.preempted, cls, n)
            if self._telemetry is not None and name in self._telemetry:
                self._telemetry[name].preempted += n
            self.obs.instant(
                "preempt", track="supervisor", cat="fleet",
                args={"engine": name, "request": rid, "class": cls,
                      "rows": n, "for_priority": best})
            self.obs.count("fleet_preempted", n, engine=name)

    # -- brownout ----------------------------------------------------------

    def _update_brownout(self, now: float) -> None:
        bp = self.policy.brownout
        if bp is None:
            return
        wait = max((self.est_wait_s(n) for n in self._engines
                    if self._serving(n)), default=0.0)
        exit_w = bp.exit_wait_s if bp.exit_wait_s is not None \
            else bp.enter_wait_s / 2.0
        if self.mode == "normal":
            self._hot = self._hot + 1 if wait > bp.enter_wait_s else 0
            if self._hot >= bp.enter_ticks:
                self.mode = "brownout"
                self.brownouts += 1
                self._hot = self._cool = 0
                self._brown_sid = self.obs.begin(
                    "brownout", track="supervisor", cat="fleet",
                    args={"est_wait_s": round(wait, 6)})
                self.obs.count("fleet_brownouts", 1)
        else:
            self._cool = self._cool + 1 if wait < exit_w else 0
            if self._cool >= bp.exit_ticks:
                self.mode = "normal"
                self._hot = self._cool = 0
                self.obs.end(self._brown_sid,
                             args={"est_wait_s": round(wait, 6)})
                self._brown_sid = None

    # -- global slot budget ------------------------------------------------

    def _maybe_rebalance(self, now: float) -> None:
        """Move ``rebalance_step`` slots from the least- to the
        most-pressured resizable engine through the warm handoff, keeping
        the fleet total fixed.  An engine serving a class below the
        attainment floor is forced to the front of the receiver line
        regardless of raw pressure."""
        cands = [n for n in self._engines
                 if self._serving(n) and supports_resize(self._engines[n])
                 and getattr(self._engines[n], "slots", None) is not None]
        if len(cands) < 2:
            return
        press = {n: self.est_wait_s(n) for n in cands}
        if self._slo_fn is not None:
            snap = self._slo_fn() or {}
            bump = max(press.values()) + 1.0
            for cls, row in snap.items():
                att = row.get("attainment") if isinstance(row, dict) \
                    else None
                eng = self._class_engine.get(cls)
                if att is not None and eng in press \
                        and att < self.policy.attainment_floor:
                    press[eng] += bump  # decisive: missing SLO wins slots
        recv = max(cands, key=lambda n: press[n])
        donor = min(cands, key=lambda n: press[n])
        if recv == donor:
            return
        if press[recv] <= self.policy.rebalance_ratio * \
                max(press[donor], 1e-12):
            return
        step = self.policy.rebalance_step
        d_eng, r_eng = self._engines[donor], self._engines[recv]
        d_slots, r_slots = int(d_eng.slots), int(r_eng.slots)
        if d_slots - step < self.policy.min_slots:
            return
        sid = self.obs.begin(
            "rebalance", track="supervisor", cat="fleet",
            args={"from": donor, "to": recv, "slots": step,
                  "pressure_from": round(press[donor], 6),
                  "pressure_to": round(press[recv], 6)})
        try:
            d_eng.resize(d_slots - step)
        except Exception as e:  # conservation: nothing moved
            self.obs.end(sid, args={"failed": repr(e)})
            return
        try:
            r_eng.resize(r_slots + step)
        except Exception as e:
            try:  # give the donor its slots back — keep the total fixed
                d_eng.resize(d_slots)
            except Exception:
                pass
            self.obs.end(sid, args={"failed": repr(e)})
            return
        self.rebalances += 1
        self._bump(self.slot_moves, donor, -step)
        self._bump(self.slot_moves, recv, step)
        self.obs.end(sid)
        self.obs.count("fleet_rebalances", 1)

    # -- read side ---------------------------------------------------------

    def snapshot(self) -> dict:
        """Decision counters for ``Runtime.stats()["fleet"]``."""
        return {
            "mode": self.mode,
            "ticks": self._ticks,
            "admitted": dict(self.admitted),
            "shed": dict(self.shed),
            "degraded": dict(self.degraded),
            "preempted_rows": dict(self.preempted),
            "rebalances": self.rebalances,
            "brownouts": self.brownouts,
            "slot_moves": dict(self.slot_moves),
        }

    def structural_counters(self) -> dict:
        """Per-class decision counters shaped like the traffic harness's
        structural dict: one ``class_<name>`` pseudo-engine per class plus
        a ``fleet`` row — deterministic on the structural leg, so
        ``benchmarks/check_regression.py`` gates them at zero drift."""
        out: dict = {}
        names = set(self.admitted) | set(self.shed) | set(self.degraded) \
            | set(self.preempted)
        for cls in sorted(names):
            out[f"class_{cls}"] = {
                "admitted": self.admitted.get(cls, 0),
                "shed": self.shed.get(cls, 0),
                "degraded": self.degraded.get(cls, 0),
                "preempted": self.preempted.get(cls, 0),
            }
        out["fleet"] = {"rebalances": self.rebalances,
                        "brownouts": self.brownouts}
        return out
