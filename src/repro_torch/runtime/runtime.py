"""Runtime: supervised async multi-engine orchestration with re-tuning.

The port of the reference package's ``runtime/runtime.py``.  Every engine
call, and so every kernel launch and CUDA event of a measured re-tune,
happens on the stepper thread, on that thread's current (default) stream.

The production entry point of the system ("async ``submit`` path
for online serving").  One background stepper thread owns every registered
engine; callers submit from any thread and block on per-request futures:

    rt = Runtime()
    rt.register("lvrf", Engine(spec, slots=16), retune=RetunePolicy())
    rt.register("lm", LMEngine(cfg, params))
    with rt:                       # starts/stops the stepper thread
        rid = rt.submit("lvrf", row_vec, deadline_s=0.5)
        req = rt.result(rid, timeout=30)        # blocks on the future

Four mechanisms, one loop:

**Cost-weighted stepping.**  Engines accrue *virtual time*: stepping engine
e advances ``vt[e]`` by its adSCH-modeled step cost divided by its backlog,
and the loop always steps the busy engine with the smallest ``vt``.  Cheap
steps and deep queues both earn more turns — a symbolic engine whose sweep
burst is 100x cheaper than an LM decode burst gets ~100x the steps instead
of alternating 1:1 behind it, and within equal costs the deeper backlog is
served first.

**Telemetry.**  Successful ingest stamps the per-engine EWMA arrival
estimator (:mod:`repro_torch.runtime.telemetry`) with the request's SUBMIT
timestamp — rejected and shed requests never stamp it, so overload cannot
inflate the arrival estimate into bogus re-tunes; every step updates
utilization and queue-depth counters.  ``stats()`` merges engine,
telemetry, and supervision views.

**Online re-tuning.**  When an engine's arrival estimate drifts past its
:class:`RetunePolicy` threshold, the loop re-runs
:func:`repro_torch.engine.sharding.autotune.retune_slots` (the same
``choose_slots`` model that sized the engine offline) and applies the verdict
via the engine's warm-handoff ``resize`` — in-flight rows carry over
bit-exactly, so a re-tune is invisible to request trajectories (asserted in
tests/test_torch_runtime.py).

**Fleet control** (optional, ``Runtime(fleet=FleetPolicy(...))``).  A
:class:`~repro.runtime.fleet.FleetController` adds overload policy on top
of the per-engine machinery: priority-class admission (estimated queue
wait sheds/degrades by class instead of tail-dropping at ``max_pending``),
bit-safe preemption of low-priority live rows, a global slot budget moved
between engines through the ``resize`` warm handoff, and brownout modes
that trim best-effort budgets with a structured
:class:`~repro.runtime.fleet.DegradedResult` marker.  Every decision is
narrated on the supervisor obs track; ``stats()["fleet"]`` exposes the
counters.

**Supervision.**  Failure of one engine must not take down the rest — the
runtime's availability contract is *per-engine*, driven by each engine's
:class:`FailurePolicy`:

  * a ``step()`` exception (or a failed cadenced ``health_check`` — e.g.
    non-finite resonator state) **quarantines that engine only**: it leaves
    the stepping rotation for an exponential-backoff interval while every
    other engine keeps serving;
  * recovery calls the engine's ``recover()`` — rebuild device programs +
    state, replay in-flight requests from their pinned keys (the bit-safe
    re-queue contract ``Engine.resize`` introduced) — so recovered
    trajectories are **bit-equal to a fault-free run**, just later;
  * an engine that exhausts ``max_restarts`` (or has no ``recover()``) is
    **dead**: its outstanding futures fail with
    :class:`~repro.runtime.faults.EngineDeadError` and later submits to it
    fail fast — never a hang;
  * ``submit(deadline_s=)`` arms a per-request deadline: on expiry the
    future fails with :class:`DeadlineExceededError` and the slot is
    reclaimed through the engine's preemption-safe ``cancel``;
  * ``max_pending`` bounds the staging queue — overload sheds new work at
    ``submit`` with :class:`ShedError` instead of queueing unboundedly;
  * a **heartbeat watchdog** thread monitors the in-progress step: a step
    wedged past ``watchdog_s`` marks that engine dead, fails its futures
    with :class:`WedgedError`, and hands the HEALTHY engines to a
    replacement stepper thread (the wedged thread, stuck inside the engine,
    is abandoned; if it ever returns it notices its generation is stale and
    exits without touching anything) — ``drain()`` resolves instead of
    hanging forever behind one stuck kernel class.

The chaos invariant all of this serves (asserted in
tests/test_torch_runtime_faults.py): under any seeded
:class:`~repro.runtime.faults.FaultPlan`, every submitted future resolves —
a result or a structured :class:`~repro.runtime.faults.FaultError` — and
replayed requests are bit-equal to a fault-free run.

Thread-safety contract: engines are single-threaded; ONLY the (current)
stepper thread touches them (submissions are staged in a thread-safe
pending queue and ingested on-thread).  ``Runtime.stats``/``drain``
synchronize through the same lock the stepper holds per iteration.  After
a watchdog takeover the wedged thread still holds the *previous* lock
object forever — the runtime swaps in a fresh lock, so only the dead
engine (which the replacement stepper never touches) stays behind it.
"""
from __future__ import annotations

import dataclasses
import heapq
import threading
import time
import warnings
from collections import deque
from concurrent.futures import Future, TimeoutError as FutureTimeout

from repro_torch import obs as obs_mod
from repro_torch.engine.sharding.autotune import retune_slots
from repro_torch.runtime import faults as flt
from repro_torch.runtime import fleet as flc
from repro_torch.runtime import telemetry as tele
from repro_torch.runtime.protocol import (step_cost_seconds, supports_cancel,
                                    supports_health_check, supports_recover,
                                    supports_resize)

_EVENT_LOG_CAP = 64  # per-engine supervision events kept for diagnosis


@dataclasses.dataclass(frozen=True)
class RetunePolicy:
    """When and how an engine's slot count follows its arrival rate."""

    threshold: float = 1.5  # drift ratio (either direction) that re-tunes
    check_every: int = 4  # steps of THIS engine between drift checks
    baseline_rps: float | None = None  # None: first check sets the baseline
    headroom: float = 1.25  # forwarded to choose_slots
    candidates: tuple | None = None  # None: autotune defaults
    # True: price candidates by timing the actual sweep on the engine's
    # device instead of the analytic model (stalls the stepper for the
    # measurement but reflects the machine that is really serving; see
    # autotune.measure_sweep_seconds)
    use_measured_cost: bool = False


@dataclasses.dataclass(frozen=True)
class FailurePolicy:
    """Per-engine supervision knobs: restart budget, backoff, probe cadence.

    The restart budget is ALL-TIME (not a sliding window): an engine that
    keeps faulting is structurally broken — the paper-scale runtime would
    rather fail its traffic fast than flap forever.
    """

    max_restarts: int = 3  # quarantine/recover cycles before dead
    backoff_initial_s: float = 0.05  # first quarantine interval
    backoff_factor: float = 2.0  # exponential growth per restart
    backoff_max_s: float = 2.0  # interval ceiling
    # engine steps between health_check() corruption probes (0 disables);
    # the probe costs one live-row device->host gather, so the cadence is
    # also the worst-case latency to catch silent state corruption
    health_check_every: int = 64


@dataclasses.dataclass
class _Supervision:
    """Mutable per-engine supervisor record (stepper-thread-owned)."""

    state: str = "serving"  # serving | quarantined | dead
    restarts: int = 0
    until: float = 0.0  # quarantine expiry (runtime clock)
    steps_since_probe: int = 0
    awaiting_completion: bool = False  # recovery happened; next finish logs
    last_error: BaseException | None = None
    events: list = dataclasses.field(default_factory=list)  # (t, tag)
    cycle_sid: int | None = None  # open "fault-cycle" obs span, if tracing

    def log(self, t: float, tag: str) -> None:
        self.events.append((t, tag))
        del self.events[:-_EVENT_LOG_CAP]


class _Takeover(BaseException):
    """Private control flow: this stepper thread's generation went stale
    (watchdog takeover) — unwind without touching shared state."""


class Runtime:
    """Async serving frontend over one or more ``Steppable`` engines."""

    def __init__(self, *, clock=None, idle_sleep_s: float = 1e-3,
                 max_pending: int | None = None,
                 watchdog_s: float | None = 180.0,
                 failure: FailurePolicy | None = None, obs=None, slo=None,
                 fleet=None):
        # Observability: explicit recorder > REPRO_OBS=1 env seam > NULL
        # (free).  register() rebinds default-built engines onto this
        # recorder so the whole stack traces on ONE monotonic clock; the
        # runtime's own clock likewise defaults to the recorder's
        # (obs_mod.DEFAULT_CLOCK = time.monotonic when tracing is off).
        self.obs = obs_mod.maybe_obs(obs)
        self._clock = clock if clock is not None else self.obs.clock
        self._idle_sleep_s = idle_sleep_s
        # admission control: staged-but-not-ingested requests past this bound
        # are shed at submit() (None: unbounded)
        self._max_pending = max_pending
        # heartbeat watchdog: a single engine step wedged past this declares
        # the engine dead and replaces the stepper (None disables).  The
        # default is far above any legitimate step — including a first step
        # that loads CUDA modules or, on a fresh checkout, builds a kernel
        # with nvcc (build the kernels before start() to keep that off the
        # clock) — because a wedged engine is unrecoverable by design.
        self._watchdog_s = watchdog_s
        self._default_failure = failure if failure is not None \
            else FailurePolicy()
        # Per-class SLO attainment (obs/slo.py).  Host arithmetic like
        # telemetry — always on, independent of the recorder, so the
        # zero-overhead obs contract is untouched.  ``slo`` is a ready
        # SLOTracker or a {class: SLOTarget|seconds} target map.
        self.slo = slo if isinstance(slo, obs_mod.SLOTracker) \
            else obs_mod.SLOTracker(slo)
        self._engines: dict = {}
        self._policies: dict = {}
        self._failure: dict = {}  # name -> FailurePolicy
        self._sup: dict = {}  # name -> _Supervision
        self.telemetry: dict = {}
        self._vt: dict = {}  # virtual time per engine (cost-weighted fairness)
        # program generation (resizes_total) whose warm-up-bearing first busy
        # step was already discarded from the step-cost telemetry
        self._timed_gen: dict = {}
        self._vclock = 0.0  # service level of the last-stepped engine
        self._was_busy: set = set()
        self._steps_since_check: dict = {}
        self._pending: deque = deque()  # (name, gid, payload, kwargs, t_sub)
        self._staged: dict = {}  # name -> staged-not-yet-ingested count
        self._degraded: dict = {}  # gid -> (class, mode, trims) marker
        self._rejected: set = set()  # gids refused at ingest (shed, not fail)
        # Fleet controller (runtime/fleet.py): priority-class admission,
        # bit-safe preemption, global slot rebalancing, brownout.  ``fleet``
        # is a FleetPolicy or a ready FleetController; None disables all
        # four (the pre-fleet behavior).  bind() injects this runtime's live
        # environment — the engines dict is held by reference, so engines
        # registered later are visible to the controller.
        if fleet is None:
            self.fleet = None
        else:
            ctrl = fleet if isinstance(fleet, flc.FleetController) \
                else flc.FleetController(fleet)
            self.fleet = ctrl.bind(
                self._engines,
                unit_s_fn=lambda n: self.telemetry[n].step_unit_s(),
                backlog_fn=self._fleet_backlog,
                class_of=self._class_of_local,
                slo_fn=self.slo.snapshot,
                serving_fn=lambda n: self._sup[n].state == "serving",
                telemetry=self.telemetry,
                obs=self.obs, clock=self._clock)
        self._futures: dict = {}  # gid -> Future
        self._req_class: dict = {}  # gid -> (class label, submit time)
        self._req_spans: dict = {}  # gid -> open request-lifecycle span id
        self._gid_of: dict = {}  # (name, engine-local id) -> gid
        self._local_of: dict = {}  # gid -> (name, engine-local id)
        self._deadlines: list = []  # heap of (expiry_t, gid, name)
        self._next_gid = 0
        self._lock = threading.Lock()  # serializes all engine access
        self._submit_lock = threading.Lock()  # tiny: gid + future bookkeeping
        self._takeover_lock = threading.Lock()  # watchdog vs stop() races
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None
        self._watch_thread: threading.Thread | None = None
        self._watch_stop = threading.Event()
        self._stepping: tuple | None = None  # (engine, t0) while in step()
        self._gen = 0  # stepper generation; bumped by start() and takeovers
        self._running = False
        self._stopped = False  # stop() was called; submits must not hang
        self._error: BaseException | None = None

    # -- registration ------------------------------------------------------

    def register(self, name: str, engine, *,
                 retune: RetunePolicy | None = None,
                 failure: FailurePolicy | None = None) -> None:
        """Add an engine under `name`.  ``retune`` opts it into EWMA-driven
        slot re-tuning (requires a ``resize``-capable engine); ``failure``
        overrides the runtime's default :class:`FailurePolicy` for it."""
        if name in self._engines:
            raise ValueError(f"engine {name!r} already registered")
        if name in ("slo", "fleet"):
            raise ValueError(
                f"engine name {name!r} is reserved: Runtime.stats() exposes "
                "the per-class SLO snapshot and the fleet-controller "
                "snapshot under those keys")
        engine = flt.maybe_chaos_wrap(engine)  # transparency run hook
        # Engines built with the defaults join this runtime's recorder under
        # their registered name — one recorder, one clock, one trace for the
        # whole stack.  bind_obs resolves through ChaosEngine's attribute
        # forwarding onto the wrapped engine; explicitly-instrumented
        # engines (obs enabled at construction) are left alone.
        if self.obs.enabled and hasattr(engine, "bind_obs") and \
                not getattr(engine, "obs", obs_mod.NULL).enabled:
            engine.bind_obs(self.obs, track=name)
        if retune is not None and not supports_resize(engine):
            raise ValueError(f"engine {name!r} has no resize(); it cannot "
                             "opt into re-tuning")
        with self._lock:
            self._engines[name] = engine
            self._policies[name] = retune
            self._failure[name] = failure if failure is not None \
                else self._default_failure
            self._sup[name] = _Supervision()
            t = tele.EngineTelemetry()
            if retune is not None and retune.baseline_rps is not None:
                t.mark_tuned(retune.baseline_rps)
            self.telemetry[name] = t
            self._vt[name] = 0.0
            self._steps_since_check[name] = 0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Runtime":
        if self._thread is not None:
            if self._thread.is_alive() and self._running:
                raise RuntimeError("runtime already started")
            if self._thread.is_alive():  # a failed stop(): still wedged
                raise RuntimeError(
                    "the previous stepper thread is still wedged inside an "
                    "engine step; the runtime cannot restart until it exits")
            self._thread = None  # wedged stop() whose thread has since died
        self._running = True
        self._stopped = False
        self._gen += 1
        self._thread = threading.Thread(target=self._loop, args=(self._gen,),
                                        name="repro-runtime-stepper",
                                        daemon=True)
        self._thread.start()
        if self._watchdog_s is not None and self._watch_thread is None:
            self._watch_stop.clear()
            self._watch_thread = threading.Thread(
                target=self._watch, name="repro-runtime-watchdog", daemon=True)
            self._watch_thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Stop the stepper.  Unfinished requests' futures fail with
        RuntimeError rather than hanging a later ``result()`` — call
        :meth:`drain` first if the work should complete.

        If the stepper thread fails to join within `timeout` (a wedged
        engine step), stop() does NOT pretend it stopped: it warns, keeps
        the thread handle for diagnosis (``start()`` then refuses until the
        thread actually dies), and fails the unfinished futures with a
        :class:`~repro.runtime.faults.WedgedError` so nothing hangs."""
        self._stopped = True
        self._running = False
        self._wake.set()
        if self._watch_thread is not None:
            self._watch_stop.set()
            self._watch_thread.join(5.0)  # waits on an event; always joins
            self._watch_thread = None
        stop_err: BaseException = RuntimeError(
            "runtime stopped with the request unfinished")
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                stepping = self._stepping
                where = f" inside engine {stepping[0]!r}.step()" \
                    if stepping else ""
                stop_err = flt.WedgedError(
                    f"stop(timeout={timeout}) could not join the stepper "
                    f"thread{where}; runtime left in wedged state for "
                    "diagnosis", engine=stepping[0] if stepping else None)
                self._error = stop_err
                warnings.warn(str(stop_err), RuntimeWarning, stacklevel=2)
                # keep self._thread: start() must refuse while it lives
            else:
                self._thread = None
        # Fail what's unfinished (their futures stay retrievable via
        # result(), which surfaces the error) and drop the stale request
        # bookkeeping: a later start() must not let an engine-completed OLD
        # request hit an already-excepted future (Future.set_result would
        # raise InvalidStateError and kill the restarted stepper).
        with self._submit_lock:
            unfinished = [f for f in self._futures.values() if not f.done()]
        for fut in unfinished:
            fut.set_exception(stop_err)
        self._pending.clear()
        self._gid_of.clear()
        self._local_of.clear()
        self._deadlines.clear()

    def __enter__(self) -> "Runtime":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- submission / results ----------------------------------------------

    def submit(self, engine: str, payload, *, deadline_s: float | None = None,
               class_: str | None = None, priority: int | None = None,
               **kwargs) -> int:
        """Enqueue a request for `engine`; returns a runtime-global id
        immediately (the stepper thread performs the actual engine.submit).

        ``deadline_s`` arms a wall-clock budget from NOW: if no result
        landed when it elapses, the future fails with
        :class:`DeadlineExceededError` and the request's slot is reclaimed
        via the engine's preemption-safe ``cancel``.  Submits can fail fast
        with :class:`ShedError` (bounded pending queue full, or fleet
        admission control shedding the class under load) or
        :class:`EngineDeadError` (the engine was removed from service) —
        both count as *shed* in telemetry and the SLO tracker.

        ``class_`` labels the request for per-class SLO accounting
        (``stats()["slo"]``, span args, latency histograms); it defaults to
        the engine's ``engine_kind`` ("factorizer", "lm", ...) so unlabeled
        traffic still aggregates into meaningful classes.  Under a fleet
        controller the class also resolves the engine queue ``priority``
        (overridable per request) and may come back *degraded*: admitted
        with trimmed budgets and the result wrapped in
        :class:`~repro.runtime.fleet.DegradedResult`.
        """
        if engine not in self._engines:
            raise KeyError(f"unknown engine {engine!r}; registered: "
                           f"{sorted(self._engines)}")
        if self._error is not None:
            raise RuntimeError("runtime stepper died") from self._error
        if self._stopped:
            raise RuntimeError("runtime is stopped; nothing would serve "
                               "this request")
        cls = class_ if class_ is not None else \
            getattr(self._engines[engine], "engine_kind", engine)
        if self._sup[engine].state == "dead":
            # a rejection flavor like any other: no future will exist, so
            # account the shed here (the SLOTracker's shed_rate must cover
            # every refusal, not only the max_pending path)
            self.telemetry[engine].shed += 1
            self.slo.on_shed(cls)
            raise flt.EngineDeadError(
                f"engine {engine!r} was removed from service",
                engine=engine) from self._sup[engine].last_error
        if self._max_pending is not None and \
                len(self._pending) >= self._max_pending:
            # fail-fast overload shedding; shed requests never stamp the
            # arrival estimator (they were not admitted).  No future exists
            # for a shed request, so the SLO tracker is told here.
            self.telemetry[engine].shed += 1
            self.slo.on_shed(cls)
            raise flt.ShedError(
                f"pending queue full ({self._max_pending}); request shed",
                engine=engine)
        now = self._clock()
        decision = None
        if self.fleet is not None:
            # Class-aware admission: estimated queue wait (measured
            # step_unit_s EWMA x backlog) against the class's thresholds.
            # The backlog read is racy-by-one vs the stepper — a stale
            # estimate shifts a threshold comparison, never correctness.
            decision = self.fleet.admit(engine, cls, priority=priority,
                                        now=now)
            if decision.action == "shed":
                self.telemetry[engine].shed += 1
                self.slo.on_shed(cls)
                raise flt.ShedError(
                    f"admission control shed class {cls!r} for engine "
                    f"{engine!r}: {decision.reason}", engine=engine)
            if priority is None:
                priority = decision.priority
            if decision.action == "degrade":
                kwargs = decision.apply(kwargs)
                self.telemetry[engine].degraded += 1
        if priority is not None:
            kwargs = {**kwargs, "priority": int(priority)}
        fut: Future = Future()
        with self._submit_lock:
            gid = self._next_gid
            self._next_gid += 1
            self._futures[gid] = fut
            self._req_class[gid] = (cls, now)
            self._staged[engine] = self._staged.get(engine, 0) + 1
            if decision is not None and decision.action == "degrade":
                self._degraded[gid] = (cls, decision.mode,
                                       dict(decision.trims))
            if deadline_s is not None:
                heapq.heappush(self._deadlines,
                               (now + float(deadline_s), gid, engine))
        self.slo.on_submit(cls)
        if self.obs.enabled:
            # The request-lifecycle span: opened at submit, closed by the
            # future's done-callback (whichever thread resolves it — result,
            # deadline expiry, engine death); engine-internal spans correlate
            # by time on the shared clock, not by parentage.
            self._req_spans[gid] = self.obs.begin(
                "request", track="requests", cat="request",
                args={"gid": gid, "engine": engine, "class": cls})
        # The done-callback routes the outcome (ok / deadline / failure)
        # into the SLO tracker and closes the request span — on whichever
        # thread resolves the future.  Always attached: SLO accounting is
        # live even with the NULL recorder.
        fut.add_done_callback(lambda f, gid=gid: self._on_resolved(gid, f))
        self._pending.append((engine, gid, payload, kwargs, now))
        self._wake.set()
        # Close the race with a concurrently-dying or concurrently-stopping
        # stepper: if it drained/snapshotted _pending before our append,
        # nothing will ever resolve this future — fail it here instead of
        # hanging result(timeout=None).
        if (self._error is not None or self._stopped) and not fut.done():
            fut.set_exception(RuntimeError(
                "runtime stepper died" if self._error is not None
                else "runtime stopped with the request unfinished"))
        return gid

    def _on_resolved(self, gid: int, fut: Future) -> None:
        """Future done-callback: one choke point for outcome accounting.
        Runs on whichever thread resolved the future (stepper, deadline
        expiry, stop()); everything here is host-side scalar work."""
        cls, t_sub = self._req_class.pop(gid, (None, None))
        with self._submit_lock:
            rejected = gid in self._rejected
            self._rejected.discard(gid)
            self._degraded.pop(gid, None)  # failed before its wrap
        exc = fut.exception()
        if cls is not None:
            if exc is None:
                lat = self._clock() - t_sub
                self.slo.on_complete(cls, lat)
                if self.obs.enabled:
                    # per-class latency histogram; SLOTracker keeps exact
                    # windows, this feeds the scrapeable metrics snapshot
                    self.obs.observe("request_latency_s", lat,
                                     **{"class": cls})
            elif isinstance(exc, flt.DeadlineExceededError):
                self.slo.on_deadline_miss(cls)
            elif rejected:
                # refused at ingest (dead engine, chaos submit rejection):
                # never served, so it belongs in the shed column — the
                # tracker un-counts the submit it already recorded
                self.slo.on_rejected(cls)
            else:
                self.slo.on_failure(cls)
        sid = self._req_spans.pop(gid, None)
        if sid is None:
            return
        self.obs.end(sid, args={
            "outcome": "ok" if exc is None else type(exc).__name__})
        self.obs.count("resolved", 1,
                       outcome="ok" if exc is None else "error",
                       **({"class": cls} if cls is not None else {}))

    def result(self, gid: int, timeout: float | None = None):
        """Block until request `gid` completes; returns the engine's request
        object (``.result`` holds the workload answer).

        Retrieval CONSUMES the handle (the runtime would otherwise
        accumulate one resolved future per request forever); asking again
        raises KeyError.  A timeout or failure leaves the handle retrievable.
        """
        try:
            fut = self._futures[gid]
        except KeyError:
            raise KeyError(f"unknown request id {gid}") from None
        try:
            out = fut.result(timeout)
        except FutureTimeout:
            raise TimeoutError(
                f"request {gid} not completed within {timeout}s") from None
        with self._submit_lock:
            self._futures.pop(gid, None)
        return out

    def drain(self, timeout: float | None = None, *,
              return_exceptions: bool = False) -> list:
        """Block until every currently-outstanding request has completed;
        returns (and consumes, like :meth:`result`) their request objects in
        submission (gid) order.

        ``return_exceptions=True`` collects structured per-request failures
        (deadline misses, faults on a dead engine, ...) into the returned
        list instead of raising on the first one — the chaos-test shape:
        under fault injection every future resolves to SOMETHING, and the
        caller wants all of it."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._submit_lock:  # snapshot: submit() mutates the dict
            gids = sorted(self._futures)
        out = []
        for gid in gids:
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                raise TimeoutError("drain() timed out")
            try:
                out.append(self.result(gid, left))
            except KeyError:  # consumed by a concurrent result() call
                continue
            except TimeoutError:
                raise
            except Exception as e:
                if not return_exceptions:
                    raise
                out.append(e)
        return out

    def stats(self) -> dict:
        """Per-engine merged engine + telemetry + supervision snapshot.

        NON-destructive: engines expose ``snapshot(reset=False)`` (unified
        schema, see ``Engine.snapshot``) so a stats scrape, a dashboard, and
        the re-tuner can read concurrently without racing each other's
        rolling windows.  Engines without the seam fall back to their
        ``stats()``."""
        with self._lock, self._submit_lock:
            now = self._clock()
            out = {name: {**(eng.snapshot(reset=False)
                             if hasattr(eng, "snapshot") else eng.stats()),
                          "telemetry": self.telemetry[name].snapshot(now),
                          "supervision": self._sup_snapshot(name)}
                   for name, eng in self._engines.items()}
        # Per-class SLO attainment under the reserved top-level key
        # (register() refuses an engine named "slo"); computed outside the
        # engine locks — the tracker has its own.
        out["slo"] = self.slo.snapshot()
        if self.fleet is not None:  # "fleet" is reserved like "slo"
            out["fleet"] = self.fleet.snapshot()
        return out

    def _sup_snapshot(self, name: str) -> dict:
        sup = self._sup[name]
        return {"state": sup.state, "restarts": sup.restarts,
                "last_error": None if sup.last_error is None
                else repr(sup.last_error),
                "events": list(sup.events)}

    # -- stepper thread ----------------------------------------------------

    def _ingest(self) -> None:
        while self._pending:
            name, gid, payload, kwargs, t_sub = self._pending.popleft()
            try:
                self._ingest_one(name, gid, payload, kwargs, t_sub)
            finally:
                # The staged count must not drop until the request is ON
                # the engine (or refused): engine.submit can be slow (first
                # call loads modules), and decrementing up front opens a window
                # where a concurrent admission reads backlog 0 and waves
                # overload straight through.
                with self._submit_lock:
                    if self._staged.get(name, 0) > 0:
                        self._staged[name] -= 1

    def _ingest_one(self, name, gid, payload, kwargs, t_sub) -> None:
        fut = self._futures.get(gid)
        if fut is None or fut.done():  # consumed / deadline-expired
            return
        if self._sup[name].state == "dead":
            self._mark_rejected(gid, name)
            fut.set_exception(flt.EngineDeadError(
                f"engine {name!r} was removed from service",
                engine=name))
            return
        try:
            local = self._engines[name].submit(payload, **kwargs)
        except Exception as e:  # bad request: fail ITS future, keep serving
            self._mark_rejected(gid, name)
            fut.set_exception(e)
            return
        self._gid_of[(name, local)] = gid
        self._local_of[gid] = (name, local)
        if self.obs.enabled:
            self.obs.instant("admit", track="requests",
                             parent=self._req_spans.get(gid),
                             cat="request",
                             args={"gid": gid, "engine": name,
                                   "local_id": local})
        # Arrival telemetry stamps HERE, on successful ingest, with the
        # request's submit timestamp — a rejected or shed request must
        # not inflate the EWMA arrival rate into bogus re-tunes.
        self.telemetry[name].on_submit(t_sub)

    def _mark_rejected(self, gid: int, name: str) -> None:
        """Tag a post-future refusal (dead engine at ingest, engine submit
        exception) BEFORE failing the future: the done-callback then routes
        it to ``SLOTracker.on_rejected`` (shed, not failed), and telemetry
        counts it next to the pre-future sheds."""
        self.telemetry[name].shed += 1
        with self._submit_lock:
            self._rejected.add(gid)

    # -- fleet controller environment ---------------------------------------

    def _fleet_backlog(self, name: str) -> int:
        """Backlog the admission estimate prices: rows on the engine plus
        staged submissions the stepper has not ingested yet (without the
        staged term a submit burst would be invisible to admission until
        the next loop pass)."""
        eng = self._engines.get(name)
        base = int(getattr(eng, "in_flight", 0)) if eng is not None else 0
        with self._submit_lock:
            return base + self._staged.get(name, 0)

    def _class_of_local(self, name: str, local: int) -> str | None:
        """Request class of a live engine-local id (preemption victim
        filtering); None for ids the runtime did not place."""
        gid = self._gid_of.get((name, local))
        if gid is None:
            return None
        rec = self._req_class.get(gid)
        return rec[0] if rec else None

    def _expire_deadlines(self, now: float) -> None:
        """Fail (and preempt) every armed request whose budget elapsed."""
        while self._deadlines and self._deadlines[0][0] <= now:
            expiry, gid, name = heapq.heappop(self._deadlines)
            fut = self._futures.get(gid)
            if fut is None or fut.done():  # completed / consumed in time
                continue
            placed = self._local_of.pop(gid, None)
            if placed is not None:
                pname, local = placed
                self._gid_of.pop((pname, local), None)
                eng = self._engines[pname]
                if self._sup[pname].state != "dead" and supports_cancel(eng):
                    try:  # reclaim the slot; the future fails regardless
                        eng.cancel(local)
                    except Exception:
                        pass
            self.telemetry[name].deadline_misses += 1
            fut.set_exception(flt.DeadlineExceededError(
                f"request {gid} missed its deadline "
                f"(expired {now - expiry:.3f}s ago)", engine=name))

    def _service_quarantine(self, now: float) -> None:
        """Attempt recovery of every quarantined engine whose backoff
        expired: rebuild + replay via the engine's ``recover`` seam."""
        for name, sup in self._sup.items():
            if sup.state != "quarantined" or now < sup.until:
                continue
            try:
                replayed = self._engines[name].recover()
            except Exception as e:  # recovery itself failed: burn a restart
                self._quarantine(name, e)
                continue
            sup.state = "serving"
            sup.awaiting_completion = True
            sup.log(self._clock(), f"recovered replay={replayed}")
            if self.obs.enabled:
                self.obs.instant("recovered", track="supervisor",
                                 parent=sup.cycle_sid, cat="supervision",
                                 args={"engine": name, "replayed": replayed})
                self.obs.end(sup.cycle_sid,
                             args={"outcome": "recovered",
                                   "replayed": replayed})
                sup.cycle_sid = None
                self.obs.count("recoveries", 1, engine=name)
            t = self.telemetry[name]
            t.recoveries += 1
            t.replayed += int(replayed or 0)

    def _quarantine(self, name: str, exc: BaseException) -> None:
        """Route a fault: quarantine under the engine's FailurePolicy, or
        kill it when the restart budget (or the recover seam) is missing."""
        now = self._clock()
        sup, pol = self._sup[name], self._failure[name]
        sup.last_error = exc
        sup.log(now, f"fault {getattr(exc, 'kind', type(exc).__name__)}")
        self.telemetry[name].faults += 1
        if self.obs.enabled:
            # One "fault-cycle" span per quarantine episode on the
            # supervisor track: fault -> quarantined -> recovered|dead ride
            # as child instants; a repeated fault during an open cycle
            # (recovery itself failed) extends the same span.
            if sup.cycle_sid is None:
                sup.cycle_sid = self.obs.begin(
                    "fault-cycle", track="supervisor", cat="supervision",
                    args={"engine": name})
            self.obs.instant(
                "fault", track="supervisor", parent=sup.cycle_sid,
                cat="supervision",
                args={"engine": name,
                      "kind": getattr(exc, "kind", type(exc).__name__)})
            self.obs.count("faults", 1, engine=name)
        eng = self._engines[name]
        if not supports_recover(eng) or sup.restarts >= pol.max_restarts:
            self._kill(name, exc)
            return
        backoff = min(pol.backoff_initial_s * pol.backoff_factor
                      ** sup.restarts, pol.backoff_max_s)
        sup.restarts += 1
        sup.state = "quarantined"
        sup.until = now + backoff
        sup.log(now, f"quarantined backoff={backoff:.3g}s")
        if self.obs.enabled:
            self.obs.instant("quarantined", track="supervisor",
                             parent=sup.cycle_sid, cat="supervision",
                             args={"engine": name, "backoff_s": backoff,
                                   "restarts": sup.restarts})
            self.obs.count("quarantines", 1, engine=name)

    def _kill(self, name: str, exc: BaseException) -> None:
        """Remove `name` from service permanently and fail its futures."""
        sup = self._sup[name]
        sup.state = "dead"
        sup.last_error = exc
        sup.log(self._clock(), "dead")
        if self.obs.enabled:
            self.obs.instant("dead", track="supervisor",
                             parent=sup.cycle_sid, cat="supervision",
                             args={"engine": name, "error": repr(exc)})
            if sup.cycle_sid is not None:
                self.obs.end(sup.cycle_sid, args={"outcome": "dead"})
                sup.cycle_sid = None
            self.obs.count("deaths", 1, engine=name)
        err = flt.EngineDeadError(
            f"engine {name!r} removed from service: {exc}", engine=name)
        err.__cause__ = exc
        self._fail_engine_futures(name, err)

    def _fail_engine_futures(self, name: str, err: BaseException) -> None:
        with self._submit_lock:
            doomed = [(key, gid) for key, gid in self._gid_of.items()
                      if key[0] == name]
            for key, gid in doomed:
                self._gid_of.pop(key, None)
                self._local_of.pop(gid, None)
        for _, gid in doomed:
            fut = self._futures.get(gid)
            if fut is not None and not fut.done():
                fut.set_exception(err)
        # still-pending (un-ingested) requests fail at the next _ingest

    def _pick(self) -> str | None:
        busy = [n for n, e in self._engines.items()
                if self._sup[n].state == "serving" and e.in_flight > 0]
        if not busy:
            self._was_busy.clear()
            return None
        # Start-time clamp (SFQ-style): an engine entering service after an
        # idle stretch resumes at the CURRENT service level instead of its
        # stale vt — otherwise a long-idle engine arrives with a huge virtual
        # deficit and monopolizes the stepper until it "catches up".
        for n in busy:
            if n not in self._was_busy:
                self._vt[n] = max(self._vt[n], self._vclock)
        self._was_busy = set(busy)
        name = min(busy, key=lambda n: self._vt[n])
        self._vclock = self._vt[name]
        return name

    def _step_one(self, name: str, gen: int) -> None:
        eng = self._engines[name]
        sup = self._sup[name]
        sweeps_before = getattr(eng, "sweeps_total", None)
        t0 = self._clock()
        # heartbeat: the watchdog sees (engine, t0) while step() runs; a
        # wedge past watchdog_s triggers a takeover, after which THIS
        # thread's generation is stale and it must unwind untouched
        self._stepping = (name, t0)
        try:
            finished = eng.step()
        except Exception as e:
            self._stepping = None
            if self._gen != gen:
                raise _Takeover() from None
            self._quarantine(name, e)
            return
        self._stepping = None
        if self._gen != gen:
            raise _Takeover() from None
        step_s = self._clock() - t0
        backlog = eng.in_flight + len(finished)
        self._vt[name] += step_cost_seconds(eng) / max(1, backlog)
        t = self.telemetry[name]
        slots = getattr(eng, "slots", None)
        busy = (min(1.0, backlog / slots) if slots else 0.0)
        # Wall-clock step-cost telemetry: sweeps executed this step (0 when
        # the engine was idle — those steps must not dilute the estimate).
        # The FIRST busy step of each program generation (fresh engine, or a
        # resize()/recover() rebuild) pays one-time warm-up — a CUDA module
        # load, cuFFT/cuBLAS plan creation and caching-allocator growth on
        # the card, or an nvcc build of a kernel whose library is not on
        # disk yet — orders of magnitude above steady state, so it is
        # excluded from the EWMA, or the measured re-tune cost basis would
        # be poisoned for dozens of steps.
        units = 0 if sweeps_before is None else \
            max(0, getattr(eng, "sweeps_total", 0) - sweeps_before)
        prog_gen = (getattr(eng, "resizes_total", 0),
                    getattr(eng, "recoveries_total", 0))
        if units > 0 and self._timed_gen.get(name) != prog_gen:
            self._timed_gen[name] = prog_gen  # warm-up step: don't record
            units = 0
        # Planner drift: adSCH's modeled step cost divided down to one step
        # unit, against the measured wall-clock EWMA the same on_step call
        # updates — telemetry exposes the ratio as plan_drift_ratio.
        units_per_step = getattr(eng, "sweeps_per_step", None) or \
            getattr(eng, "decode_per_step", None)
        modeled = step_cost_seconds(eng) / units_per_step \
            if units_per_step else None
        t.on_step(busy, eng.in_flight, step_s=step_s, units=units,
                  modeled_unit_s=modeled)
        if self.obs.enabled:
            # Continuous planner-drift surfacing: every telemetry tick
            # refreshes the per-engine gauges, not just retune instants.
            # modeled/measured land separately so the attribution report
            # can integrate span-derived drift over the whole trace.
            drift = t.plan_drift_ratio()
            if drift is not None:
                self.obs.gauge("plan_drift", drift, engine=name)
            if modeled is not None:
                self.obs.gauge("modeled_unit_s", modeled, engine=name)
            mu = t.step_unit_s()
            if mu is not None:
                self.obs.gauge("measured_unit_s", mu, engine=name)
        for req in finished:
            t.on_complete(getattr(req, "latency_s", 0.0) or 0.0)
            gid = self._gid_of.pop((name, req.id), None)
            fut = None if gid is None else self._futures.get(gid)
            if gid is not None:
                self._local_of.pop(gid, None)
            if fut is not None and not fut.done():
                mark = self._degraded.pop(gid, None)
                if mark is not None:
                    # brownout-trimmed admission: the caller gets a
                    # structured marker around the (degraded) answer, not
                    # a silently-worse result
                    req.result = flc.DegradedResult(req.result, *mark)
                fut.set_result(req)
            # the future now owns the result; drop the engine's reference so
            # a long-running runtime doesn't accumulate every Request ever
            # served (engines keep their all-time counters regardless)
            getattr(eng, "completed", {}).pop(req.id, None)
        if finished and sup.awaiting_completion:
            sup.awaiting_completion = False
            sup.log(self._clock(), "first_completion_after_recovery")
        self._steps_since_check[name] += 1
        # cadenced corruption probe: silent non-finite state routes through
        # the same quarantine/replay path as a loud step exception
        pol = self._failure[name]
        if pol.health_check_every > 0 and supports_health_check(eng):
            sup.steps_since_probe += 1
            if sup.steps_since_probe >= pol.health_check_every:
                sup.steps_since_probe = 0
                try:
                    msg = eng.health_check()
                except Exception as e:
                    self._quarantine(name, e)
                    return
                if msg is not None:
                    self._quarantine(name, flt.FaultError(msg, engine=name))

    def _maybe_retune(self, name: str) -> None:
        if self._sup[name].state != "serving":
            return
        policy = self._policies[name]
        if policy is None:
            return
        if self._steps_since_check[name] < policy.check_every:
            return
        self._steps_since_check[name] = 0
        t = self.telemetry[name]
        # estimator writes happen on this thread (_ingest), no lock needed
        rate = t.arrivals.rate(self._clock())
        if t.tuned_rate is None:  # first check anchors the drift baseline
            if rate > 0:
                t.mark_tuned(rate)
            return
        if not tele.should_retune(rate, t.tuned_rate, policy.threshold):
            return
        # Cost basis, in preference order (units must match the wall-clock
        # EWMA arrival rate — the analytic model's device-second rates are
        # incommensurable and would rarely move slots; see
        # autotune.retune_slots):  (1) stall-and-measure per candidate when
        # the policy asks; (2) the stepper's free wall-clock step-time EWMA;
        # (3) the analytic model as a documented last resort.
        kw = {"headroom": policy.headroom,
              "measured_sweep_s": policy.use_measured_cost or None,
              "measured_step_unit_s": t.step_unit_s()}
        if policy.candidates is not None:
            kw["candidates"] = policy.candidates
        with self.obs.span("retune", track="supervisor", cat="supervision",
                           args={"engine": name, "rate_rps": rate,
                                 "tuned_rate_rps": t.tuned_rate}) as sp:
            new_slots = retune_slots(self._engines[name], rate, **kw)
            if new_slots is not None:
                self._engines[name].resize(new_slots)
                t.retunes += 1
                self.obs.count("retunes", 1, engine=name)
            if sp is not None:
                sp.args.update(
                    new_slots=new_slots,
                    measured_unit_s=t.step_unit_s(),
                    plan_drift_ratio=t.plan_drift_ratio())
        t.mark_tuned(rate)  # re-anchor either way; drift is vs the decision

    def _loop(self, gen: int) -> None:
        try:
            while self._running and self._gen == gen:
                lock = self._lock  # takeover swaps the attribute; pin per-pass
                with lock:
                    if self._gen != gen:
                        return
                    now = self._clock()
                    if self._pending:
                        # admission is real host work (engine submit()
                        # copies to the device): span it so a burst's
                        # admission cost is attributable to the requests
                        # it delays.  The guard keeps idle loop passes
                        # from emitting spans.
                        with self.obs.span("ingest", track="runtime",
                                           cat="runtime"):
                            self._ingest()
                    self._expire_deadlines(now)
                    self._service_quarantine(now)
                    name = self._pick()
                    if name is not None:
                        # dispatch span: covers the engine step PLUS the
                        # stepper's own host work around it (telemetry,
                        # gauges, future resolution) so the attribution
                        # report can account for near-100% of a request's
                        # service window.  NULL's span() is a no-op
                        # singleton, so the untraced path stays free.
                        with self.obs.span("dispatch", track="runtime",
                                           cat="runtime",
                                           args={"engine": name}):
                            self._step_one(name, gen)
                        self._maybe_retune(name)
                        if self.fleet is not None:
                            # fleet control tick: preemption, brownout
                            # state, cadenced global slot rebalancing —
                            # under the loop lock like every engine access
                            self.fleet.control(now=self._clock())
                if name is None:
                    self._wake.wait(self._idle_sleep_s)
                    self._wake.clear()
        except _Takeover:  # stale generation: a replacement stepper owns
            return         # the runtime now; unwind without touching state
        except BaseException as e:  # fail every outstanding future loudly
            if self._gen != gen:
                return
            self._error = e
            for key, gid in list(self._gid_of.items()):
                fut = self._futures.get(gid)
                if fut is not None and not fut.done():
                    fut.set_exception(e)
            self._gid_of.clear()
            self._local_of.clear()
            while self._pending:
                _, gid, _, _, _ = self._pending.popleft()
                fut = self._futures.get(gid)
                if fut is not None and not fut.done():
                    fut.set_exception(e)

    # -- watchdog thread ---------------------------------------------------

    def _watch(self) -> None:
        """Heartbeat monitor: declare a wedged step dead and hand the
        healthy engines to a replacement stepper."""
        interval = min(1.0, max(self._watchdog_s / 8.0, 0.01))
        while not self._watch_stop.wait(interval):
            snap = self._stepping
            if snap is None:
                continue
            name, t0 = snap
            if self._clock() - t0 >= self._watchdog_s:
                self._declare_wedged(name, t0)

    def _declare_wedged(self, name: str, t0: float) -> None:
        with self._takeover_lock:
            # re-check under the lock: the step may have completed (or a
            # different step started) between the watchdog's read and here
            snap = self._stepping
            if (not self._running or snap is None or snap[0] != name
                    or snap[1] != t0):
                return
            age = self._clock() - t0
            # Abandon the wedged stepper: bump the generation (the stuck
            # thread checks it right after step() returns and unwinds via
            # _Takeover) and swap in a fresh lock — the old lock is held by
            # the stuck thread, possibly forever.
            self._gen += 1
            self._lock = threading.Lock()
            self._stepping = None
            err = flt.WedgedError(
                f"engine {name!r} step wedged for {age:.2f}s "
                f"(watchdog_s={self._watchdog_s}); engine declared dead, "
                "stepper replaced", engine=name)
            sup = self._sup[name]
            sup.state = "dead"
            sup.last_error = err
            sup.log(self._clock(), "wedged")
            if self.obs.enabled:
                self.obs.instant("wedged", track="supervisor",
                                 parent=sup.cycle_sid, cat="supervision",
                                 args={"engine": name, "wedged_s": age})
                if sup.cycle_sid is not None:
                    self.obs.end(sup.cycle_sid, args={"outcome": "wedged"})
                    sup.cycle_sid = None
                self.obs.count("deaths", 1, engine=name)
            self.telemetry[name].faults += 1
            self._fail_engine_futures(name, err)
            # the wedged thread still holds the OLD lock; the replacement
            # stepper serves the healthy engines behind the new one (it
            # never touches the dead engine, the only object the stuck
            # thread can still reach)
            self._thread = threading.Thread(
                target=self._loop, args=(self._gen,),
                name="repro-runtime-stepper", daemon=True)
            self._thread.start()
            self._wake.set()
