"""Request-level serving engine: continuous batching of reasoning queries.

The port of ``repro/engine/engine.py``.  The factorizer state is a
fixed-shape ``[N, F, D]`` batch on the engine's device, and incoming
factorization requests are slotted into rows as converged rows retire — so
the batch never drains to the slowest query.  Rows are independent in the
resonator sweep, so a request's trajectory is the one a solo
:func:`repro_torch.core.factorizer.factorize` call follows, whichever slot
and whichever sweep it lands on.

How many sweeps run between host-side retirement scans is an adSCH
decision: :func:`derive_sweeps_per_step` prices one sweep of the full slot
batch and the declared neural stage with the paper's analytic cell-pool
model and picks the sweep burst that fits the neural overlap window.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch.cogsim import model as hw_model
from repro_torch.core import factorizer as fz
from repro_torch.core import scheduler as sch
from repro_torch.core.quantization import QTensor
from repro_torch.core.factorizer import sweep_cost_ops  # re-export (public API)
from repro_torch.device import DEFAULT_DEVICE, generator as as_generator, resolve
from repro_torch.engine.registry import ServeSpec
from repro_torch.engine.stage import stage_ops
from repro_torch.kernels.resonator_step.ops import FusedConfig


def step_unit_ops(spec: ServeSpec, slots: int, *, data_shards: int = 1,
                  model_shards: int = 1) -> list:
    """Cost ops of ONE step unit of `spec` at this slot count: the spec's
    own ``step_ops`` where it declares them, else one resonator sweep."""
    if spec.step_ops is not None:
        return spec.step_ops(slots, data_shards=data_shards,
                             model_shards=model_shards)
    if spec.cfg is None:
        raise ValueError(f"spec {spec.name!r} has neither step_ops nor a "
                         "FactorizerConfig to price a step from")
    return sweep_cost_ops(spec.cfg, slots, data_shards=data_shards,
                          model_shards=model_shards)


def derive_sweeps_per_step(spec: ServeSpec, slots: int, hw=hw_model.COGSYS, *,
                           data_shards: int = 1, model_shards: int = 1) -> int:
    """Sweep burst between retirement scans, from adSCH runtime estimates.

    With a declared graph the burst is the number of symbolic sweeps that fit
    the neural stages' makespan (the interleave window the hardware scheduler
    fills, Fig. 13b).  Without one, a fixed burst of 8 amortizes the
    host-side slotting scan.  With shards both sides are priced per device:
    the sweep with its cross-shard reductions (collective ops), the neural
    window scaled to its data-parallel slice.
    """
    t_sweep = sch.schedule(
        step_unit_ops(spec, slots, data_shards=data_shards,
                      model_shards=model_shards), hw).makespan
    if spec.graph is not None and t_sweep > 0:
        neural = [st for st in spec.graph.stages if not st.symbolic]
        n_ops = stage_ops(neural, 0) if neural else []
        if n_ops and data_shards > 1:
            from repro_torch.engine.sharding.costs import shard_ops

            n_ops = shard_ops(n_ops, data_shards)
        if n_ops:
            t_neural = sch.schedule(n_ops, hw).makespan
            return int(np.clip(round(t_neural / t_sweep), 1, 64))
    return 8


# Rolling latency windows are capped so non-destructive snapshot() readers
# can coexist with a serving loop that never calls the draining stats().
LAT_WINDOW_CAP = 1024


def rolling_latency_ms(lats) -> dict:
    """p50/p99 (in ms) of one latency window, ``None`` when empty."""
    if not lats:
        return {"latency_p50_ms": None, "latency_p99_ms": None}
    arr = np.asarray(lats)
    return {"latency_p50_ms": float(np.percentile(arr, 50) * 1e3),
            "latency_p99_ms": float(np.percentile(arr, 99) * 1e3)}


@dataclasses.dataclass
class Request:
    """One submitted reasoning request (1..k queries slotted independently)."""

    id: int
    queries: torch.Tensor  # [k, D] on the engine's device
    keys: torch.Tensor  # [k, 2] int64, one key per query
    meta: Any
    submit_time: float
    submit_sweep: int
    priority: int = 0  # queue order: lower serves first (fleet classes)
    iter_budget: int | None = None  # per-request cap on cfg.max_iters (brownout)
    rows: list = dataclasses.field(default_factory=list)  # per-query results
    result: Any = None  # postprocess output (or stacked FactorizerResult)
    factorization: Any = None  # stacked FactorizerResult over the k queries (numpy)
    iterations: Any = None  # [k] int — matches a solo factorize() per query
    done_time: float | None = None
    done_sweep: int | None = None

    @property
    def num_queries(self) -> int:
        return self.queries.shape[0]

    @property
    def latency_s(self) -> float | None:
        return None if self.done_time is None else \
            self.done_time - self.submit_time


class Engine:
    """``submit()/step()/drain()`` continuous batching over one ServeSpec.

    The slot state lives on ``device`` (default ``"cuda"``; raises where
    there is no GPU), and so do the spec's codebooks, dense or ``QTensor``.
    Results come back to the host as numpy arrays.  Stochastic specs draw
    each row's noise from its pinned key and its own sweep index, so a
    preempted, cancelled, recovered or resized row replays bit-equal on one
    device.
    """

    engine_kind = "factorizer"  # unified stats schema discriminator

    def __init__(self, spec: ServeSpec, *, slots: int = 32,
                 sweeps_per_step: int | None = None, hw=hw_model.COGSYS,
                 generator=None, fused: FusedConfig | None = None, obs=None,
                 clock=None, device=DEFAULT_DEVICE):
        self.device = resolve(device)
        self.spec = dataclasses.replace(
            spec, codebooks=spec.codebooks.to(self.device),
            valid_mask=(None if spec.valid_mask is None
                        else spec.valid_mask.to(self.device)))
        self.slots = slots
        self.hw = hw
        # Spans and metrics are recorded AROUND the device work; the NULL
        # default records nothing.
        self.obs = obs if obs is not None else obs_mod.NULL
        self.obs_track = spec.name
        self._default_clock = clock is None
        self._clock = clock if clock is not None else self.obs.clock
        if fused is not None and not isinstance(fused, FusedConfig):
            raise TypeError(
                f"Engine(fused=) expects a FusedConfig or None, got "
                f"{fused!r}; the fused sweep is requested via "
                "fused_step=True on the spec's FactorizerConfig")
        self.fused = fused
        self._sweeps_pinned = sweeps_per_step is not None
        self.sweeps_per_step = (self._derive_sweeps_per_step()
                                if sweeps_per_step is None else sweeps_per_step)
        self._gen = as_generator(0 if generator is None else generator)
        self._build_programs()
        self._owner: list = [None] * slots  # (request, query_index) | None
        # Queued rows as a heap of (priority, id, qi, request): the key is
        # unique to a row, so a comparison never reaches the request.
        self._queue: list = []
        self._next_id = 0
        self.completed: dict = {}
        self.sweeps_total = 0
        self.steps_total = 0
        self.resizes_total = 0
        self.recoveries_total = 0
        # All-time accounting kept incrementally: `completed` is a lookup a
        # caller may evict resolved requests from, so totals must not scan it.
        self.completed_total = 0
        self._lat_sum = 0.0
        self._lat_window: list = []  # latencies since the last stats() snapshot
        self._step_cost_cache: float | None = None

    def _derive_sweeps_per_step(self) -> int:
        return derive_sweeps_per_step(self.spec, self.slots, self.hw)

    def _build_programs(self) -> None:
        """Build the three device programs (``_sweeps``: a sweep burst,
        ``_refill_many``, ``_decode``) and allocate the parked slot state:
        the seam a mesh engine overrides
        (:class:`repro_torch.engine.sharding.ShardedEngine` runs the same
        resonator shard by shard)."""
        spec, slots = self.spec, self.slots
        rs = fz.make_resonator(spec.codebooks, spec.cfg, spec.valid_mask,
                               fused=self.fused, span=self._sweep_span)
        self.qs = torch.zeros((slots, spec.dim), dtype=torch.float32,
                              device=self.device)
        st = rs.init(self.qs, torch.zeros((slots, 2), dtype=torch.int64))
        self.state = st._replace(done=torch.ones_like(st.done))  # all parked

        def run_sweeps(qs, s, budget: int):
            """At most ``budget`` sweeps, stopping early once no row is
            active; returns (state, sweeps run).  Each sweep costs one host
            sync (the ``any`` below): a CUDA-graph burst of fixed length
            with frozen rows would drop it to one per burst."""
            n = 0
            while n < budget and bool(rs.active(s).any()):
                s = rs.sweep(qs, s)
                n += 1
            return s, n

        self._sweeps = run_sweeps
        self._refill_many = rs.refill_many
        self._decode = rs.decode
        self._record_structure()

    def _sweep_span(self, name: str):
        """The resonator's span factory: a span on this engine's track of
        whatever recorder the engine holds when the sweep runs (``bind_obs``
        may swap it after the programs are built)."""
        return self.obs.span(name, track=self.obs_track, cat="sweep")

    def _psums_per_sweep(self) -> int:
        """Cross-shard reductions ONE sweep issues (0 on one device; the
        mesh engine overrides with its collectives contract)."""
        return 0

    def _record_structure(self) -> None:
        """Structural gauges refreshed on every (re)build: slot shape, burst
        size and hand-written kernel launches per sweep (one launch covers
        all F factors of a fused-eligible spec)."""
        if not self.obs.enabled:
            return
        track = self.obs_track
        self.obs.gauge("slots", self.slots, engine=track)
        self.obs.gauge("units_per_step", self.sweeps_per_step, engine=track)
        self.obs.gauge("kernel_launches_per_sweep",
                       self.kernel_launches_per_sweep, engine=track)
        self.obs.gauge("psums_per_sweep", self._psums_per_sweep(),
                       engine=track)

    @property
    def kernel_launches_per_sweep(self) -> int:
        """Hand-written kernel launches per sweep: 1 for a fused spec, F for
        an int8 ``QTensor`` spec (one ``similarity_int8`` per factor, Jacobi
        or Gauss-Seidel), 0 otherwise."""
        cbs, cfg = self.spec.codebooks, self.spec.cfg
        if cfg is None:
            return 0
        if isinstance(cbs, QTensor):
            return cfg.num_factors if cbs.values.dtype == torch.int8 else 0
        return 1 if fz.fused_sweep_eligible(cfg) else 0

    def bind_obs(self, obs, track: str | None = None) -> None:
        """Adopt a recorder after construction: an engine built with the
        default clock adopts the recorder's; an explicit ``clock=`` stays."""
        self.obs = obs
        if track is not None:
            self.obs_track = track
        if self._default_clock:
            self._clock = obs.clock
        self._record_structure()

    # -- request intake ----------------------------------------------------

    def submit(self, queries, *, generator=None, keys=None, meta=None,
               priority: int = 0, max_iters: int | None = None) -> int:
        """Enqueue a request of one or more query vectors; returns its id.

        ``keys`` (int64 ``[k, 2]``, one per query) pins each query's key;
        otherwise keys are drawn from ``generator`` (or the engine's own).
        ``priority`` orders the queue (lower serves first; FIFO within a
        priority).  ``max_iters`` caps this request's resonator iteration
        budget below ``cfg.max_iters``.
        """
        if max_iters is not None and max_iters < 1:
            raise ValueError(f"max_iters must be >= 1, got {max_iters}")
        queries = torch.as_tensor(queries, dtype=torch.float32,
                                  device=self.device)
        if queries.ndim == 1:
            queries = queries[None]
        k = queries.shape[0]
        if keys is None:
            keys = fz.draw_keys(self._gen if generator is None else generator, k)
        if not isinstance(keys, torch.Tensor):
            keys = torch.from_numpy(np.asarray(keys).astype(np.int64))
        keys = keys.to(dtype=torch.int64, device=self.device)
        if keys.shape != (k, 2):
            raise ValueError(f"keys must be [{k}, 2], got {tuple(keys.shape)}")
        req = Request(self._next_id, queries, keys, meta, self._clock(),
                      self.sweeps_total, priority=int(priority),
                      iter_budget=max_iters)
        req.rows = [None] * k
        self._next_id += 1
        for qi in range(k):
            self._requeue(req, qi)
        self.obs.count("submitted", 1, engine=self.obs_track)
        return req.id

    # -- serving loop ------------------------------------------------------

    def _requeue(self, req: Request, qi: int) -> None:
        heapq.heappush(self._queue, (req.priority, req.id, qi, req))

    def _pop_next(self):
        """Queue discipline: lowest ``(priority, id, qi)`` first (exact FIFO
        under uniform priorities; a re-queued row resumes ahead of
        same-priority newcomers, whose ids are newer).  Returns
        ``(request, query_index)``."""
        _, _, qi, req = heapq.heappop(self._queue)
        return req, qi

    def _fill(self) -> None:
        with self.obs.span("slot-scan", track=self.obs_track,
                           cat="engine") as sp:
            if sp is not None:
                sp.args["queued"] = len(self._queue)
            fills = []
            for slot in range(self.slots):
                if self._owner[slot] is not None or not self._queue:
                    continue
                req, qi = self._pop_next()
                self._owner[slot] = (req, qi)
                fills.append((slot, req.queries[qi], req.keys[qi]))
            if sp is not None:
                sp.args["rows"] = len(fills)
        if not fills:
            return
        with self.obs.span("fill", track=self.obs_track, cat="engine",
                           args={"rows": len(fills)}):
            self.qs, self.state = self._refill_many(
                self.qs, self.state, [s for s, _, _ in fills],
                torch.stack([q for _, q, _ in fills]),
                torch.stack([k for _, _, k in fills]))

    def _retire(self) -> list:
        done = self.state.done.cpu().numpy()
        iters = self.state.iters.cpu().numpy()
        max_it = self.spec.cfg.max_iters

        def budget(req):
            # Per-request brownout trim: retire at the smaller cap, host-side
            # at burst granularity.
            b = req.iter_budget
            return max_it if b is None else min(max_it, b)

        ripe = [s for s in range(self.slots)
                if self._owner[s] is not None
                and (done[s] or iters[s] >= budget(self._owner[s][0]))]
        if not ripe:
            return []
        with self.obs.span("decode", track=self.obs_track, cat="engine"):
            res = fz.FactorizerResult(*(t.cpu().numpy() for t in
                                        self._decode(self.qs, self.state)))
        finished = []
        with self.obs.span("finalize", track=self.obs_track, cat="engine"):
            for s in ripe:
                req, qi = self._owner[s]
                self._owner[s] = None
                req.rows[qi] = fz.FactorizerResult(*(a[s] for a in res))
                if all(r is not None for r in req.rows):
                    self._finalize(req)
                    finished.append(req)
        return finished

    def _finalize(self, req: Request) -> None:
        req.factorization = fz.FactorizerResult(
            *(np.stack(col) for col in zip(*req.rows)))
        req.iterations = req.factorization.iterations
        req.done_time = self._clock()
        req.done_sweep = self.sweeps_total
        if self.spec.postprocess is None:
            req.result = req.factorization
        else:
            with self.obs.span("postprocess", track=self.obs_track,
                               cat="engine"):
                req.result = self.spec.postprocess(req.queries,
                                                   req.factorization, req.meta)
        self.completed[req.id] = req
        self.completed_total += 1
        self._lat_sum += req.latency_s
        self._lat_window.append(req.latency_s)
        del self._lat_window[:-LAT_WINDOW_CAP]

    def step(self) -> list:
        """Fill free slots, run one adSCH-sized sweep burst, retire converged
        rows.  Returns the requests completed by this step."""
        obs = self.obs
        with obs.span("step", track=self.obs_track, cat="engine") as sp:
            self._fill()
            if all(o is None for o in self._owner):
                return []
            with obs.span("sweep-burst", track=self.obs_track,
                          cat="engine") as bp:
                self.state, n = self._sweeps(self.qs, self.state,
                                             self.sweeps_per_step)
            self.sweeps_total += n
            self.steps_total += 1
            with obs.span("retire", track=self.obs_track, cat="engine"):
                finished = self._retire()
        if obs.enabled:
            bp.args["sweeps"] = n
            sp.args.update(sweeps=n, retired=len(finished))
            obs.count("steps", 1, engine=self.obs_track)
            obs.count("sweeps", n, engine=self.obs_track)
            if finished:
                obs.count("completed", len(finished), engine=self.obs_track)
        return finished

    def drain(self, max_steps: int = 100_000) -> list:
        """Run until every submitted request completed; returns them all
        (submission order)."""
        out = []
        for _ in range(max_steps):
            if not self._queue and all(o is None for o in self._owner):
                break
            out += self.step()
        else:
            raise RuntimeError("drain() exceeded max_steps")
        return sorted(out, key=lambda r: r.id)

    # -- online re-tuning --------------------------------------------------

    def resize(self, slots: int) -> None:
        """Warm handoff to a resized ``[slots, F, D]`` state.

        In-flight slot rows move into the new state verbatim (est / iters /
        done / sim / keys), so a live request's remaining trajectory is the
        one it would have run in the old state.  When shrinking below the
        live-row count, the overflow rows go back to the queue, ahead of
        same-priority newcomers, and re-run from scratch once a slot frees:
        wasted sweeps, but the same trajectory.  The sweep burst is
        re-derived unless the constructor pinned it.
        """
        if slots < 1:
            raise ValueError(f"resize needs at least 1 slot, got {slots}")
        if slots == self.slots:
            return
        rsid = self.obs.begin("resize", track=self.obs_track, cat="engine",
                              args={"from": self.slots, "to": slots})
        live = [(s, self._owner[s]) for s in range(self.slots)
                if self._owner[s] is not None]
        keep, overflow = live[:slots], live[slots:]
        for _, owner in overflow:
            self._requeue(*owner)
        old_qs, old_state = self.qs, self.state
        self.slots = slots
        if not self._sweeps_pinned:
            self.sweeps_per_step = self._derive_sweeps_per_step()
        self._build_programs()  # fresh parked state
        self._owner = [None] * slots
        if keep:
            rows = torch.tensor([s for s, _ in keep], device=self.device)
            j = len(keep)
            for i, (_, owner) in enumerate(keep):
                self._owner[i] = owner
            self.qs[:j] = old_qs[rows]
            for new, old in zip(self.state[:-1], old_state[:-1]):
                new[:j] = old[rows]
        self.state = self.state._replace(it=old_state.it)
        self.resizes_total += 1
        self._step_cost_cache = None
        self.obs.end(rsid, args={"carried": len(keep),
                                 "requeued": len(overflow)})
        self.obs.count("resizes", 1, engine=self.obs_track)

    # -- fault tolerance ---------------------------------------------------

    def recover(self) -> int:
        """Rebuild after a fault and replay in-flight work; returns the
        number of replayed (request, query) rows.

        The slot state is rebuilt from scratch (whatever the fault left
        behind is discarded) and every live slot row goes back to the queue
        ahead of same-priority newcomers, in its original submission order,
        to re-run from its pinned key: the recovered trajectory equals a
        fault-free run's.
        """
        with self.obs.span("recover", track=self.obs_track,
                           cat="engine") as sp:
            live = [(s, self._owner[s]) for s in range(self.slots)
                    if self._owner[s] is not None]
            for _, owner in live:
                self._requeue(*owner)
            self._build_programs()
            self._owner = [None] * self.slots
            self.recoveries_total += 1
            if sp is not None:
                sp.args["replayed"] = len(live)
        return len(live)

    def _park(self, slots: list) -> None:
        done = self.state.done.clone()
        done[torch.tensor(slots, device=self.device)] = True
        self.state = self.state._replace(done=done)

    def preempt(self, request_id: int) -> int:
        """Park ``request_id``'s live slot rows and RE-QUEUE them ahead of
        same-priority newcomers; they re-run from scratch off their pinned
        keys once a slot frees, so the trajectory equals an undisturbed
        run's.  Returns the number of rows re-queued."""
        parked = [s for s in range(self.slots)
                  if self._owner[s] is not None
                  and self._owner[s][0].id == request_id]
        if not parked:
            return 0
        for s in parked:
            self._requeue(*self._owner[s])
            self._owner[s] = None
        self._park(parked)
        self.obs.instant("preempt", track=self.obs_track, cat="engine",
                         args={"request": request_id, "rows": len(parked)})
        return len(parked)

    def cancel(self, request_id: int) -> bool:
        """Cancel request `request_id`: drop its queued rows and park its
        live slots.  Other rows' trajectories are untouched.  Returns
        whether anything was reclaimed (False for unknown/completed ids)."""
        before = len(self._queue)
        self._queue = [e for e in self._queue if e[1] != request_id]
        heapq.heapify(self._queue)
        reclaimed = len(self._queue) < before
        parked = [s for s in range(self.slots)
                  if self._owner[s] is not None
                  and self._owner[s][0].id == request_id]
        for s in parked:
            self._owner[s] = None
        if parked:
            self._park(parked)
        if reclaimed or parked:
            self.obs.instant("cancel", track=self.obs_track, cat="engine",
                             args={"request": request_id,
                                   "parked_slots": len(parked)})
        return reclaimed or bool(parked)

    def health_check(self) -> str | None:
        """Non-finite resonator state on any LIVE row; returns a description
        for a supervisor to quarantine on, or None when healthy."""
        live = [s for s in range(self.slots) if self._owner[s] is not None]
        if not live:
            return None
        finite = torch.isfinite(self.state.est[torch.tensor(
            live, device=self.device)]).flatten(1).all(dim=1).cpu().numpy()
        bad = [s for s, ok in zip(live, finite) if not ok]
        if bad:
            return f"non-finite resonator state in slot rows {bad}"
        return None

    # -- introspection -----------------------------------------------------

    @property
    def in_flight(self) -> int:
        return sum(o is not None for o in self._owner) + len(self._queue)

    def live_requests(self) -> dict:
        """``{request_id: {"priority": p, "rows": n}}`` for slotted rows."""
        out: dict = {}
        for o in self._owner:
            if o is not None:
                d = out.setdefault(o[0].id,
                                   {"priority": o[0].priority, "rows": 0})
                d["rows"] += 1
        return out

    def queued_requests(self) -> dict:
        """``{request_id: {"priority": p, "rows": n}}`` for queued rows."""
        out: dict = {}
        for *_, req in self._queue:
            d = out.setdefault(req.id,
                               {"priority": req.priority, "rows": 0})
            d["rows"] += 1
        return out

    def step_cost_s(self) -> float:
        """adSCH-modeled seconds of one ``step()`` burst on the modeled
        CogSys array (not the card).  Cached; changes only on resize."""
        if self._step_cost_cache is None:
            ops = step_unit_ops(self.spec, self.slots)
            t_unit = sch.schedule(ops, self.hw).makespan / self.hw.freq_hz
            self._step_cost_cache = self.sweeps_per_step * t_unit
        return self._step_cost_cache

    def snapshot(self, reset: bool = False) -> dict:
        """Unified-schema counters + rolling latency percentiles.

        ``reset=False`` (the default) is non-destructive; ``reset=True``
        drains the rolling latency window.  Totals always accumulate.
        """
        lats = self._lat_window
        if reset:
            self._lat_window = []
        return {
            "engine_kind": self.engine_kind,
            "slots": self.slots,
            "units_per_step": self.sweeps_per_step,
            "units_total": self.sweeps_total,
            "sweeps_per_step": self.sweeps_per_step,
            "steps": self.steps_total,
            "sweeps_total": self.sweeps_total,
            "completed": self.completed_total,
            "resizes": self.resizes_total,
            "recoveries": self.recoveries_total,
            "window_completed": len(lats),
            **rolling_latency_ms(lats),
            "latency_mean_all_ms": (self._lat_sum / self.completed_total * 1e3
                                    if self.completed_total else None),
        }

    def stats(self) -> dict:
        """Read-and-reset snapshot (drains the latency window)."""
        return self.snapshot(reset=True)
