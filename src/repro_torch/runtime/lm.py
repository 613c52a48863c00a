"""LMEngine: transformer serving behind the engine-style Steppable API.

The port of ``repro/runtime/lm.py``.  ``launch/serve.ServeEngine`` is the
device layer (masked batch decode over a shared KV cache, per-slot prefill); this
adapter adds the request layer the factorizer ``Engine`` already has —
queueing, slot ownership, burst-scan retirement, per-request latency
accounting (``runtime/runtime.py::Runtime`` interleaves it with the
factorization engines, as the reference's does).

With ``paged=PagedConfig(...)`` (or ``REPRO_LM_PAGED=1`` in the
environment) the device layer serves from the block-table KV pool
(:mod:`repro_torch.lm.paging`): chunked prefill, flash-decode attention
(the CUDA kernel on the card), and —
the piece the contiguous layout could never offer — :meth:`resize` as a
block-table edit, so the Runtime's EWMA re-tuner warm-hands-off the LM
engine exactly like the factorizer engines (in-flight slots carried
bit-equal).  On the contiguous layout :meth:`resize` still exists but
replays: live requests re-queue from their pinned prompts (deterministic
decode makes the replayed tokens bit-equal, the ``recover()`` argument).

The adSCH connection runs through the registered ``lm_decode`` spec
(:mod:`repro_torch.engine.pipelines`): its StageGraph declares prefill as the
neural block and per-token decode as the sliver-filling stream, and its
``step_ops`` price one decode token over the slot batch — so the SAME
:func:`repro_torch.engine.engine.derive_sweeps_per_step` that sizes
resonator sweep bursts sizes the decode burst between retirement scans here
(``decode_per_step``).

Retirement is at burst granularity (like the factorizer engine's sweep
bursts): a slot may overshoot its stop condition by up to
``decode_per_step - 1`` tokens; the finished request's ``tokens`` are
trimmed to ``max_new_tokens`` / first EOS, and a slot parked by the device
layer's KV-capacity guard retires with ``truncated=True``.
"""
from __future__ import annotations

import dataclasses
import os
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch.cogsim import model as hw_model
from repro_torch.core import scheduler as sch
from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.engine import registry
from repro_torch.engine.engine import (LAT_WINDOW_CAP, derive_sweeps_per_step,
                                       rolling_latency_ms, step_unit_ops)
from repro_torch.launch.serve import ServeEngine, as_tokens
from repro_torch.lm.paging import PagedConfig
from repro_torch.lm.sampling import SamplingSpec


@dataclasses.dataclass
class LMRequest:
    """One submitted generation request."""

    id: int
    prompt: Any  # [T] int64 numpy tokens
    max_new_tokens: int
    meta: Any
    submit_time: float
    sampling: SamplingSpec | None = None  # None = greedy
    priority: int = 0  # queue order: lower serves first (fleet classes)
    tokens: list = dataclasses.field(default_factory=list)  # generated ids
    result: Any = None  # {"tokens": ..., "text_len": ...} convenience dict
    truncated: bool = False  # KV capacity parked the slot before a stop
    done_time: float | None = None

    @property
    def latency_s(self) -> float | None:
        return None if self.done_time is None else \
            self.done_time - self.submit_time


def _resolve_paged(paged) -> PagedConfig | None:
    if paged is None:
        return PagedConfig() if os.environ.get("REPRO_LM_PAGED") else None
    if paged is True:
        return PagedConfig()
    if paged is False:
        return None
    return paged  # ServeEngine type-checks the PagedConfig


class LMEngine:
    """``submit()/step()/drain()`` continuous batching over ``ServeEngine``.

    Satisfies the reference's ``runtime.protocol.Steppable``; requests are
    token prompts instead of query vectors, results are generated token
    lists.  ``params`` is the port's :class:`repro_torch.nn.transformer.LM`
    on ``device`` (default ``"cuda"``).
    """

    engine_kind = "lm"  # unified stats schema discriminator

    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 128,
                 prompt_len_hint: int = 16, decode_per_step: int | None = None,
                 eos_id: int | None = None, paged=None, hw=hw_model.COGSYS,
                 obs=None, clock=None, device=DEFAULT_DEVICE):
        self.cfg, self.hw = cfg, hw
        self.device = resolve(device)
        self.slots = slots
        self.eos_id = eos_id
        self.paged = _resolve_paged(paged)
        self._prompt_len_hint = prompt_len_hint
        self._dps_pinned = decode_per_step is not None
        # Observability seam, mirroring Engine: spans/counters around the
        # device dispatches, NULL default, one clock (see Engine.bind_obs).
        self.obs = obs if obs is not None else obs_mod.NULL
        self.obs_track = "lm"
        self._default_clock = clock is None
        self._clock = clock if clock is not None else self.obs.clock
        # kept for fault recovery: recover() rebuilds the device layer from
        # these (params are read-only serving state, never mutated by decode)
        self._params, self._max_len = params, max_len
        self.serve = self._make_serve(slots)
        self.spec = self._build_spec(slots)
        self.decode_per_step = (
            derive_sweeps_per_step(self.spec, slots, hw)
            if decode_per_step is None else decode_per_step)
        self._owner: list = [None] * slots  # LMRequest | None
        self._queue: deque = deque()
        self._next_id = 0
        self.completed: dict = {}
        self.completed_total = 0  # all-time (runtime may evict `completed`)
        self.steps_total = 0
        self.tokens_total = 0
        self.recoveries_total = 0
        self.resizes_total = 0
        self._lat_sum = 0.0
        self._lat_window: list = []
        self._step_cost = self._modeled_step_cost()
        self._record_structure()

    def _make_serve(self, slots: int, paged="inherit") -> ServeEngine:
        return ServeEngine(self.cfg, self._params, slots, self._max_len,
                           paged=self.paged if paged == "inherit" else paged,
                           obs=self.obs, obs_track=self.obs_track,
                           device=self.device)

    def _record_structure(self) -> None:
        if not self.obs.enabled:
            return
        track = self.obs_track
        self.obs.gauge("slots", self.slots, engine=track)
        self.obs.gauge("units_per_step", self.decode_per_step, engine=track)
        self.obs.gauge("paged", int(self.paged is not None), engine=track)

    def bind_obs(self, obs, track: str | None = None) -> None:
        """Adopt a recorder after construction (see ``Engine.bind_obs``);
        also rebinds the device layer so prefill-chunk spans and dispatch
        counters land in the same registry."""
        self.obs = obs
        if track is not None:
            self.obs_track = track
        if self._default_clock:
            self._clock = obs.clock
        self.serve.obs = obs
        self.serve.obs_track = self.obs_track
        self._record_structure()

    def _build_spec(self, slots: int):
        return registry.build(
            "lm_decode", None, cfg=self.cfg, batch=slots,
            prompt_len=self._prompt_len_hint, max_len=self._max_len,
            kv_block=None if self.paged is None else self.paged.block_size)

    def _modeled_step_cost(self) -> float:
        ops = step_unit_ops(self.spec, self.slots)
        return self.decode_per_step * (
            sch.schedule(ops, self.hw).makespan / self.hw.freq_hz)

    # -- request intake ----------------------------------------------------

    def submit(self, prompt, *, max_new_tokens: int = 32, meta=None,
               sampling: SamplingSpec | None = None,
               priority: int = 0) -> int:
        """Enqueue one prompt; returns the request id.  Prompts that cannot
        fit the KV capacity at all are rejected here (the per-token guard
        then parks slots that fill up mid-generation).  ``sampling`` picks
        temperature/top-k decoding for this request (None = greedy); the
        per-request seed makes replay after recover/resize bit-equal.
        ``priority`` orders the queue (lower serves first; FIFO within a
        priority)."""
        if np.ndim(prompt) != 1:
            raise ValueError("submit expects a non-empty 1-D token prompt")
        prompt = as_tokens(prompt)
        if prompt.shape[0] == 0:
            raise ValueError("submit expects a non-empty 1-D token prompt")
        if prompt.shape[0] > self.serve.slot_capacity:
            raise ValueError(
                f"prompt of {prompt.shape[0]} tokens exceeds the engine's "
                f"KV capacity {self.serve.slot_capacity}")
        if sampling is not None and not isinstance(sampling, SamplingSpec):
            raise TypeError(
                f"sampling= expects a SamplingSpec or None, got {sampling!r}")
        req = LMRequest(self._next_id, prompt, int(max_new_tokens), meta,
                        self._clock(), sampling=sampling,
                        priority=int(priority))
        self._next_id += 1
        self._queue.append(req)
        self.obs.count("submitted", 1, engine=self.obs_track)
        return req.id

    # -- serving loop ------------------------------------------------------

    def _next_index(self) -> int:
        """Queue discipline: lowest ``(priority, id)`` first.  Request ids
        are monotonic, so uniform priorities reduce to exact FIFO."""
        best_i, best = 0, None
        for i, req in enumerate(self._queue):
            k = (req.priority, req.id)
            if best is None or k < best:
                best_i, best = i, k
        return best_i

    def _fill(self) -> None:
        for slot in range(self.slots):
            if self._owner[slot] is not None or not self._queue:
                continue
            i = self._next_index()
            req = self._queue[i]
            # paged: a drained pool defers admission (priority order
            # preserved — the BEST candidate parks) until retiring slots
            # release blocks — parking, not rejection
            if not self.serve.can_admit(int(req.prompt.shape[0])):
                break
            del self._queue[i]
            self._owner[slot] = req
            self.serve.add_request(slot, req.prompt, sampling=req.sampling)

    def _stop_at(self, req: LMRequest, produced: list) -> int | None:
        """Index (exclusive) to trim `produced` at, or None if not done."""
        if self.eos_id is not None and self.eos_id in produced:
            return min(produced.index(self.eos_id) + 1, req.max_new_tokens)
        if len(produced) >= req.max_new_tokens:
            return req.max_new_tokens
        return None

    def _retire(self) -> list:
        finished = []
        for slot in range(self.slots):
            req = self._owner[slot]
            if req is None:
                continue
            # generated[0] is the seeded last prompt token, not an output
            produced = self.serve.generated[slot][1:]
            stop = self._stop_at(req, produced)
            if stop is None and not self.serve.overflowed[slot]:
                continue
            req.truncated = stop is None  # parked at KV capacity
            req.tokens = produced[:stop] if stop is not None else produced
            req.done_time = self._clock()
            req.result = {"tokens": req.tokens, "truncated": req.truncated}
            self.tokens_total += len(req.tokens)
            self.completed[req.id] = req
            self.completed_total += 1
            self._lat_sum += req.latency_s
            self._lat_window.append(req.latency_s)
            del self._lat_window[:-LAT_WINDOW_CAP]
            self._owner[slot] = None
            self.serve.release_slot(slot)  # paged: blocks back to the pool
            finished.append(req)
        return finished

    @torch.no_grad()
    def step(self) -> list:
        """Fill free slots (prefill), run one adSCH-sized decode burst,
        retire finished slots (under ``torch.no_grad()``: serving builds no
        graph).  Returns the requests completed this step."""
        obs = self.obs
        with obs.span("step", track=self.obs_track, cat="engine") as sp:
            with obs.span("fill", track=self.obs_track, cat="engine"):
                self._fill()
            if all(o is None for o in self._owner):
                return []
            with obs.span("decode-burst", track=self.obs_track,
                          cat="engine") as bp:
                n = 0
                for _ in range(self.decode_per_step):
                    # every live slot parked at capacity ends the burst early
                    if self.serve.step() is None:
                        break
                    n += 1
            self.steps_total += 1
            with obs.span("retire", track=self.obs_track, cat="engine"):
                finished = self._retire()
        if obs.enabled:
            bp.args["decodes"] = n
            sp.args.update(decodes=n, retired=len(finished))
            obs.count("steps", 1, engine=self.obs_track)
            obs.count("decode_steps", n, engine=self.obs_track)
            if finished:
                obs.count("completed", len(finished), engine=self.obs_track)
                obs.count("tokens",
                          sum(len(r.tokens) for r in finished),
                          engine=self.obs_track)
        return finished

    def drain(self, max_steps: int = 100_000) -> list:
        out = []
        for _ in range(max_steps):
            if not self._queue and all(o is None for o in self._owner):
                break
            out += self.step()
        else:
            raise RuntimeError("drain() exceeded max_steps")
        return sorted(out, key=lambda r: r.id)

    # -- warm handoff ------------------------------------------------------

    def resize(self, new_slots: int) -> None:
        """Re-tune the slot count mid-run (the Runtime's EWMA re-tuner calls
        this through the same ``Engine.resize`` contract as the factorizer
        engines).

        Paged: a block-table edit — the first ``new_slots`` live requests
        keep their physical KV blocks and host state verbatim (bit-equal
        trajectories across the resize); displaced live requests re-queue
        at the FRONT in slot order and replay from their pinned prompts.
        Contiguous: the cache cannot re-slot without a reshape, so EVERY
        live request replays (deterministic greedy / seeded sampling makes
        the regenerated tokens bit-equal — the ``recover()`` argument).
        """
        if new_slots < 1:
            raise ValueError(f"resize needs >= 1 slot, got {new_slots}")
        if new_slots == self.slots:
            return
        rsid = self.obs.begin("resize", track=self.obs_track, cat="engine",
                              args={"from": self.slots, "to": new_slots})
        live = [(s, self._owner[s]) for s in range(self.slots)
                if self._owner[s] is not None]
        if self.paged is not None:
            keep, overflow = live[:new_slots], live[new_slots:]
            for _, req in reversed(overflow):
                self._queue.appendleft(req)
            self.serve.resize(new_slots, [s for s, _ in keep])
            self._owner = [req for _, req in keep] + \
                [None] * (new_slots - len(keep))
        else:
            keep, overflow = [], live
            for _, req in reversed(live):
                self._queue.appendleft(req)
            self.serve = self._make_serve(new_slots, paged=None)
            self._owner = [None] * new_slots
        self.slots = new_slots
        self.spec = self._build_spec(new_slots)
        if not self._dps_pinned:
            self.decode_per_step = derive_sweeps_per_step(
                self.spec, new_slots, self.hw)
        self._step_cost = self._modeled_step_cost()
        self.resizes_total += 1
        self._record_structure()
        self.obs.end(rsid, args={"carried": len(keep),
                                 "requeued": len(overflow)})
        self.obs.count("resizes", 1, engine=self.obs_track)

    # -- fault tolerance ---------------------------------------------------

    def recover(self) -> int:
        """Rebuild the device layer after a fault and replay in-flight
        generations; returns the number of replayed requests.

        A fresh :class:`ServeEngine` replaces the (possibly corrupt) KV
        state and slot bookkeeping; live requests re-queue at the FRONT in
        submission order and re-run prefill + decode from their pinned
        prompts.  Greedy decode is deterministic and sampled requests
        re-derive their keys from (seed, position), so a replayed request's
        tokens are bit-equal to a fault-free run — partially generated
        tokens are simply regenerated (``_retire`` reads the device layer's
        ``generated``, which the rebuild reset).
        """
        with self.obs.span("recover", track=self.obs_track,
                           cat="engine") as sp:
            live = [req for req in self._owner if req is not None]
            for req in reversed(live):
                self._queue.appendleft(req)
            self.serve = self._make_serve(self.slots)
            self._owner = [None] * self.slots
            self.recoveries_total += 1
            if sp is not None:
                # "recoveries" as a metric is supervision-scoped (counted by
                # the runtime's quarantine service); the engine keeps the span
                sp.args["replayed"] = len(live)
        return len(live)

    def preempt(self, request_id: int) -> int:
        """Bit-safe preemption: free the request's slot (the device layer
        stops decoding it and, when paged, returns its KV blocks to the
        pool) and RE-QUEUE it at the front — the :meth:`recover` contract.
        On re-fill it prefills from scratch; deterministic greedy decoding
        (and the per-request sampling seed) regenerates the same token
        stream, so the replayed stream is bit-equal to an undisturbed run,
        just later.  Queued requests are untouched.  Returns 1 when a live
        slot was preempted, else 0.
        """
        for slot, req in enumerate(self._owner):
            if req is not None and req.id == request_id:
                self._owner[slot] = None
                self.serve.release_slot(slot)
                self._queue.appendleft(req)
                self.obs.instant("preempt", track=self.obs_track,
                                 cat="engine",
                                 args={"request": request_id, "rows": 1})
                return 1
        return 0

    def cancel(self, request_id: int) -> bool:
        """Cancel one request: drop it from the queue or free its slot
        (the device layer stops decoding it and, when paged, returns its
        KV blocks to the pool).  Work is discarded — see :meth:`preempt`
        for the bit-safe re-queue flavor.  Returns whether anything was
        reclaimed.
        """
        for i, req in enumerate(self._queue):
            if req.id == request_id:
                del self._queue[i]
                return True
        for slot, req in enumerate(self._owner):
            if req is not None and req.id == request_id:
                self._owner[slot] = None
                self.serve.release_slot(slot)
                return True
        return False

    # -- introspection -----------------------------------------------------

    @property
    def in_flight(self) -> int:
        return sum(o is not None for o in self._owner) + len(self._queue)

    def live_requests(self) -> dict:
        """``{request_id: {"priority": p, "rows": 1}}`` for slotted requests
        — the fleet controller's preemption-victim view."""
        return {req.id: {"priority": req.priority, "rows": 1}
                for req in self._owner if req is not None}

    def queued_requests(self) -> dict:
        """``{request_id: {"priority": p, "rows": 1}}`` for queued requests."""
        return {req.id: {"priority": req.priority, "rows": 1}
                for req in self._queue}

    def step_cost_s(self) -> float:
        return self._step_cost

    def snapshot(self, reset: bool = False) -> dict:
        """Unified-schema counters (see ``Engine.snapshot``: a *unit* here
        is one generated decode token).  ``reset=False`` is non-destructive;
        ``reset=True`` drains the rolling latency window.  LM-specific keys
        (``decode_per_step``/``tokens_total``, dispatch + KV-byte structural
        counters) ride along."""
        lats = self._lat_window
        if reset:
            self._lat_window = []
        return {
            "engine_kind": self.engine_kind,
            "slots": self.slots,
            "units_per_step": self.decode_per_step,
            "units_total": self.tokens_total,
            "decode_per_step": self.decode_per_step,
            "paged": self.paged is not None,
            "steps": self.steps_total,
            "completed": self.completed_total,
            "tokens_total": self.tokens_total,
            "recoveries": self.recoveries_total,
            "resizes": self.resizes_total,
            "prefill_dispatches": self.serve.prefill_dispatches,
            "decode_dispatches": self.serve.decode_dispatches,
            "kv_bytes_touched": self.serve.kv_bytes_touched,
            "window_completed": len(lats),
            **rolling_latency_ms(lats),
            "latency_mean_all_ms": (self._lat_sum / self.completed_total * 1e3
                                    if self.completed_total else None),
        }

    def stats(self) -> dict:
        """Read-and-reset snapshot (see ``Engine.stats``)."""
        return self.snapshot(reset=True)
