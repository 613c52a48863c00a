"""ShardedEngine: the request engine on a ``data x model`` mesh.

The port of the reference package's ``engine/sharding/engine.py``.  Slot
rows split over ``data``; codebooks either replicate (pure data-parallel
serving) or split their rows over ``model`` (``codebook_placement="rows"``),
in which case the resonator is built in its model-sharded mode: local-row
scores gathered with one packed reduction per factor (see
:func:`repro_torch.core.factorizer.make_resonator`).

One controller drives the mesh, as in the reference: host-side continuous
batching (queueing, slot ownership, retirement, resize, recover) is
inherited unchanged from :class:`repro_torch.engine.Engine`, whose global
``[slots, ...]`` state lives on the device of shard (0, 0) between device
programs.  Only the three programs differ: each splits the state into the
data shards' row ranges (views where the shards share a device), runs them
in lockstep, and gathers the result.  A sweep burst runs every data shard
for the same number of sweeps, until the live-row count summed over
``data`` is zero: the reference's uniform trip count.
"""
from __future__ import annotations

import torch

from repro_torch.cogsim import model as hw_model
from repro_torch.core import factorizer as fz
from repro_torch.core.quantization import QTensor
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.engine.engine import Engine, derive_sweeps_per_step
from repro_torch.engine.registry import ServeSpec
from repro_torch.engine.sharding.autotune import choose_slots
from repro_torch.launch import mesh as launch_mesh

PLACEMENTS = ("replicated", "rows")


class ShardedEngine(Engine):
    """``Engine`` on a mesh: rows over ``data``, codebooks per placement.

    ``mesh`` defaults to ``make_host_mesh(4, 2, device)``: eight logical
    shards on one device.  ``slots`` is the GLOBAL slot count (must divide
    by the data axis); leave it ``None`` to let :func:`choose_slots` pick
    slots per shard from the adSCH cost model and ``arrival_rps``.
    """

    engine_kind = "sharded_factorizer"

    def __init__(self, spec: ServeSpec, *, mesh=None,
                 codebook_placement: str = "replicated",
                 slots: int | None = None, arrival_rps: float | None = None,
                 sweeps_per_step: int | None = None, hw=hw_model.COGSYS,
                 generator=None, fused=None, obs=None, clock=None,
                 device=DEFAULT_DEVICE):
        self.mesh = (mesh if mesh is not None
                     else launch_mesh.make_host_mesh(device=device))
        self.data_shards = self.mesh.shape["data"]
        self.model_shards = self.mesh.shape["model"]
        if codebook_placement not in PLACEMENTS:
            raise ValueError(f"codebook_placement must be one of {PLACEMENTS}")
        self.codebook_placement = codebook_placement
        self._rows = codebook_placement == "rows" and self.model_shards > 1
        if codebook_placement == "rows":
            if isinstance(spec.codebooks, QTensor):
                raise ValueError("rows placement needs dense codebooks")
            M = spec.codebooks.shape[1]
            if M % self.model_shards:
                raise ValueError(
                    f"rows placement needs the model axis size "
                    f"({self.model_shards}) to divide the codebook rows ({M})")
        if slots is None:
            slots = self.data_shards * choose_slots(
                spec, arrival_rps=arrival_rps, data_shards=self.data_shards,
                model_shards=self.model_shards if self._rows else 1, hw=hw)
        if slots % self.data_shards:
            raise ValueError(f"the data axis size ({self.data_shards}) must "
                             f"divide slots ({slots})")
        self.decodes_total = 0
        super().__init__(spec, slots=slots, sweeps_per_step=sweeps_per_step,
                         hw=hw, generator=generator, fused=fused, obs=obs,
                         clock=clock, device=self.mesh.devices[0][0])

    # -- seams over the base engine ---------------------------------------

    def _derive_sweeps_per_step(self) -> int:
        return derive_sweeps_per_step(
            self.spec, self.slots, self.hw, data_shards=self.data_shards,
            model_shards=self.model_shards if self._rows else 1)

    def _build_programs(self) -> None:
        spec, mesh, slots = self.spec, self.mesh, self.slots
        cfg, mask, cb = spec.cfg, spec.valid_mask, spec.codebooks
        n_loc = slots // self.data_shards
        homes = [row[0] for row in mesh.devices]
        if self._rows:
            m_loc = cb.shape[1] // self.model_shards
            prs = fz.make_resonator(
                [cb[:, m * m_loc:(m + 1) * m_loc]
                 for m in range(self.model_shards)], cfg, mask,
                model_axis=mesh.axis("model"), full_rows=cb.shape[1],
                init_est=fz.superposition_init(cb, cfg, mask),
                fused=self.fused)
        else:  # one plain resonator per data shard, run side by side
            rss = [fz.make_resonator(
                cb.to(h), cfg, None if mask is None else mask.to(h),
                fused=self.fused) for h in homes]
            prs = fz.Resonator(
                init=lambda qs, keys: [r.init(q, k) for r, q, k
                                       in zip(rss, qs, keys)],
                sweep=lambda qs, ss: [r.sweep(q, s) for r, q, s
                                      in zip(rss, qs, ss)],
                active=lambda ss: [r.active(s) for r, s in zip(rss, ss)],
                decode=lambda qs, ss: [r.decode(q, s) for r, q, s
                                       in zip(rss, qs, ss)],
                refill=None,
                refill_many=lambda qs, ss, slots_, nqs, keys: tuple(
                    map(list, zip(*[
                        r.refill_many(q, s, sl, nq, k) if len(sl) else (q, s)
                        for r, q, s, sl, nq, k
                        in zip(rss, qs, ss, slots_, nqs, keys)]))))

        def split(x):
            """A global [slots, ...] tensor as its data shards' row ranges,
            each on its shard's home device."""
            return [x[d * n_loc:(d + 1) * n_loc].to(h)
                    for d, h in enumerate(homes)]

        def split_state(s):
            return [fz._State(*fields, s.it) for fields in
                    zip(*(split(t) for t in s[:-1]))]

        def gather(xs):
            return torch.cat([x.to(self.device) for x in xs])

        def gather_state(ss):
            return fz._State(*(gather(f) for f in zip(*(s[:-1] for s in ss))),
                             ss[0].it)

        def live(ss):
            """Live rows summed over ``data``: one data-axis reduction."""
            counts = [act.sum() for act in prs.active(ss)]
            parts = [[counts[d].to(dev) for dev in row]
                     for d, row in enumerate(mesh.devices)]
            return int(mesh.reduce("data", parts)[0][0])

        def sweeps(qs, s, budget: int):
            qs, ss = split(qs), split_state(s)
            n, alive = 0, live(ss)
            while n < budget and alive > 0:
                ss = prs.sweep(qs, ss)
                n += 1
                alive = live(ss)
            return gather_state(ss), n

        def refill_many(qs, s, idx, new_qs, keys):
            # global slot ids -> (data shard, local row)
            idx = torch.as_tensor(idx, dtype=torch.long)
            shard, row = idx // n_loc, idx % n_loc
            picks = [torch.nonzero(shard == d).squeeze(1)
                     for d in range(self.data_shards)]
            qs_sh, ss = prs.refill_many(
                split(qs), split_state(s), [row[p] for p in picks],
                [new_qs[p.to(new_qs.device)].to(h)
                 for p, h in zip(picks, homes)],
                [keys[p.to(keys.device)].to(h) for p, h in zip(picks, homes)])
            return gather(qs_sh), gather_state(ss)

        def decode(qs, s):
            self.decodes_total += 1
            res = prs.decode(split(qs), split_state(s))
            return fz.FactorizerResult(*(gather(f) for f in zip(*res)))

        self._sweeps, self._refill_many, self._decode = (sweeps, refill_many,
                                                         decode)
        # Parked initial state, the single-device engine's values.
        self.qs = torch.zeros((slots, spec.dim), dtype=torch.float32,
                              device=self.device)
        st = gather_state(prs.init(split(self.qs), split(torch.zeros(
            (slots, 2), dtype=torch.int64, device=self.device))))
        self.state = st._replace(done=torch.ones_like(st.done))
        self._record_structure()

    def _psums_per_sweep(self) -> int:
        """Cross-shard reductions one sweep issues: the live count over
        ``data``, plus, for rows placement, per factor one packed model
        reduction (two with score noise or softmax) and the one-hot
        convergence gather."""
        if not self._rows:
            return 1
        cfg = self.spec.cfg
        per_factor = 1 if (cfg.noise_std == 0 and cfg.activation in (
            "identity", "abs", "relu")) else 2
        return 1 + per_factor * cfg.num_factors + 1

    @property
    def kernel_launches_per_sweep(self) -> int:
        """Hand-written kernel launches per sweep: the single-device count
        once per data shard, and for rows placement once per shard (a fused
        spec launches the local kernel on each of the data x model
        shards)."""
        per = super().kernel_launches_per_sweep
        return per * self.data_shards * (self.model_shards if self._rows
                                         else 1)

    def resize(self, slots: int) -> None:
        """Warm handoff re-tune (see :meth:`Engine.resize`); the new global
        slot count must still tile over the data axis."""
        if slots % self.data_shards:
            raise ValueError(f"resize({slots}) must divide by the data axis "
                             f"size ({self.data_shards})")
        super().resize(slots)

    def recover(self) -> int:
        """Fault recovery on the mesh (see :meth:`Engine.recover`): the
        replay rebuilds through this class's ``_build_programs``, so the
        codebooks are placed again per ``codebook_placement`` and in-flight
        rows replay under the collectives contract they were served with."""
        return super().recover()

    def snapshot(self, reset: bool = False) -> dict:
        st = super().snapshot(reset)
        st.update({"mesh": dict(self.mesh.shape),
                   "codebook_placement": self.codebook_placement,
                   "slots_per_shard": self.slots // self.data_shards})
        return st
