"""Lower a StageGraph to a software-pipelined stream runner.

The port of ``repro/engine/build.py``.  The lag/overlap structure is *chosen
by the adSCH scheduler*, not hard-coded: for every stage boundary,
:func:`plan_interleave` asks :func:`repro_torch.core.scheduler.schedule`
(the paper's offline greedy list scheduler, Sec. VI) whether overlapping the
downstream stages of task batch t-1 with the upstream stages of task batch t
would beat running them sequentially on the modeled cell pool.  Boundaries
with a real win get a one-batch lag; boundaries without are fused into the
same pipeline phase.

The runner runs ``K = depth`` phases as a fill/steady/drain pipeline from
one Python loop: at step s, phase j works on batch s - j (phases in order 0
.. K-1), so batches s .. s-K+1 are in flight in one step.  The reference
lowers the same schedule to a prologue, a ``lax.scan`` and an epilogue.  All
phases run on the current CUDA stream, so on the card the plan orders
the work but does not yet overlap it (ROADMAP: a stream per phase).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.cogsim import model as hw_model
from repro_torch.core import scheduler as sch
from repro_torch.device import generator as as_generator
from repro_torch.engine.stage import StageGraph, stage_ops


@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    """adSCH's verdict on a StageGraph's overlap structure."""

    lags: tuple  # per stage boundary: 1 = pipelined (one-batch lag), 0 = fused
    gains: tuple  # per boundary: sequential/interleaved makespan ratio
    makespan_seq: float  # whole-graph, strict batch order
    makespan_overlap: float  # whole-graph, adSCH interleaving

    @property
    def depth(self) -> int:
        """Task batches concurrently in flight in the lowered pipeline."""
        return 1 + sum(self.lags)


def _makespan(ops, hw, interleave: bool) -> float:
    return sch.schedule(ops, hw, interleave=interleave).makespan if ops else 0.0


def plan_interleave(graph: StageGraph, hw=hw_model.COGSYS, *,
                    min_gain: float = 1.05,
                    shards: tuple | None = None,
                    fused: bool | None = None) -> PipelinePlan:
    """Decide, per stage boundary, whether a one-batch lag pays off.

    Boundary i separates stages[:i+1] from stages[i+1:].  With lag 1, one
    pipeline step co-schedules ``tail(batch t-1)`` with ``head(batch t)``,
    so the decision is the adSCH question: does the list scheduler find
    enough idle cells during the head's neural blocks to hide the tail
    (Fig. 13c), or does the overlap run no faster than sequential?  A
    boundary is pipelined when the modeled speedup is >= ``min_gain``.

    ``shards=(data, model)`` plans the graph as ONE device of that mesh sees
    it: compute dims rescaled to the shard's slice and the cross-shard
    reductions priced as ``collective`` ops
    (:func:`repro_torch.engine.sharding.costs.shard_graph`).

    ``fused`` force-prices the fused resonator sweep on a graph whose
    symbolic hints were declared without it (True: projection legs become
    ``weight_resident``; False: restore two-pass pricing).  ``None`` keeps
    whatever the hints already carry.
    """
    if fused is not None:
        from repro_torch.engine.sharding.costs import mark_fused

        graph = mark_fused(graph, fused)
    if shards is not None:
        from repro_torch.engine.sharding.costs import shard_graph

        graph = shard_graph(graph, *shards)
    stages = graph.stages
    lags, gains = [], []
    for i in range(len(stages) - 1):
        tail = stage_ops(stages[i + 1:], 0)  # symbolic tail of batch t-1
        head = stage_ops(stages[:i + 1], 1)  # neural head of batch t
        if not tail or not head:
            lags.append(0)
            gains.append(1.0)
            continue
        seq = _makespan(tail + head, hw, interleave=False)
        over = _makespan(tail + head, hw, interleave=True)
        gain = seq / over if over > 0 else 1.0
        gains.append(gain)
        lags.append(1 if gain >= min_gain else 0)
    two = stage_ops(stages, 0) + stage_ops(stages, 1)
    return PipelinePlan(tuple(lags), tuple(gains),
                        makespan_seq=_makespan(two, hw, interleave=False),
                        makespan_overlap=_makespan(two, hw, interleave=True))


def _phase_groups(graph: StageGraph, plan: PipelinePlan) -> tuple:
    """Group stages into pipeline phases: a new phase starts after every
    boundary adSCH chose to pipeline."""
    groups, cur = [], [graph.stages[0]]
    for lag, st in zip(plan.lags, graph.stages[1:]):
        if lag:
            groups.append(tuple(cur))
            cur = [st]
        else:
            cur.append(st)
    groups.append(tuple(cur))
    return tuple(groups)


def _chain(stages) -> Callable:
    def fn(x, generator):
        for st in stages:
            x = st.fn(x, generator)
        return x
    return fn


def _tree_map(fn, *trees):
    """``fn`` over the tensors of equally shaped nested tuples / lists /
    dicts."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (tuple, list)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def batch_generators(generator, batches: int) -> list:
    """The per-batch generators of a stream: ``batches`` seeds drawn at once
    as ``torch.randint(0, 2**62, (batches,), generator=generator)``, batch
    t's generator a fresh CPU ``torch.Generator`` seeded with seed t.  The
    port's counterpart of the reference's ``jax.random.split(key, T)[t]``."""
    seeds = torch.randint(0, 2 ** 62, (batches,),
                          generator=as_generator(generator),
                          dtype=torch.int64)
    return [torch.Generator().manual_seed(int(s)) for s in seeds]


@dataclasses.dataclass(frozen=True)
class PipelineRunner:
    """A lowered StageGraph: ``runner(xs, generator) -> ys`` over a
    task-batch stream (leading axis T on every tensor of ``xs``)."""

    graph: StageGraph
    plan: PipelinePlan
    phase_names: tuple  # tuple[tuple[str, ...], ...]
    _run: Callable

    @property
    def depth(self) -> int:
        return self.plan.depth

    def __call__(self, xs, generator):
        return self._run(xs, generator)


def build_pipeline(graph: StageGraph, *, hw=hw_model.COGSYS,
                   plan: PipelinePlan | None = None,
                   min_gain: float = 1.05) -> PipelineRunner:
    """Lower ``graph`` to a pipelined stream runner of scheduler-chosen depth.

    Batch t's generator is :func:`batch_generators`\\ ``(generator, T)[t]``
    and is handed to every stage of that batch, so a pipelined run equals
    calling the stage chain per batch with those generators (and
    ``nvsa.solve``-style references).
    """
    if not graph.runnable:
        raise ValueError(f"graph {graph.name!r} has cost-model-only stages")
    plan = plan if plan is not None else plan_interleave(graph, hw,
                                                        min_gain=min_gain)
    groups = _phase_groups(graph, plan)
    phase_fns = [_chain(g) for g in groups]
    K = len(phase_fns)

    def run(xs, generator):
        T = _leaves(xs)[0].shape[0]
        gens = batch_generators(generator, T)
        bufs: list = [None] * K  # bufs[j]: phase j's output for its batch
        ys: list = []
        for s in range(T + K - 1):
            carried = list(bufs)
            for j in range(K):  # phase j works on batch s - j
                b = s - j
                if not 0 <= b < T:
                    continue
                x_in = _tree_map(lambda a: a[b], xs) if j == 0 \
                    else carried[j - 1]
                bufs[j] = phase_fns[j](x_in, gens[b])
                if j == K - 1:
                    ys.append(bufs[j])
        return _tree_map(lambda *ls: torch.stack(ls), *ys)

    return PipelineRunner(graph, plan, tuple(tuple(s.name for s in g)
                                             for g in groups), run)
