"""Stage/StageGraph: declared neurosymbolic pipelines with scheduler cost hints.

A pipeline is a linear chain of :class:`Stage`\\ s.  Each stage carries

  * ``fn(x, generator) -> y`` — the batch computation on tensors (``x`` is
    the previous stage's output, or one element of the input stream for
    stage 0; ``generator`` is the *task-batch* ``torch.Generator`` or None);
  * ``cost_ops`` — :class:`repro_torch.core.scheduler.Op` cost hints
    describing the stage's work on the CogSys cell pool.  The engine prices
    its sweep burst against the neural stages' makespan with them
    (:func:`repro_torch.engine.engine.derive_sweeps_per_step`).

``graph_ops`` clones the per-stage hints across task batches into one
scheduler-ready op graph: intra-batch edges chain consecutive stages, and —
exactly as in the hardware scheduler's premise — *no* inter-batch edges
exist, which is what gives adSCH its interleaving freedom.
"""
from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class Stage:
    name: str
    fn: Callable | None  # (x, key) -> y;  None for cost-model-only graphs
    symbolic: bool = False
    cost_ops: tuple = ()  # tuple[Op, ...]; deps may only reference ops
    # of the same stage (cross-stage edges are added by graph_ops)

    def __post_init__(self):
        names = {op.name for op in self.cost_ops}
        for op in self.cost_ops:
            missing = set(op.deps) - names
            if missing:
                raise ValueError(
                    f"stage {self.name!r}: op {op.name!r} deps {missing} "
                    "not declared in the same stage")


@dataclasses.dataclass(frozen=True)
class StageGraph:
    name: str
    stages: tuple  # tuple[Stage, ...]

    def __post_init__(self):
        if not self.stages:
            raise ValueError("a StageGraph needs at least one stage")
        seen = set()
        for st in self.stages:
            if st.name in seen:
                raise ValueError(f"duplicate stage name {st.name!r}")
            seen.add(st.name)

    @property
    def runnable(self) -> bool:
        return all(st.fn is not None for st in self.stages)


def _terminals(stage: Stage) -> tuple:
    """Ops of `stage` nothing else in the stage depends on."""
    depended = {d for op in stage.cost_ops for d in op.deps}
    return tuple(op.name for op in stage.cost_ops if op.name not in depended)


def stage_ops(stages, batch: int) -> list:
    """Clone one batch's ops for a run of consecutive `stages`.

    Names are suffixed ``@b<batch>``; each stage's dependency-free ops gain
    edges from the previous stage's terminal ops (same batch).
    """
    out = []
    prev_terms: tuple = ()
    for st in stages:
        sfx = f"@b{batch}"
        terms = _terminals(st)
        for op in st.cost_ops:
            deps = tuple(d + sfx for d in op.deps)
            if not op.deps:
                deps = tuple(t + sfx for t in prev_terms)
            out.append(dataclasses.replace(
                op, name=op.name + sfx, deps=deps, batch=batch,
                symbolic=st.symbolic))
        if terms:
            prev_terms = terms
    return out


def graph_ops(graph: StageGraph, batches: int) -> list:
    """The full scheduler op graph for `batches` task batches (no inter-batch
    edges — interleaving freedom is the scheduler's to exploit)."""
    ops = []
    for t in range(batches):
        ops += stage_ops(graph.stages, t)
    return ops
