"""repro_torch.engine — the serving API of the port.

  * :class:`Engine` — ``submit()/step()/drain()`` continuous batching of
    reasoning requests over the batch-native factorizer;
  * :func:`repro_torch.engine.registry.build` — instantiate registered
    workloads (``nvsa_abduction``, ``lvrf_rows``, ``lm_decode``);
  * :func:`build_pipeline` / :func:`plan_interleave` — a StageGraph lowered
    to a stream runner whose stage lags adSCH chooses;
  * :class:`ShardedEngine` — the same engine on a ``data x model`` mesh
    (:mod:`repro_torch.engine.sharding`), with :func:`choose_slots`;
  * :class:`Stage` / :class:`StageGraph` — declared pipelines with adSCH
    cost hints, from which the engine sizes its sweep bursts.

Typical use::

    from repro_torch import engine
    spec = engine.registry.build("lvrf_rows", 0, fused_step=True)
    eng = engine.Engine(spec, slots=256)          # on the card
    rid = eng.submit(row_vec)
    done = eng.drain()
"""
from repro_torch.engine import registry
from repro_torch.engine import sharding
from repro_torch.engine.build import (PipelinePlan, PipelineRunner,
                                      batch_generators, build_pipeline,
                                      plan_interleave)
from repro_torch.engine.engine import (Engine, Request, derive_sweeps_per_step,
                                       rolling_latency_ms, step_unit_ops,
                                       sweep_cost_ops)
from repro_torch.engine.registry import ServeSpec
from repro_torch.engine.sharding import (ShardedEngine, choose_slots,
                                         measure_sweep_seconds,
                                         modeled_sweep_seconds,
                                         service_rate_rps, shard_graph,
                                         shard_ops)
from repro_torch.engine.stage import Stage, StageGraph, graph_ops, stage_ops
from repro_torch.kernels.resonator_step.ops import FusedConfig

from repro_torch.engine import pipelines as _builtin  # noqa: F401  (registers built-ins)

__all__ = [
    "Engine", "FusedConfig", "PipelinePlan", "PipelineRunner", "Request",
    "ServeSpec", "ShardedEngine", "Stage", "StageGraph", "batch_generators",
    "build_pipeline", "choose_slots", "derive_sweeps_per_step", "graph_ops",
    "measure_sweep_seconds", "modeled_sweep_seconds", "plan_interleave",
    "registry",
    "rolling_latency_ms", "service_rate_rps", "shard_graph", "shard_ops",
    "sharding", "stage_ops", "step_unit_ops", "sweep_cost_ops",
]
