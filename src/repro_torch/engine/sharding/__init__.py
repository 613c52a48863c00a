"""repro_torch.engine.sharding — mesh-parallel serving of registered pipelines.

The port of the reference package's ``engine/sharding``:

  * :class:`ShardedEngine` — the same ``submit()/step()/drain()`` engine on
    a ``data x model`` mesh (:mod:`repro_torch.launch.mesh`): slot rows
    split over ``data``, codebooks either replicate or split their rows
    over ``model`` with reduced similarity scores
    (``codebook_placement="rows"``);
  * :func:`choose_slots` — adSCH-cost-model autotuner picking slots per
    shard from (modeled or measured) sweep cost and the arrival rate;
  * :func:`shard_ops` / :func:`shard_graph` — cost-side transforms that
    rescale scheduler op graphs to one device's slice and surface the
    cross-shard collectives.
"""
from repro_torch.engine.sharding.autotune import (choose_slots,
                                                  measure_sweep_seconds,
                                                  modeled_sweep_seconds,
                                                  service_rate_rps)
from repro_torch.engine.sharding.costs import shard_graph, shard_ops
from repro_torch.engine.sharding.engine import ShardedEngine

__all__ = [
    "ShardedEngine", "choose_slots", "measure_sweep_seconds",
    "modeled_sweep_seconds", "service_rate_rps", "shard_graph", "shard_ops",
]
