"""Collective-aware cost transforms: per-shard op graphs for the scheduler.

A copy of the reference package's ``engine/sharding/costs.py``.  The adSCH
list scheduler (:mod:`repro_torch.core.scheduler`) prices an op graph on ONE
device's cell pool; a mesh-parallel engine runs each device on a slice of
the work plus the collectives stitching the slices together.  These
transforms rewrite a cost graph accordingly:

  * :func:`shard_ops` rescales compute dims to a single ``data`` shard's
    slice (requests/rows are the batch dimension everywhere in this repo);
  * :func:`shard_graph` additionally surfaces, for symbolic stages under
    ``model`` sharding, the psum that re-gathers every scoring GEMM's output
    across codebook-row shards, as ``collective`` ops priced with the
    NVLink constants of :mod:`repro_torch.launch.mesh`.

The factorizer's own sweep collectives are modeled exactly by
:func:`repro_torch.core.factorizer.sweep_cost_ops` (``model_shards=``); the
stage-level rule here is the generic first-order version for registered
graphs that only declare GEMM/conv/simd hints.

**Fused pricing.**  A gemm marked ``weight_resident`` (the projection leg of
a fused score->project pair, see ``Op.weight_resident``) consumes its
producer's stationary operand from on-chip memory: :func:`shard_ops`
preserves the marker, and :func:`shard_graph` folds the pair's two gathers
into ONE packed psum carrying both outputs: the collective contract the
fused sharded resonator sweep keeps (one reduction per factor, scores and
partial projection together).  :func:`mark_fused` force-toggles the marker
on a graph whose hints were declared without it.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.scheduler import Op
from repro_torch.engine.stage import StageGraph


def mark_fused(graph: StageGraph, fused: bool = True) -> StageGraph:
    """Set/clear ``weight_resident`` on the projection legs of a graph.

    A symbolic gemm that directly consumes another gemm's output in the same
    stage re-reads that producer's stationary operand (score -> project in a
    resonator sweep); ``fused=True`` prices it as resident on chip,
    ``fused=False`` restores the two-pass HBM pricing.
    """
    new_stages = []
    for st in graph.stages:
        gemms = {op.name for op in st.cost_ops if op.kind == "gemm"}
        ops = tuple(
            dataclasses.replace(
                op, weight_resident=(fused and op.kind == "gemm"
                                     and op.symbolic
                                     and any(d in gemms for d in op.deps)))
            for op in st.cost_ops)
        new_stages.append(dataclasses.replace(st, cost_ops=ops))
    return StageGraph(graph.name, tuple(new_stages))


def _ceil_div(a: int, b: int) -> int:
    return -(-int(a) // max(int(b), 1))


def shard_ops(ops: list, data_shards: int = 1, model_shards: int = 1) -> list:
    """Rescale op dims to one ``data`` shard's slice of the batch.

    The leading dim of gemm/conv2d (rows after im2col), the conv count of
    circconv, and the element count of simd ops are all request-proportional
    in this repo's graphs, so they divide by ``data_shards``.  ``collective``
    ops pass through (their payload is already per-device).  ``model_shards``
    does not rescale compute here — which dim a row-shard splits is op-
    specific knowledge (see :func:`repro_torch.core.factorizer.sweep_cost_ops`);
    it is used by :func:`shard_graph` to size the gather collectives.
    """
    out = []
    for op in ops:
        if op.kind in ("gemm", "conv2d"):
            m, k, n = op.dims
            dims = (_ceil_div(m, data_shards), k, n)
        elif op.kind == "circconv":
            kc, d = op.dims
            dims = (_ceil_div(kc, data_shards), d)
        elif op.kind == "simd":
            dims = (_ceil_div(op.dims[0], data_shards),)
        else:  # collective: payload already per-device
            dims = op.dims
        out.append(dataclasses.replace(op, dims=dims))
    return out


def shard_graph(graph: StageGraph, data_shards: int = 1,
                model_shards: int = 1) -> StageGraph:
    """Per-shard clone of a StageGraph with the collectives made explicit.

    Every stage's cost ops are rescaled by :func:`shard_ops`; under ``model``
    sharding each *symbolic* GEMM (codebook scoring / projection work — the
    ops whose operands a row-shard splits) is followed by a ``psum``
    collective carrying its fp32 output, and downstream deps are rewired
    through the psum so the scheduler cannot start dependents before the
    gather lands.  A ``weight_resident`` gemm consuming another gemm is a
    fused pair: the producer's psum is deferred and the pair issues ONE
    packed collective carrying both outputs (the fused sharded sweep's
    one-psum-per-factor contract).  Neural stages are data-parallel (their
    tensor-parallel comms are out of scope for the cell-pool model) and gain
    no collectives.
    """
    new_stages = []
    for st in graph.stages:
        ops = shard_ops(list(st.cost_ops), data_shards, model_shards)
        if model_shards > 1 and st.symbolic:
            gemms = {op.name: op for op in ops if op.kind == "gemm"}
            cand = {}  # producer gemm -> the fused consumer's name
            for op in ops:
                if op.kind == "gemm" and op.weight_resident:
                    prods = [d for d in op.deps if d in gemms]
                    if prods:  # one packed partner; extra gemm deps keep
                        cand[prods[0]] = op.name  # their own psums
            # A producer may only defer its gather into a consumer that
            # itself emits a psum.  In a weight-resident CHAIN (g1->g2->g3
            # all marked) the middle gemm's psum is deferred, so pairs whose
            # consumer is also a deferred producer are dropped — those
            # producers keep their own psums.  Conservative (an extra
            # collective vs a hypothetical 3-op fused kernel) but never
            # silently drops a gather from the priced plan.
            producers = set(cand)
            packed_into = {p: c for p, c in cand.items()
                           if c not in producers}
            producer_of = {c: p for p, c in packed_into.items()}
            # Pass 1: append psums with payloads from the pre-scan, so a
            # fused pair's packed collective carries BOTH outputs no matter
            # how the declared tuple orders producer and consumer.
            rewired, renames, new_psums, raw_edge = [], {}, set(), {}
            for op in ops:
                rewired.append(op)
                if op.kind != "gemm" or op.name in packed_into:
                    continue  # a packed producer's gather rides its pair
                m, _, n = op.dims
                payload = 4.0 * m * n
                prod = producer_of.get(op.name)
                if prod is not None:
                    pm, _, pn = gemms[prod].dims
                    payload += 4.0 * pm * pn  # the deferred producer gather
                ps = Op(op.name + "_psum", "collective",
                        (payload, model_shards), deps=(op.name,),
                        symbolic=True, collective="psum")
                rewired.append(ps)
                new_psums.add(ps.name)
                renames[op.name] = ps.name
                if prod is not None:
                    # third-party consumers of the producer must wait for
                    # the packed gather; the pair's own edge stays raw (the
                    # local partial products feed the local projection)
                    renames[prod] = ps.name
                    raw_edge[op.name] = prod
            # Pass 2: rewire every dep through the gathers (order-free).
            ops = [op if op.name in new_psums else dataclasses.replace(
                op, deps=tuple(d if d == raw_edge.get(op.name)
                               else renames.get(d, d) for d in op.deps))
                for op in rewired]
        new_stages.append(dataclasses.replace(st, cost_ops=tuple(ops)))
    return StageGraph(f"{graph.name}@{data_shards}x{model_shards}",
                      tuple(new_stages))
