"""adSCH: adaptive workload-aware scheduling (paper Sec. VI).

Offline greedy list scheduler over a heterogeneous neuro/symbolic operation
graph, targeting the CogSys cell pool.  Reproduces the paper's mechanism:

  * cell-wise partition  — neural ops grab contiguous groups of cells,
    symbolic ops fill small leftovers (Fig. 13c);
  * column-wise parallelism — one cell runs `cell_dim` circconvs at once;
  * interleaved processing — ops of batch t-1's symbolic stage schedule into
    idle cells while batch t's neural layers run (Fig. 13b/13d), which is
    possible because inter-batch edges don't exist in the op graph;
  * greedy policy — "prioritize neural tasks for larger cell blocks and
    symbolic tasks for smaller ones" with analytic runtime estimates.

A copy of the reference package's ``core/scheduler.py``: the engine's sweep
burst comes from :func:`schedule`, so the port must price sweeps exactly as
the reference does.  Collective ops are priced on NVLink
(:func:`repro_torch.launch.mesh.collective_seconds`) where the reference
prices them on the TPU's ICI.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Literal

from repro_torch.cogsim import model as hw_model

OpKind = Literal["gemm", "conv2d", "circconv", "simd", "collective"]


@dataclasses.dataclass
class Op:
    """One node of the operation graph."""

    name: str
    kind: OpKind
    # gemm/conv2d: (m, k, n) after im2col; circconv: (k_convs, d);
    # simd: (elems,); collective: (payload_bytes, participants)
    dims: tuple
    deps: tuple = ()
    batch: int = 0  # batch index, for interleaving analysis
    symbolic: bool = False
    collective: str = "psum"  # kind=="collective" only: psum | all_gather |
    # reduce_scatter | ppermute (the jax.lax primitive being priced)
    # gemm/conv2d only: the [k, n] stationary operand is already resident in
    # on-chip memory (a fused kernel kept it from a producer op), so it costs
    # no HBM traffic here — how the fused resonator sweep's projection halves
    # the codebook HBM term (kernels/resonator_step).
    weight_resident: bool = False

    def flops(self) -> float:
        if self.kind in ("gemm", "conv2d"):
            m, k, n = self.dims
            return 2.0 * m * k * n
        if self.kind == "circconv":
            kc, d = self.dims
            return 2.0 * kc * d * d
        if self.kind == "collective":
            return 0.0  # pure data movement on the interconnect
        return float(self.dims[0])

    def bytes_moved(self, itemsize: int = 1) -> float:
        if self.kind in ("gemm", "conv2d"):
            m, k, n = self.dims
            weight = 0 if self.weight_resident else k * n
            return float(m * k + weight + m * n) * itemsize
        if self.kind == "circconv":
            kc, d = self.dims
            return 3.0 * kc * d * itemsize
        if self.kind == "collective":
            return float(self.dims[0])  # dims already carries bytes
        return float(self.dims[0]) * itemsize


@dataclasses.dataclass
class Placement:
    op: Op
    start: float
    end: float
    cells: tuple  # cell ids, () for SIMD ops


def op_cycles(op: Op, hw: hw_model.ArrayConfig, n_cells: int) -> float:
    """Analytic runtime of `op` on `n_cells` cooperating cells."""
    if op.kind in ("gemm", "conv2d"):
        m, k, n = op.dims
        return hw_model.sa_gemm_cycles(
            hw, m, k, n, cells=n_cells,
            weight_resident=op.weight_resident)["cycles"]
    if op.kind == "circconv":
        kc, d = op.dims
        if hw.reconfigurable:
            return hw_model.adaptive_bs_circconv(hw, kc, d, cells=n_cells)["cycles"]
        sub = dataclasses.replace(hw, num_cells=n_cells)
        return hw_model.sa_circconv_as_gemv_cycles(sub, kc, d)["cycles"]
    if op.kind == "simd":
        return hw_model.simd_cycles(hw, op.dims[0])["cycles"]
    if op.kind == "collective":
        # priced on the interconnect (launch/mesh.py's NVLink constants), not
        # the cell pool: a collective occupies no cells, like a SIMD op, but
        # its duration is wire time
        from repro_torch.launch.mesh import collective_seconds

        nbytes, participants = op.dims
        return collective_seconds(nbytes, participants,
                                  op.collective) * hw.freq_hz
    raise ValueError(op.kind)


@dataclasses.dataclass
class Schedule:
    placements: list
    makespan: float
    utilization: float  # busy cell-cycles / (cells * makespan)


def schedule(ops: list, hw: hw_model.ArrayConfig, *,
             interleave: bool = True) -> Schedule:
    """Greedy list scheduling (the paper's offline adSCH search).

    With ``interleave=False`` ops additionally depend on every op of earlier
    batches (strict sequential batches) — the "w/o adSCH" ablation of Fig. 19.
    """
    by_name = {op.name: op for op in ops}
    deps = {op.name: set(op.deps) for op in ops}
    if not interleave:
        last_of_batch: dict = {}
        for op in ops:  # program order
            for b, names in last_of_batch.items():
                if b < op.batch:
                    deps[op.name] |= names
            last_of_batch.setdefault(op.batch, set()).add(op.name)

    n_cells = hw.num_cells
    free_cells = set(range(n_cells))
    cell_free_at = [0.0] * n_cells
    done_at: dict = {}
    placements: list = []
    pending = {op.name for op in ops}
    running: list = []  # heap of (end_time, name, cells)
    t = 0.0
    busy_area = 0.0

    def ready_ops():
        return [by_name[n] for n in pending
                if all(d in done_at and done_at[d] <= t for d in deps[n])]

    while pending or running:
        # retire finished ops
        while running and running[0][0] <= t:
            end, name, cells = heapq.heappop(running)
            free_cells.update(cells)
        progressed = True
        while progressed:
            progressed = False
            ready = ready_ops()
            if not ready or not free_cells and any(o.kind != "simd" for o in ready):
                pass
            # neural ops first for the big blocks, then symbolic into leftovers
            neural = sorted([o for o in ready if not o.symbolic],
                            key=lambda o: -o.flops())
            symbolic = sorted([o for o in ready if o.symbolic],
                              key=lambda o: -o.flops())
            neural_waiting = bool(neural)
            symbolic_waiting = any(o.kind not in ("simd", "collective")
                                   for o in symbolic)
            for op in neural + symbolic:
                if op.kind in ("simd", "collective"):  # cell-free resources
                    dur = op_cycles(op, hw, 0)
                    done_at[op.name] = t + dur
                    placements.append(Placement(op, t, t + dur, ()))
                    heapq.heappush(running, (t + dur, op.name, ()))
                    pending.discard(op.name)
                    progressed = True
                    continue
                if not free_cells:
                    continue
                # Cell-wise partition (Fig. 13c): neural ops take large blocks
                # but leave a sliver for concurrent symbolic kernels; symbolic
                # ops fill leftovers ONLY when the paper's analytic runtime
                # estimate says they finish inside the neural overlap window —
                # otherwise a critical-path symbolic op on 2 cells would run
                # ~8x slow (observed 2.7x makespan regressions).
                if not op.symbolic:
                    # never start a neural op on crumbs — waiting for at
                    # least half the array beats running a GEMM on 2 cells
                    if len(free_cells) < max(1, n_cells // 2):
                        continue
                    want = max(1, n_cells - (max(1, n_cells // 8)
                                             if symbolic_waiting else 0))
                else:
                    neural_end = max(
                        [end for end, nm, _c in running
                         if not by_name[nm].symbolic], default=t)
                    sliver = max(1, n_cells // 8)
                    overlapped = (neural_waiting or neural_end > t) and \
                        t + op_cycles(op, hw, sliver) <= neural_end
                    want = sliver if overlapped else len(free_cells)
                grab = tuple(sorted(free_cells))[:want]
                dur = op_cycles(op, hw, len(grab))
                free_cells.difference_update(grab)
                done_at[op.name] = t + dur
                placements.append(Placement(op, t, t + dur, grab))
                heapq.heappush(running, (t + dur, op.name, grab))
                pending.discard(op.name)
                busy_area += dur * len(grab)
                progressed = True
        if running:
            t = running[0][0]
        elif pending:  # deadlock would be a graph bug
            raise RuntimeError(f"unschedulable ops: {pending}")
    makespan = max((p.end for p in placements), default=0.0)
    util = busy_area / (n_cells * makespan) if makespan else 0.0
    return Schedule(placements, makespan, util)


def validate(sched: Schedule, ops: list) -> None:
    """Invariants: no cell double-booking, all deps respected (tested via hypothesis)."""
    by_name = {p.op.name: p for p in sched.placements}
    for p in sched.placements:
        for d in p.op.deps:
            assert by_name[d].end <= p.start + 1e-9, (d, p.op.name)
    events = []
    for p in sched.placements:
        for c in p.cells:
            events.append((p.start, p.end, c))
    events.sort()
    active: dict = {}
    for start, end, c in events:
        if c in active and active[c] > start + 1e-9:
            raise AssertionError(f"cell {c} double-booked")
        active[c] = end
