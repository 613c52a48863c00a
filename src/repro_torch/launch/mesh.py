"""The port's device mesh: a grid of ``torch.device``s over named axes.

The port is single-controller, like the reference: one host process runs
the engine's queue and drives every shard.  A :class:`Mesh` names the device
of each shard of a grid of rank 1-3 over axes chosen from ``pod``,
``data``, ``model`` and ``pipe`` (``data x model`` by default); a device may
repeat, so several logical shards can share one card (``make_host_mesh``
puts all of them on one device) and the same code runs with one card per
shard where a machine has them.

Every explicit collective of the port goes through the mesh, each counted
per axis: :meth:`Mesh.reduce` (the reference's ``psum`` / ``pmax``, counted
in ``reductions``), :meth:`Mesh.ppermute` (``transfers``) and
:meth:`Mesh.all_gather` (``gathers``).  These are the port's counterpart of
the reference's ``shard_map`` collectives; the automatic (GSPMD) side is
DTensor over :func:`make_production_mesh`'s ``DeviceMesh``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import os
import threading

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve

AXES = ("data", "model")  # the default grid's axes
AXIS_NAMES = ("pod", "data", "model", "pipe")

# NVIDIA H100 SXM data sheet: NVLink 4, 900 GB/s per card over all links,
# 450 GB/s each way, which is what a ring step sends at.
NVLINK_BW = 450e9  # B/s
# Fixed cost of one collective step across cards: an order of magnitude
# assumed for the cost model, not a data-sheet or measured figure.
NVLINK_LATENCY_S = 2e-6
# NVIDIA H100 SXM data sheet: dense BF16 tensor-core peak (no sparsity) at
# the 700 W limit.
PEAK_FLOPS_BF16 = 989e12  # FLOP/s
# NVIDIA H100 SXM data sheet: 80 GB of HBM3 at 3.35 TB/s.
HBM_BW = 3.35e12  # B/s

_sinks = threading.local()


@contextlib.contextmanager
def collective_sink(sink):
    """Call ``sink(kind, nbytes)`` for every :class:`Mesh` collective issued
    in this thread inside the block (``roofline.collective_bytes``)."""
    stack = getattr(_sinks, "stack", ())
    _sinks.stack = stack + (sink,)
    try:
        yield
    finally:
        _sinks.stack = stack


def record_collective(kind: str, nbytes: int) -> None:
    """Tell every active sink that a collective of ``kind`` (the
    reference's HLO op names) moved ``nbytes`` of one shard's operand: the
    per-device figure the reference reads from its per-device program."""
    for sink in getattr(_sinks, "stack", ()):
        sink(kind, nbytes)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _at(grid, idx):
    for i in idx:
        grid = grid[i]
    return grid


def _device_grid(grid, depth: int):
    """``grid`` (nested lists, ``depth`` deep) as nested tuples of
    ``torch.device``; raises ``ValueError`` unless it is non-empty and
    rectangular."""
    if depth == 0:
        return torch.device(grid)
    if not isinstance(grid, (list, tuple)) or not grid:
        raise ValueError("not a non-empty grid")
    rows = tuple(_device_grid(g, depth - 1) for g in grid)
    if depth > 1 and len({_shape(r) for r in rows}) != 1:
        raise ValueError("not a rectangular grid")
    return rows


def _shape(grid) -> tuple:
    shape = []
    while isinstance(grid, tuple):
        shape.append(len(grid))
        grid = grid[0]
    return tuple(shape)


class Mesh:
    """A grid of devices over named ``axes`` (default ``("data",
    "model")``): ``devices[d][m]`` holds shard (d, m) of the default grid,
    ``devices[i0][i1]...`` in axis order in general.  ``reductions``,
    ``transfers`` and ``gathers`` count :meth:`reduce`, :meth:`ppermute`
    and :meth:`all_gather` calls per axis."""

    def __init__(self, devices, axes: tuple = AXES):
        axes = tuple(axes)
        if not 1 <= len(axes) <= 3 or len(set(axes)) != len(axes) or any(
                a not in AXIS_NAMES for a in axes):
            raise ValueError(f"a mesh has 1-3 distinct axes of {AXIS_NAMES}, "
                             f"not {axes}")
        try:
            grid = _device_grid(devices, len(axes))
        except (TypeError, ValueError, RuntimeError) as e:
            raise ValueError(f"a mesh needs a non-empty rectangular grid of "
                             f"devices over {axes}") from e
        self.axes = axes
        self.devices = grid
        self.shape = dict(zip(axes, _shape(grid)))
        self.reductions = {ax: 0 for ax in axes}
        self.transfers = {ax: 0 for ax in axes}
        self.gathers = {ax: 0 for ax in axes}

    def _check(self, axis: str, parts) -> tuple:
        if axis not in self.axes:
            raise ValueError(f"mesh axes are {self.axes}, not {axis!r}")
        dims = tuple(self.shape.values())
        try:
            ok = all(isinstance(_at(parts, i), torch.Tensor)
                     for i in itertools.product(*map(range, dims)))
            ok = ok and _lens(parts, len(dims)) == dims
        except (TypeError, IndexError):
            ok = False
        if not ok:
            raise ValueError(f"a collective over {self.axes} needs a "
                             f"{list(dims)} grid of tensors")
        return dims, self.axes.index(axis)

    def _groups(self, dims: tuple, k: int):
        """The index tuples of each group along axis ``k``, in axis order."""
        rest = [range(n) for j, n in enumerate(dims) if j != k]
        for r in itertools.product(*rest):
            yield [r[:k] + (i,) + r[k:] for i in range(dims[k])]

    def axis(self, name: str) -> "MeshAxis":
        if name not in self.axes:
            raise ValueError(f"mesh axes are {self.axes}, not {name!r}")
        return MeshAxis(self, name)

    def reduce(self, axis: str, parts, op: str = "sum") -> list:
        """Sum (or, with ``op="max"``, elementwise maximum) over the shards
        of ``axis``, in shard order, landing on each shard's device: one
        collective, like a ``psum`` (``pmax``) over that axis, counted in
        ``reductions`` either way.

        ``parts`` is the grid of the shards' tensors, each on its shard's
        device (``parts[d][m]`` on a ``data x model`` mesh).  Returns the
        same grid of sums: on ``data x model`` for ``"model"``, entry (d, m)
        is ``parts[d][0] + parts[d][1] + ...``; for ``"data"``, ``parts[0][m]
        + parts[1][m] + ...``.  Shards of a group that share a device share
        one result tensor.
        """
        combine = {"sum": torch.add, "max": torch.maximum}.get(op)
        if combine is None:
            raise ValueError(f"reduce ops are 'sum' and 'max', not {op!r}")
        dims, k = self._check(axis, parts)
        self.reductions[axis] += 1
        record_collective("all-reduce", _nbytes(_at(parts, (0,) * len(dims))))
        out = {}
        for group in self._groups(dims, k):
            total = _at(parts, group[0])
            for idx in group[1:]:
                total = combine(total, _at(parts, idx).to(total.device))
            landed = {}
            for idx in group:
                dev = _at(self.devices, idx)
                if dev not in landed:
                    landed[dev] = total.to(dev)
                out[idx] = landed[dev]
        return _nested_list(dims, out)

    def ppermute(self, axis: str, parts, perm) -> list:
        """``jax.lax.ppermute`` over ``axis``: for each ``(src, dst)`` of
        ``perm`` (positions along the axis), shard ``dst`` receives shard
        ``src``'s tensor, moved to ``dst``'s device (asynchronously where
        the devices differ); a shard no pair sends to receives zeros.  One
        collective, counted in ``transfers``."""
        dims, k = self._check(axis, parts)
        perm = [(int(s), int(d)) for s, d in perm]
        n = dims[k]
        dsts = [d for _, d in perm]
        if any(not (0 <= s < n and 0 <= d < n) for s, d in perm) or \
                len(set(dsts)) != len(dsts):
            raise ValueError(f"ppermute needs (src, dst) pairs in [0, {n}) "
                             f"with distinct destinations, got {perm}")
        self.transfers[axis] += 1
        record_collective("collective-permute",
                          _nbytes(_at(parts, (0,) * len(dims))))
        out = {}
        for group in self._groups(dims, k):
            for s, d in perm:
                src = _at(parts, group[s])
                out[group[d]] = src.to(_at(self.devices, group[d]),
                                       non_blocking=True)
            for i, idx in enumerate(group):
                if idx not in out:
                    out[idx] = torch.zeros_like(
                        _at(parts, idx), device=_at(self.devices, idx))
        return _nested_list(dims, out)

    def all_gather(self, axis: str, parts) -> list:
        """``jax.lax.all_gather`` over ``axis`` (not tiled): every shard gets
        its group's tensors stacked in axis order on a new leading dim, on
        its own device.  One collective, counted in ``gathers``."""
        dims, k = self._check(axis, parts)
        self.gathers[axis] += 1
        record_collective("all-gather", _nbytes(_at(parts, (0,) * len(dims))))
        out = {}
        for group in self._groups(dims, k):
            landed = {}
            for idx in group:
                dev = _at(self.devices, idx)
                if dev not in landed:
                    landed[dev] = torch.stack(
                        [_at(parts, j).to(dev) for j in group])
                out[idx] = landed[dev]
        return _nested_list(dims, out)


def _lens(parts, depth: int):
    """The grid's lengths per level, or None where a level is ragged."""
    if depth == 0:
        return ()
    subs = {_lens(p, depth - 1) for p in parts}
    return (len(parts),) + subs.pop() if len(subs) == 1 else None


def _nested_list(dims: tuple, values: dict) -> list:
    """A nested list of ``dims`` with ``values[index]`` at each index."""
    def build(prefix):
        if len(prefix) == len(dims):
            return values[prefix]
        return [build(prefix + (i,)) for i in range(dims[len(prefix)])]
    return build(())


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """A handle on one axis of a mesh: what a resonator built in its
    model-sharded mode takes in place of the reference's axis name."""

    mesh: Mesh
    name: str

    @property
    def size(self) -> int:
        return self.mesh.shape[self.name]

    def reduce(self, parts, op: str = "sum") -> list:
        return self.mesh.reduce(self.name, parts, op)


def make_host_mesh(data: int = 4, model: int = 2,
                   device=DEFAULT_DEVICE) -> Mesh:
    """A ``data x model`` mesh of logical shards, all on ``device`` (default
    the card; raises where there is none).  Tests pass ``device="cpu"``."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes need at least one shard, got "
                         f"data={data} model={model}")
    dev = resolve(device)
    return Mesh([[dev] * model for _ in range(data)])


def production_shape(multi_pod: bool = False) -> tuple:
    """The production mesh's shape: ``(16, 16)``, ``REPRO_MESH`` (e.g.
    ``"32x8"``) in its place, or ``(2, 16, 16)`` with ``multi_pod``."""
    override = os.environ.get("REPRO_MESH")
    if multi_pod:
        return (2, 16, 16)
    if override:
        return tuple(int(x) for x in override.split("x"))
    return (16, 16)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production ``torch.distributed`` ``DeviceMesh``: ``(16, 16)``
    over ``("data", "model")``, or ``(2, 16, 16)`` over ``("pod", "data",
    "model")`` with ``multi_pod``; ``REPRO_MESH`` (e.g. ``"32x8"``)
    overrides the single-pod shape.  These are the reference's sizes, so
    the dry-run's cells map one to one onto its.

    It needs a process group of that world size to exist (a cluster's, or
    the ``fake`` one :mod:`repro_torch.launch.dryrun` sets up) and builds
    nothing else.  On H100s a ``model`` axis of 16 spans two 8-card NVLink
    nodes; the first-order roofline term prices all of it at NVLink's rate
    (``NVLINK_BW``), which the node boundary would not give.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = production_shape(multi_pod)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"a {shape} mesh needs a process group of world "
                           f"size {n}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def collective_seconds(nbytes: float, participants: int,
                       kind: str = "psum") -> float:
    """First-order ring-collective time over ``participants`` cards on
    NVLink.

    Per-card wire traffic of the standard ring algorithms on ``nbytes`` of
    payload: reduce-scatter / all-gather each move ``(p-1)/p * nbytes``;
    psum (all-reduce) is the two chained -> ``2 (p-1)/p``.  ``ppermute``
    moves the full payload one hop.  Used by
    :func:`repro_torch.core.scheduler.op_cycles` to price ``collective``
    ops.
    """
    p = max(int(participants), 1)
    if p == 1:
        return 0.0
    frac = {"psum": 2.0 * (p - 1) / p,
            "all_gather": (p - 1) / p,
            "reduce_scatter": (p - 1) / p,
            "ppermute": 1.0}.get(kind)
    if frac is None:
        raise ValueError(f"unknown collective kind {kind!r}")
    return NVLINK_LATENCY_S + frac * nbytes / NVLINK_BW
