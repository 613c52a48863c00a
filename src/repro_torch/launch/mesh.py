"""The port's device mesh: a ``data x model`` grid of ``torch.device``s.

The port is single-controller, like the reference: one host process runs
the engine's queue and drives every shard.  A :class:`Mesh` names the device
of each (data, model) shard; a device may repeat, so several logical shards
can share one card (``make_host_mesh`` puts all of them on one device) and
the same code runs with one card per shard where a machine has them.

Every cross-shard reduction of the sharded engine goes through
:meth:`Mesh.reduce`, which counts its calls per axis: the port's
counterpart of the reference's ``psum``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve

AXES = ("data", "model")

# NVIDIA H100 SXM data sheet: NVLink 4, 900 GB/s per card over all links,
# 450 GB/s each way, which is what a ring step sends at.
NVLINK_BW = 450e9  # B/s
# Fixed cost of one collective step across cards: an order of magnitude
# assumed for the cost model, not a data-sheet or measured figure.
NVLINK_LATENCY_S = 2e-6


class Mesh:
    """A ``data x model`` grid of devices; ``devices[d][m]`` holds shard
    (d, m).  ``reductions`` counts :meth:`reduce` calls per axis."""

    def __init__(self, devices):
        grid = tuple(tuple(torch.device(x) for x in row) for row in devices)
        if not grid or not grid[0] or any(len(r) != len(grid[0]) for r in grid):
            raise ValueError("a mesh needs a non-empty rectangular "
                             "[data][model] grid of devices")
        self.devices = grid
        self.shape = {"data": len(grid), "model": len(grid[0])}
        self.reductions = {ax: 0 for ax in AXES}

    def axis(self, name: str) -> "MeshAxis":
        if name not in AXES:
            raise ValueError(f"mesh axes are {AXES}, not {name!r}")
        return MeshAxis(self, name)

    def reduce(self, axis: str, parts, op: str = "sum") -> list:
        """Sum (or, with ``op="max"``, elementwise maximum) over the shards
        of ``axis``, in shard order, landing on each shard's device: one
        collective, like a ``psum`` (``pmax``) over that axis, counted in
        ``reductions`` either way.

        ``parts[d][m]`` is shard (d, m)'s tensor on ``devices[d][m]``.
        Returns the same grid of sums: for ``"model"``, entry (d, m) is
        ``parts[d][0] + parts[d][1] + ...``; for ``"data"``, ``parts[0][m]
        + parts[1][m] + ...``.  Shards of a group that share a device share
        one result tensor.
        """
        if axis not in AXES:
            raise ValueError(f"mesh axes are {AXES}, not {axis!r}")
        combine = {"sum": torch.add, "max": torch.maximum}.get(op)
        if combine is None:
            raise ValueError(f"reduce ops are 'sum' and 'max', not {op!r}")
        D, M = self.shape["data"], self.shape["model"]
        if len(parts) != D or any(len(row) != M for row in parts):
            raise ValueError(f"reduce needs a [{D}][{M}] grid of parts")
        self.reductions[axis] += 1
        out = [[None] * M for _ in range(D)]
        groups = ([[(d, m) for m in range(M)] for d in range(D)]
                  if axis == "model" else
                  [[(d, m) for d in range(D)] for m in range(M)])
        for group in groups:
            d0, m0 = group[0]
            total = parts[d0][m0]
            for d, m in group[1:]:
                total = combine(total, parts[d][m].to(total.device))
            landed = {}
            for d, m in group:
                dev = self.devices[d][m]
                if dev not in landed:
                    landed[dev] = total.to(dev)
                out[d][m] = landed[dev]
        return out


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
