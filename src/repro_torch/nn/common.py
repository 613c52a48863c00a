"""Logical-axis sharding plumbing for the NN substrate.

The port of ``repro/nn/common.py``.  Weights and activations carry
*logical* axis names ("batch", "embed", "heads", "mlp", "vocab", "experts",
"seq", ...) which a rules table maps to mesh axes.  ``shard(x, *names)``
redistributes a DTensor to the placements those names give when a mesh
context is active, and is the identity otherwise, so the same model code
runs in single-device tests and in the pod-scale dry-run.  It is the
counterpart of the reference's ``with_sharding_constraint``: GSPMD's
automatic propagation is DTensor's, over a ``DeviceMesh``.

Default rules implement DP(+pod) x TP with FSDP over ``data``:
  batch   -> (pod, data)         activations' leading dim
  seq     -> data when sequence-parallel (long-context cells), else None
  embed   -> data (FSDP: DTensor gathers the weight where a layer uses it)
  heads/kv_heads/mlp/vocab/experts -> model (megatron TP)

A spec is the tuple a ``PartitionSpec`` holds: one entry per tensor dim,
each None, a mesh-axis name or a tuple of them.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch

_ctx = threading.local()

DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_res": "model",  # Megatron-SP: residual stream seq over `model`
    # between layers, so remat-saved activations shrink by the TP degree.
    "embed": "data",  # FSDP shard of the weight's embed axis
    "embed_act": None,  # activations' model dim stays replicated across data
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "layers": None,
    "conv": None,
    "state": None,
}

SEQ_PARALLEL_RULES = dict(DEFAULT_RULES, seq="data")


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``, or of any mesh that has
    ``axis_names`` and ``devices.shape`` as the reference's does."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a plain tensor answers at once, without
    an import: the serving paths ask on every layer)."""
    if type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _axes_for(mesh, name):
    if name is None:
        return None
    names = name if isinstance(name, tuple) else (name,)
    present = tuple(n for n in names if n in mesh_axes(mesh))
    if not present:
        return None
    return present if len(present) > 1 else present[0]


def spec_for(logical, mesh, rules: dict) -> tuple:
    """Logical names -> spec; a mesh axis is used at most once (first
    logical dim that claims it wins) so rule tables may map several names
    to the same axis without producing invalid specs."""
    used: set = set()
    out = []
    for n in logical:
        axes = _axes_for(mesh, rules.get(n)) if n is not None else None
        if axes is None:
            out.append(None)
            continue
        axes_t = tuple(a for a in (axes if isinstance(axes, tuple) else (axes,))
                       if a not in used)
        used.update(axes_t)
        out.append(axes_t if len(axes_t) > 1 else (axes_t[0] if axes_t else None))
    return tuple(out)


def sanitize(spec: tuple, shape, mesh) -> tuple:
    """Drop mesh axes that don't divide the dim (the reference's
    ``dryrun._sanitize``: input shardings must tile evenly).  :func:`shard`
    applies it to activations too: GSPMD pads an uneven dim, DTensor
    shards it unevenly and then cannot take most views of it, so such a
    dim stays whole here."""
    sizes = mesh_axes(mesh)
    out = []
    used: set = set()
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            out.append(None)
            continue
        axes = tuple(a for a in (entry if isinstance(entry, tuple) else (entry,))
                     if a not in used)  # a mesh axis may appear only once
        total = int(math.prod([sizes[a] for a in axes])) if axes else 0
        if not axes or dim % total != 0:
            axes = tuple(a for a in axes if dim % sizes[a] == 0)[:1]
            if not axes:
                out.append(None)
                continue
        used.update(axes)
        out.append(axes if len(axes) > 1 else axes[0])
    return tuple(out)


def placements(spec: tuple, mesh) -> list:
    """A spec as DTensor placements, one per mesh dim: ``Shard(d)`` where
    the mesh axis names tensor dim ``d``, ``Replicate()`` elsewhere.  Several
    mesh axes on one tensor dim (``batch -> (pod, data)``) give one
    ``Shard(d)`` each, the dim split in mesh-axis order."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of = {}
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                dim_of[a] = d
    return [Shard(dim_of[a]) if a in dim_of else Replicate()
            for a in mesh_axes(mesh)]


@contextlib.contextmanager
def sharding_ctx(mesh, rules: dict | None = None):
    """Make ``mesh`` and ``rules`` (default :data:`DEFAULT_RULES`) the
    active sharding context in this thread; with a mesh, plain tensors that
    meet DTensors count as replicated (DTensor's ``implicit_replication``),
    as the reference's constants do under GSPMD."""
    prev = getattr(_ctx, "val", None)
    _ctx.val = (mesh, rules or DEFAULT_RULES) if mesh is not None else None
    try:
        if mesh is None:
            yield
        else:
            from torch.distributed.tensor.experimental import (
                implicit_replication)

            with implicit_replication():
                yield
    finally:
        _ctx.val = prev


def current_mesh():
    """``(mesh, rules)`` of the active :func:`sharding_ctx`, or None."""
    return getattr(_ctx, "val", None)


def shard(x, *logical: str | None):
    """Constrain a DTensor's sharding by logical axis names: redistribute
    it when an active :func:`sharding_ctx` asks for other placements (a
    mesh axis that does not divide its dim is left out, :func:`sanitize`).
    The identity without a mesh, and on a plain tensor (which DTensor's ops
    treat as replicated)."""
    v = current_mesh()
    if v is None or not is_dtensor(x):
        return x
    mesh, rules = v
    want = placements(sanitize(spec_for(logical, mesh, rules), x.shape, mesh),
                      mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def split_heads(x, n: int, dh: int):
    """``x [..., n * dh]`` viewed as ``[..., n, dh]``.  A DTensor can split
    a sharded dim only where its mesh axes divide ``n``; GSPMD splits the
    rest inside a head, which DTensor cannot express, so those mesh axes
    are gathered first (what GSPMD calls involuntary resharding)."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        d = x.dim() - 1
        mesh = x.device_mesh
        sizes = list(mesh.shape)
        pl = list(x.placements)
        k = 1
        for i, p in enumerate(pl):
            if isinstance(p, Shard) and p.dim in (d, -1):
                if n % (k * sizes[i]):
                    pl[i] = Replicate()
                else:
                    k *= sizes[i]
        if pl != list(x.placements):
            x = x.redistribute(mesh, pl)
    return x.reshape(*x.shape[:-1], n, dh)


class _MergeHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.n, ctx.dh = x.shape[-2], x.shape[-1]
        return x.reshape(*x.shape[:-2], ctx.n * ctx.dh)

    @staticmethod
    def backward(ctx, g):
        return split_heads(g, ctx.n, ctx.dh)


def merge_heads(x):
    """``x [..., n, dh]`` as ``[..., n * dh]``.  On a DTensor its gradient
    is split back by :func:`split_heads`: the gradient arrives split over
    ``n * dh`` as the output projection's weight is, which DTensor could
    not view as heads."""
    if is_dtensor(x):
        return _MergeHeads.apply(x)
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def local_map(fn, args: tuple, in_specs: list, out_specs: list):
    """``shard_map``: ``fn`` applied to each rank's shards.  Each DTensor
    of ``args`` is redistributed to the placements of its spec of
    ``in_specs`` (a spec tuple, or None to leave an argument as it is; a
    plain tensor counts as replicated) and passed as its local tensor; each
    output of ``fn`` (a tensor or a tuple
    of them) becomes a DTensor of its spec of ``out_specs`` on the first
    DTensor argument's mesh.  With no DTensor among ``args``, just
    ``fn(*args)``."""
    from torch.distributed.tensor import DTensor, Replicate

    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return fn(*args)
    mesh = dts[0].device_mesh

    def split(a, s):
        if s is None or not isinstance(a, torch.Tensor):
            return a
        if not isinstance(a, DTensor):  # a plain tensor is replicated
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return a.redistribute(mesh, placements(s, mesh)).to_local()

    local = [split(a, s) for a, s in zip(args, in_specs)]
    outs = fn(*local)
    single = isinstance(outs, torch.Tensor)
    wrapped = [DTensor.from_local(o, mesh, placements(s, mesh),
                                  run_check=False)
               for o, s in zip((outs,) if single else outs, out_specs)]
    return wrapped[0] if single else tuple(wrapped)


def rows_local(fn, args: tuple, shared: tuple = (), n_out: int = 1):
    """``fn(*args, *shared)`` run on each rank's rows under a mesh: every
    operand of ``args`` and every output split by rows over the batch axes
    (where they divide the rows), the ``shared`` operands replicated
    (:func:`local_map`); plainly otherwise.  The reference's GSPMD
    partitions a per-row recurrence or permutation so; DTensor cannot
    follow the loops, scatters and in-place writes inside them."""
    v = current_mesh()
    if v is None:
        return fn(*args, *shared)
    mesh, rules = v
    rows = sanitize(spec_for(("batch",), mesh, rules), args[0].shape[:1],
                    mesh)[0]
    return local_map(fn, tuple(args) + tuple(shared),
                     [(rows,)] * len(args) + [()] * len(shared),
                     [(rows,)] * n_out)


def param_sharding(logical_tree, mesh, rules: dict | None = None):
    """Map a tree of logical-axis tuples to DTensor placements (for the
    dry-run's parameters)."""
    from torch.utils import _pytree as pytree

    rules = rules or DEFAULT_RULES
    return pytree.tree_map(
        lambda lg: placements(spec_for(lg, mesh, rules), mesh), logical_tree,
        is_leaf=lambda x: isinstance(x, tuple))
