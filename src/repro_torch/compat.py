"""The port's counterpart of ``repro/compat.py``.

The reference's shims paper over jax versions.  Two of its three surfaces
have no counterpart here: ``make_mesh`` is :mod:`repro_torch.launch.mesh`
(``make_production_mesh`` for a ``DeviceMesh``, ``Mesh`` for the
single-controller grid) and ``shard_map`` is ``Mesh``'s explicit
collectives (``reduce``, ``ppermute``, ``all_gather``).  The third,
``cost_analysis``, reads XLA's cost analysis of a compiled program; here it
counts an eager run of a function.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _BytesAccessed(TorchDispatchMode):
    """Sums operand and result bytes of every aten op that is not a view."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view:
            self.total += _bytes((args, kwargs)) + _bytes(out)
        return out


def cost_analysis(fn, *args, **kwargs) -> dict:
    """``{"flops": ..., "bytes accessed": ...}`` of one eager run of
    ``fn(*args, **kwargs)``.

    FLOPs are ``torch.utils.flop_counter.FlopCounterMode``'s (matmuls,
    convolutions and attention; elementwise ops count none, as XLA's
    count is dominated by the same products).  Bytes accessed sum the
    operand and result bytes of every aten op but views: an upper bound, as
    XLA's is, since a fused program reads many of them from registers.
    Unlike XLA's analysis, which counts a loop body once, an eager run
    counts every iteration of a Python loop."""
    with FlopCounterMode(display=False) as flops, _BytesAccessed() as nbytes:
        fn(*args, **kwargs)
    return {"flops": float(flops.get_total_flops()),
            "bytes accessed": float(nbytes.total)}
