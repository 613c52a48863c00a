"""Roofline terms of a step on the H100, and the collectives it issues.

The port of ``repro/launch/roofline.py``.  Three terms per (arch x shape x
mesh), in seconds, priced at an NVIDIA H100 SXM's data-sheet rates
(:mod:`repro_torch.launch.mesh`):

    compute    = FLOPs / (chips * 989e12)         dense bf16
    memory     = HBM bytes / (chips * 3.35e12)    HBM3
    collective = collective bytes / (chips * 450e9)   NVLink, each way

FLOPs and bytes come from the analytic model
(:mod:`repro_torch.launch.costmodel`).  The reference parses collective
operand bytes out of the optimized HLO and multiplies each by the trip
counts of its enclosing loops; here :class:`CollectiveCounter` counts them
as they are issued: every c10d functional collective DTensor runs, and
every :class:`repro_torch.launch.mesh.Mesh` collective.  An eager run
issues a layer's collectives once a layer, so the trip counts are in the
count already.  MODEL_FLOPS = 6*N*D (dense train) / 6*N_active*D (MoE),
with the 2*N*D forward-only variant recorded for serve cells.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch import mesh as M
from repro_torch.nn.common import collective_repeat

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# c10d functional op name (either namespace) -> the reference's HLO kind
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")


class CollectiveCounter(TorchDispatchMode):
    """Inside the ``with`` block, sums the operand bytes of every
    collective, per kind, on the local (one rank's) tensors: the
    per-device figure the reference reads from its per-device program.

    DTensor ops are let through (``NotImplemented``) so that DTensor
    desugars them into c10d functional collectives on local tensors, which
    this mode then sees.  A c10d functional op it cannot name raises, so no
    collective goes uncounted.  :meth:`summary` gives the reference's dict:
    bytes per kind, ``total`` and ``counts``."""

    def __init__(self):
        super().__init__()
        self.bytes = {k: 0.0 for k in _COLLECTIVES}
        self.counts = {k: 0 for k in _COLLECTIVES}
        self._sink = None

    def add(self, kind: str, nbytes: float) -> None:
        k = collective_repeat()  # a folded recurrence's body stands for k
        self.bytes[kind] += k * nbytes
        self.counts[kind] += k

    def __enter__(self):
        self._sink = M.collective_sink(self.add)
        self._sink.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._sink.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        ns, _, name = func.name().partition("::")
        base = name.split(".")[0]
        if ns in _NAMESPACES and base not in _NOT_COLLECTIVES:
            if base in _KIND:
                self.add(_KIND[base], sum(
                    t.numel() * t.element_size()
                    for t in pytree.tree_leaves(args[0])
                    if isinstance(t, torch.Tensor)))
            elif ns != "_dtensor":
                raise ValueError(f"uncounted collective {func.name()}")
        return func(*args, **kwargs)

    def summary(self) -> dict:
        out = dict(self.bytes)
        out["total"] = sum(self.bytes.values())
        out["counts"] = dict(self.counts)
        return out


def collective_bytes(fn, *args, **kwargs) -> dict:
    """The collectives of one run of ``fn(*args, **kwargs)``:
    :meth:`CollectiveCounter.summary`."""
    with CollectiveCounter() as cc:
        fn(*args, **kwargs)
    return cc.summary()


def roofline_terms(flops: float, bytes_hbm: float, coll_bytes: float,
                   chips: int) -> dict:
    compute = flops / (chips * M.PEAK_FLOPS_BF16)
    memory = bytes_hbm / (chips * M.HBM_BW)
    collective = coll_bytes / (chips * M.NVLINK_BW)
    terms = {"compute_s": compute, "memory_s": memory, "collective_s": collective}
    dom = max(terms, key=terms.get)
    terms["bottleneck"] = dom.replace("_s", "")
    total = max(compute, memory, collective)
    terms["roofline_fraction_compute"] = compute / total if total else 0.0
    return terms


def model_flops(n_params: int, n_active: int, tokens: int, kind: str) -> dict:
    """Useful-FLOPs accounting. kind: train (6ND) or prefill/decode (2ND)."""
    factor = 6.0 if kind == "train" else 2.0
    return {
        "model_flops_6nd": 6.0 * n_params * tokens,
        "model_flops_active": factor * n_active * tokens,
        "factor": factor,
    }


def summarize(cell: dict) -> str:
    t = cell["terms"]
    return (f"{cell['arch']:24s} {cell['shape']:12s} {cell['mesh']:9s} "
            f"comp={t['compute_s']*1e3:9.3f}ms mem={t['memory_s']*1e3:9.3f}ms "
            f"coll={t['collective_s']*1e3:9.3f}ms -> {t['bottleneck']:10s} "
            f"useful={cell.get('useful_frac', float('nan')):6.1%}")
