"""Gradient compression for the data-parallel all-reduce.

The port of ``repro/distributed/compression.py``.  INT8-quantised gradient
exchange with error feedback: each step reduces the quantised gradients
(a quarter of fp32's bytes on the wire) and folds the local quantisation
residual into the next step's gradients, preserving convergence
(Karimireddy et al., 2019).  Off by default; ``launch/train.py`` does not use
it, as the reference's does not.

A tree is a tensor or a dict / list / tuple of trees, walked in JAX's leaf
order (:func:`repro_torch.train.checkpoint.flatten`).  The reference runs
one program a device under ``shard_map`` and reduces with ``psum`` /
``pmax`` over the data axes; the port is single-controller, so
:func:`allreduce_compressed` takes every data shard's tree at once and
reduces through :meth:`repro_torch.launch.mesh.Mesh.reduce` on the
``"data"`` axis (one sum and one max a leaf, each counted in
``mesh.reductions``).
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import MeshAxis
from repro_torch.train.checkpoint import flatten, unflatten


def init_error_state(params):
    """fp32 zeros shaped like every leaf of ``params``."""
    return unflatten(params, [torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device)
                              for p in flatten(params)])


def _quantize_leaf(g: torch.Tensor) -> tuple:
    """Symmetric per-tensor int8: ``scale = (max |g| + 1e-12) / 127``,
    values rounded half to even and clipped to [-127, 127]."""
    amax = torch.max(torch.abs(g)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_gradients(grads, error_state) -> tuple:
    """One shard's gradients -> (int8 tree, scales tree, new error state).

    Error feedback: e' = (g + e) - dequant(quant(g + e))."""
    out = []
    for g, e in zip(flatten(grads), flatten(error_state)):
        corrected = g.float() + e
        q, scale = _quantize_leaf(corrected)
        out.append((q, scale, corrected - q.float() * scale))
    return tuple(unflatten(grads, [o[i] for o in out]) for i in range(3))


def allreduce_compressed(qs: list, scales: list, axis: MeshAxis) -> list:
    """Mean over the ``axis`` shards of the dequantised gradients.

    ``qs[d]`` / ``scales[d]`` are data shard d's int8 tree and scales (from
    :func:`compress_gradients`), ``axis`` a mesh's ``"data"`` axis.  The
    payloads are summed as int32 (an integer all-reduce of int8, exact) and
    dequantised with the largest scale of the shards (scales differ per
    replica; the max is the conservative choice).  Returns one tree a data
    shard, on its device."""
    if axis.name != "data":
        raise ValueError(f"gradients are reduced over 'data', not "
                         f"{axis.name!r}")
    mesh = axis.mesh
    D, M = mesh.shape["data"], mesh.shape["model"]
    if len(qs) != D or len(scales) != D:
        raise ValueError(f"{len(qs)} payloads and {len(scales)} scale trees "
                         f"for {D} data shards")
    flat_q = [flatten(q) for q in qs]
    flat_s = [flatten(s) for s in scales]
    outs = [[] for _ in range(D)]
    for i in range(len(flat_q[0])):
        acc = mesh.reduce("data", [[flat_q[d][i].to(torch.int32)] * M
                                   for d in range(D)])
        s_max = mesh.reduce("data", [[flat_s[d][i]] * M for d in range(D)],
                            op="max")
        for d in range(D):
            outs[d].append(acc[d][0].float() * s_max[d][0] / float(D))
    return [unflatten(qs[d], outs[d]) for d in range(D)]


def wire_bytes(grads, compressed: bool) -> int:
    """Payload bytes of one all-reduce of ``grads``: 1 a value int8, 4 fp32."""
    n = sum(g.numel() for g in flatten(grads))
    return n * (1 if compressed else 4)
