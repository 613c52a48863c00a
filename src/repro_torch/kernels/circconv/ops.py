"""Public entry points of block-wise circular convolution and correlation.

Mirrors the reference's ST-mapping rule (paper Sec. V-D): many independent
rows go to the row-parallel kernel, one long row (L >= 512) to the kernel
that splits its outputs over the grid.  A tensor on the CPU goes to the
plain versions (:mod:`.ref`); a CUDA tensor goes to the hand-written
kernels (:mod:`.kernel`), which launch or raise.  There is no third path
and no fallback.

``rows_launches`` and ``single_launches`` count the two kernels' launches
(plain integers, bumped by :mod:`.kernel`), so a run can show that its binds
went through them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.circconv import kernel as _k
from repro_torch.kernels.circconv import ref as _ref

rows_launches = 0  # circconv_rows launches in this process
single_launches = 0  # circconv_single launches in this process
SINGLE_MIN_L = 512  # one row at least this long takes the single-row scheme


def uses_single(n_rows: int, L: int) -> bool:
    """The ST-mapping rule (reference ``kernels/circconv/ops.py:32``)."""
    return n_rows == 1 and L >= SINGLE_MIN_L


def block_circconv(xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    """Block-wise circular convolution, blocked layout [..., B, L].

    Both operands broadcast to their common leading shape (the reference
    broadcasts only ``yb`` to ``xb``'s shape); the result has that shape and
    ``xb``'s dtype, summed in fp32.  Operands of two dtypes are both taken
    to float32 first.  The rows kernel reads the broadcast operands as
    views (stride 0 where broadcast); they are copied only where their
    strides do not collapse into the kernel's dims or L is not unit-stride.
    Under autograd with an operand that requires grad it raises
    (:func:`repro_torch.kernels.refuse_grad`).
    """
    refuse_grad("block_circconv", xb, yb)
    shape = torch.broadcast_shapes(xb.shape, yb.shape)
    L = shape[-1]
    dtype = xb.dtype
    if xb.dtype != yb.dtype:
        xb, yb = xb.float(), yb.float()
    x, y = xb.expand(shape), yb.expand(shape)
    on_cpu = x.device.type == "cpu"
    if uses_single(math.prod(shape[:-1]), L):
        single = _ref.circconv_single_ref if on_cpu else _k.circconv_single
        out = single(x.reshape(L).contiguous(), y.reshape(L).contiguous())
    elif on_cpu:
        out = _ref.circconv_rows_ref(x.reshape(-1, L).contiguous(),
                                     y.reshape(-1, L).contiguous())
    else:
        if _k.rows_plan(shape, x.stride(), y.stride()) is None:
            x, y = x.contiguous(), y.contiguous()
        out = _k.circconv_rows(x, y)
    return out.to(dtype).reshape(shape)


def block_circcorr(qb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    """Block-wise circular correlation (unbinding direction): the
    convolution with ``yb``'s involution, so one kernel launch."""
    return block_circconv(qb, _ref.involute(yb))


# Re-export the oracle for tests.
block_circconv_ref = _ref.block_circconv_ref
