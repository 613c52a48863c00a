"""Precisions the reference computes in, one step below the configuration's
where it stands as the control.

* Codebooks: symmetric per-atom quantisation, ``scale = max|x| / qmax +
  1e-12`` per row in float32 and ``round`` half to even, clamped to
  ``[-qmax, qmax]``; int8 has ``qmax = 127``, the int4 control ``qmax = 7``.
* Matrix products: float32, or TF32 (each operand rounded to 10 explicit
  mantissa bits, products summed in float32, as the tensor cores do),
  emulated the same way on every device.
"""
from __future__ import annotations

import torch

QMAX = {"int8": 127.0, "int4": 7.0}


def dequantized(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """``x [..., D]`` as it is served in ``fmt``, back in float32 (formats
    that are not a quantisation leave it as it is)."""
    x = x.float()
    qmax = QMAX.get(fmt)
    if qmax is None:
        return x
    scale = torch.amax(torch.abs(x), dim=-1, keepdim=True) / qmax + 1e-12
    v = torch.clamp(torch.round(x / scale), -qmax, qmax)
    return v * scale


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 explicit mantissa bits (to
    nearest, ties away from zero)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, fmt: str) -> torch.Tensor:
    """``a @ b`` in float32, or in TF32 for ``fmt == "tf32"``."""
    if fmt == "tf32":
        return tf32(a) @ tf32(b)
    return a @ b
