"""Low-precision operation (paper Sec. IV-B, Tab. IX).

The port of ``repro/core/quantization.py``: symmetric per-row INT8 and FP8
(e4m3 / e5m2) quantisation of codebooks, with per-row float32 scales.

``int8 @ int8`` in PyTorch returns int8 and wraps on the CPU, and has no
CUDA implementation at all, so the int8 contraction of
:func:`quantized_matvec` accumulates in float64: every sum of int8 products
below 2^53 is exact there, as the reference's int32 accumulation is.
"""
from __future__ import annotations

from typing import Literal

import torch

FpFormat = Literal["int8", "fp8_e4m3", "fp8_e5m2"]

FP8_DTYPES = {"fp8_e4m3": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}
_FP8_MAX = {"fp8_e4m3": 448.0, "fp8_e5m2": 57344.0}  # largest normal of each


class QTensor:
    """Quantised tensor: ``values`` (int8 / fp8) plus per-row (last-axis)
    float32 ``scale`` of shape ``[..., 1]``.

    Indexing takes leading rows of both, so ``codebooks[f]`` is factor
    ``f``'s ``[M, D]`` codebook with its ``[M, 1]`` scales.
    """

    def __init__(self, values: torch.Tensor, scale: torch.Tensor):
        self.values = values
        self.scale = scale

    @property
    def shape(self) -> torch.Size:
        return self.values.shape

    @property
    def device(self) -> torch.device:
        return self.values.device

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return self.values.to(dtype) * self.scale.to(dtype)

    def nbytes(self) -> int:
        return (self.values.numel() * self.values.element_size()
                + self.scale.numel() * 4)

    def to(self, device) -> "QTensor":
        return QTensor(self.values.to(device), self.scale.to(device))

    def __getitem__(self, index) -> "QTensor":
        return QTensor(self.values[index], self.scale[index])


def quantize(x: torch.Tensor, fmt: FpFormat = "int8") -> QTensor:
    """Symmetric per-row quantisation over the last axis.

    The scale is ``amax / qmax + 1e-12`` in float32, spelled as the
    reference spells it (the 1e-12 only guards all-zero rows), so values and
    scales equal the reference's bit for bit.  ``torch.round`` rounds half
    to even, as ``jnp.round`` does.
    """
    x = x.float()
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    if fmt == "int8":
        scale = amax / 127.0 + 1e-12
        v = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    elif fmt in FP8_DTYPES:
        scale = amax / _FP8_MAX[fmt] + 1e-12
        v = (x / scale).to(FP8_DTYPES[fmt])
    else:
        raise ValueError(fmt)
    return QTensor(v, scale.to(torch.float32))


def quantized_matvec(q: torch.Tensor, w: QTensor) -> torch.Tensor:
    """scores = q [..., D] @ dequant(w [M, D]).T.

    For int8 codebooks the activation is quantised too and the contraction
    is int8 x int8, accumulated exactly (float64 here, int32 in the
    reference); fp8 dequantises to bf16 and contracts in bf16.
    """
    if w.values.dtype == torch.int8:
        qq = quantize(q, "int8")
        acc = qq.values.to(torch.float64) @ w.values.to(torch.float64).T
        return acc.to(torch.float32) * qq.scale * w.scale[:, 0]
    wf = w.dequantize(torch.bfloat16)
    return (q.to(torch.bfloat16) @ wf.T).to(torch.float32)


def quantization_error(x: torch.Tensor, fmt: FpFormat = "int8") -> torch.Tensor:
    """Relative L2 reconstruction error (monitoring / tests)."""
    xq = quantize(x, fmt).dequantize()
    return torch.linalg.norm(x - xq) / (torch.linalg.norm(x) + 1e-12)
