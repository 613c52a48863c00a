"""Block-code VSA algebra in plain PyTorch.

A hypervector of D elements is B blocks of L = D / B lanes; binding
convolves each block circularly, computed in the Fourier domain.  Unitary
atoms have unit magnitude in every bin of every block, scaled by 1 / sqrt(B)
so the whole vector has norm 1.
"""
from __future__ import annotations

import math

import torch


def blocks(x: torch.Tensor, b: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], b, x.shape[-1] // b)


def flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def bind_all(xs: torch.Tensor, b: int) -> torch.Tensor:
    """Bind the atoms of ``xs [..., F, D]`` along F -> ``[..., D]``."""
    lanes = xs.shape[-1] // b
    spec = torch.prod(torch.fft.rfft(blocks(xs, b).float(), dim=-1), dim=-3)
    return flat(torch.fft.irfft(spec, n=lanes, dim=-1))


def normalize_unitary(x: torch.Tensor, b: int) -> torch.Tensor:
    """Each block's spectrum projected back onto unit magnitude."""
    lanes = x.shape[-1] // b
    spec = torch.fft.rfft(blocks(x, b).float(), dim=-1)
    spec = spec / (torch.abs(spec) + 1e-9)
    out = torch.fft.irfft(spec, n=lanes, dim=-1) / math.sqrt(b)
    return flat(out).to(x.dtype)


def norm2(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


def similarity(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Cosine over the last axis."""
    return torch.sum(x * y, dim=-1) / (norm2(x) * norm2(y) + 1e-9)
