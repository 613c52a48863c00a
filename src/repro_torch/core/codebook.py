"""Exhaustive product-codebook baseline (the thing CogSys replaces).

The port of ``repro/core/codebook.py``.  Pre-binds all M^F attribute
combinations into one giant codebook and decodes a query by brute-force
similarity search: the paper's Sec. III-C "symbolic knowledge codebook",
whose tens-to-hundreds-of-MB footprint makes it "impractical to be cached
on-chip"; the accuracy and memory baseline of Fig. 4d / Tab. VIII.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import vsa
from repro_torch.core.vsa import VSAConfig


class ProductCodebook(NamedTuple):
    vectors: torch.Tensor  # [M**F, D]
    shape: tuple  # (M,) * F for unravelling


def build_product_codebook(codebooks: torch.Tensor,
                           cfg: VSAConfig) -> ProductCodebook:
    """Bind every combination: [F, M, D] -> [M^F, D] (spectral-domain outer
    product; the first factor varies slowest)."""
    F, M, D = codebooks.shape
    spec = torch.fft.rfft(cfg.blockify(codebooks.float()), dim=-1)  # [F,M,B,Lf]
    prod = spec[0]
    for f in range(1, F):
        prod = (prod[:, None] * spec[f][None]).reshape(-1, *prod.shape[1:])
    vecs = cfg.flatten(torch.fft.irfft(prod, n=cfg.lanes, dim=-1))
    return ProductCodebook(vecs, (M,) * F)


def brute_force_decode(q: torch.Tensor, pcb: ProductCodebook) -> torch.Tensor:
    """Argmax similarity over all M^F combinations: q [D] -> [F] indices
    (q [N, D] -> [N, F]), int32."""
    flat = torch.argmax(vsa.codebook_similarity(q, pcb.vectors), dim=-1)
    digits = []
    for m in reversed(pcb.shape):  # row-major unravel, last factor fastest
        digits.append(flat % m)
        flat = flat // m
    return torch.stack(digits[::-1], dim=-1).to(torch.int32)


def product_codebook_bytes(num_factors: int, codebook_size: int, dim: int,
                           itemsize: int = 4) -> int:
    return (codebook_size ** num_factors) * dim * itemsize
