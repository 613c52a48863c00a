"""Plain PyTorch versions of block-wise circular convolution / correlation.

``c[r, n] = sum_k x[r, k] * y[r, (n - k) mod L]`` for every independent row
r, as the circulant gather plus an einsum with fp32 sums: O(L^2) memory per
row.  The CPU path of :mod:`.ops` runs them, and ``chip_smoke.py`` holds the
CUDA kernels against them on the card.
"""
from __future__ import annotations

import torch


def circconv_rows_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Row-wise circular convolution. x, y: [N, L] -> [N, L] (float32 accum)."""
    L = x.shape[-1]
    n = torch.arange(L, device=x.device)
    idx = (n[:, None] - n[None, :]) % L  # [n, k]
    yc = y[..., idx]  # [N, L(n), L(k)]
    return torch.einsum("nk,nok->no", x.float(), yc.float())


def circconv_single_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Circular convolution of two vectors [L] -> [L] (float32 accum)."""
    return circconv_rows_ref(x[None], y[None])[0]


def involute(y: torch.Tensor) -> torch.Tensor:
    """Index reversal along the last dim, y[(-n) mod L]: convolving with it
    correlates with y."""
    return torch.cat([y[..., :1], torch.flip(y[..., 1:], dims=(-1,))], dim=-1)


def circcorr_rows_ref(q: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Row-wise circular correlation: c[r, n] = sum_k q[r, (n + k) mod L] y[r, k]."""
    return circconv_rows_ref(q, involute(y))


def block_circconv_ref(xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    """Blocked layout oracle. xb, yb: [..., B, L] -> [..., B, L]."""
    L = xb.shape[-1]
    out = circconv_rows_ref(xb.reshape(-1, L), yb.reshape(-1, L))
    return out.reshape(*xb.shape[:-1], L)
