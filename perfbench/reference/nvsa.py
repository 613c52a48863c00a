"""NVSA's probabilistic abduction tail (Hersche et al. 2023), plain PyTorch.

From the factorizer's scores of a task's 8 context panels: beliefs (a
masked softmax of the cosines at ``belief_temp``), per attribute the 3x3
grid with the missing panel uniform, the posterior over six row rules from
the two complete rows, the posterior-weighted prediction of the missing
panel, the expected atoms bound into the predicted panel vector, and the 8
candidates ranked by cosine.
"""
from __future__ import annotations

import torch

from perfbench.reference import quant, vsa


def beliefs(queries: torch.Tensor, scores: torch.Tensor, mask: torch.Tensor,
            temp: float) -> torch.Tensor:
    """queries ``[N, D]``, scores ``[N, F, M]`` -> beliefs ``[N, F, M]``."""
    qnorm = torch.linalg.norm(queries, dim=-1)[:, None, None] + 1e-9
    cos = scores / qnorm
    return torch.softmax(torch.where(mask[None], temp * cos,
                                     torch.tensor(-1e9, device=cos.device)),
                         dim=-1)


def _cconv(p, q):
    n = p.shape[-1]
    f = torch.fft.rfft(p, dim=-1) * torch.fft.rfft(q, dim=-1)
    return torch.clamp(torch.fft.irfft(f, n=n, dim=-1), min=0.0)


def _ccorr(p, q):
    n = p.shape[-1]
    f = torch.fft.rfft(p, dim=-1) * torch.conj(torch.fft.rfft(q, dim=-1))
    return torch.clamp(torch.fft.irfft(f, n=n, dim=-1), min=0.0)


def _row_scores(p1, p2, p3):
    roll = torch.roll
    return torch.stack([
        torch.sum(p1 * p2 * p3, dim=-1),
        torch.sum(p1 * roll(p2, -1, dims=-1) * roll(p3, -2, dims=-1), dim=-1),
        torch.sum(p1 * roll(p2, 1, dims=-1) * roll(p3, 2, dims=-1), dim=-1),
        torch.sum(_cconv(p1, p2) * p3, dim=-1),
        torch.sum(_ccorr(p1, p2) * p3, dim=-1)], dim=-1)


def rule_posterior(g: torch.Tensor) -> torch.Tensor:
    """grid ``[..., 3, 3, n]`` -> posterior over the six rules ``[..., 6]``."""
    score = (_row_scores(g[..., 0, 0, :], g[..., 0, 1, :], g[..., 0, 2, :])
             * _row_scores(g[..., 1, 0, :], g[..., 1, 1, :], g[..., 1, 2, :]))
    set0 = torch.mean(g[..., 0, :, :], dim=-2)
    set1 = torch.mean(g[..., 1, :, :], dim=-2)
    d0 = 1 - torch.sum(g[..., 0, 0, :] * g[..., 0, 1, :], dim=-1)
    d1 = 1 - torch.sum(g[..., 1, 0, :] * g[..., 1, 1, :], dim=-1)
    match = torch.sum(torch.minimum(set0, set1) * 3.0, dim=-1) / 3.0
    score = torch.cat([score, ((match ** 3) * d0 * d1)[..., None]], dim=-1)
    return score / (torch.sum(score, dim=-1, keepdim=True) + 1e-12)


def predict(g: torch.Tensor, post: torch.Tensor) -> torch.Tensor:
    """The missing panel's distribution ``[..., n]``."""
    p7, p8 = g[..., 2, 0, :], g[..., 2, 1, :]
    srow = (g[..., 0, 0, :] + g[..., 0, 1, :] + g[..., 0, 2, :]) / 3.0
    d3 = torch.clamp(srow * (1 - p7) * (1 - p8), min=0.0)
    preds = torch.stack([
        (p7 + p8) / 2.0, torch.roll(p8, 1, dims=-1), torch.roll(p8, -1, dims=-1),
        _cconv(p7, p8), _ccorr(p7, p8),
        d3 / (torch.sum(d3, dim=-1, keepdim=True) + 1e-12)])
    pred = torch.einsum("...r,r...n->...n", post, preds)
    return pred / (torch.sum(pred, dim=-1, keepdim=True) + 1e-12)


def answers(bel: torch.Tensor, cand: torch.Tensor, atoms: torch.Tensor,
            sizes, blocks: int, fmt: str = "fp32") -> tuple:
    """beliefs ``[B, 8, F, M]``, candidates ``[B, 8, D]``, atoms ``[F, M, D]``
    -> (answer ``[B]``, cosines ``[B, 8]``); the expected atoms' products in
    ``fmt`` (float32 or TF32)."""
    B = bel.shape[0]
    pred_atoms = []
    for a, n in enumerate(sizes):
        g = bel[:, :, a, :n]
        g = g / (g.sum(-1, keepdim=True) + 1e-9)
        pad = torch.full((B, 1, n), 1.0 / n, device=g.device)
        grid = torch.cat([g, pad], dim=1).reshape(B, 3, 3, n)
        pred_atoms.append(quant.matmul(predict(grid, rule_posterior(grid)),
                                       atoms[a, :n], fmt))
    pred_q = vsa.bind_all(torch.stack(pred_atoms, dim=1), blocks)
    sims = vsa.similarity(pred_q[:, None, :], cand)
    return torch.argmax(sims, dim=-1), sims
