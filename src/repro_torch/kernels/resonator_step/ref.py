"""Plain PyTorch versions of the fused resonator step (bipolar algebra).

One factorizer iteration for factor f (paper Fig. 8 steps 1-3, MAP algebra):
    u      = q * prod(est, axis=0) * est[f]        (unbind; est in {-1, +1})
    alpha  = X[f] @ u                              (similarity)
    w      = act(alpha)                            (identity | abs)
    est'_f = sign(w @ X[f])                        (projection + saturation)

The masked version adds the codebook-validity contract: invalid rows score
``-1e9`` (never win the argmax) and contribute zero weight to the
projection.  The local version is one model shard's half of the masked
sweep: raw local scores and the partial, unsaturated projection, which the
caller sums over shards and saturates.  The CPU path of :mod:`.ops` runs
these, and ``chip_smoke.py`` holds the CUDA kernel against them on the
card.
"""
from __future__ import annotations

import torch

_NEG = -1e9


def resonator_step_batch_ref(qs, est, codebooks, activation: str = "identity"):
    """qs: [N, D]; est: [N, F, D] bipolar; codebooks: [F, M, D].

    Returns (alpha [N, F, M], new_est [N, F, D]) — the Gauss-Jacobi sweep
    (all factors from the same snapshot)."""
    prod = torch.prod(est, dim=1)  # [N, D]
    u = qs[:, None] * prod[:, None] * est  # [N, F, D]
    alpha = torch.einsum("nfd,fmd->nfm", u, codebooks)
    w = torch.abs(alpha) if activation == "abs" else alpha
    proj = torch.einsum("nfm,fmd->nfd", w, codebooks)
    new_est = torch.where(proj >= 0, 1.0, -1.0).to(est.dtype)
    return alpha, new_est


def resonator_step_batch_masked_ref(qs, est, codebooks, valid_mask,
                                    activation: str = "identity"):
    """Mask-aware version.  valid_mask: [F, M] bool or {0,1} -> (alpha
    [N, F, M] with invalid rows at -1e9, new_est [N, F, D]) — the exact
    score-neutralise / weight-zero sequence of the unfused masked path."""
    valid = valid_mask.to(torch.bool)
    prod = torch.prod(est, dim=1)
    u = qs[:, None] * prod[:, None] * est
    alpha = torch.einsum("nfd,fmd->nfm", u, codebooks)
    alpha = torch.where(valid[None], alpha, _NEG)
    w = torch.abs(alpha) if activation == "abs" else alpha
    w = w * valid[None]
    proj = torch.einsum("nfm,fmd->nfd", w, codebooks)
    new_est = torch.where(proj >= 0, 1.0, -1.0).to(est.dtype)
    return alpha, new_est


def resonator_step_batch_local_ref(qs, est, cb_local, valid_mask_local=None,
                                   activation: str = "identity"):
    """One model shard's rows ``cb_local`` [F, M_loc, D] and its mask slice
    [F, M_loc] (None: all valid) -> (alpha_loc [N, F, M_loc] RAW,
    part_proj [N, F, D] fp32, not saturated)."""
    prod = torch.prod(est, dim=1)
    u = qs[:, None] * prod[:, None] * est
    alpha = torch.einsum("nfd,fmd->nfm", u, cb_local)
    if valid_mask_local is None:
        valid_mask_local = torch.ones(cb_local.shape[:2], dtype=torch.bool,
                                      device=cb_local.device)
    valid = valid_mask_local.to(torch.bool)
    w = torch.where(valid[None], alpha, _NEG)
    w = (torch.abs(w) if activation == "abs" else w) * valid[None]
    part_proj = torch.einsum("nfm,fmd->nfd", w, cb_local)
    return alpha, part_proj


def resonator_step_ref(q, est, codebooks, activation: str = "identity"):
    """Single-query version: q: [D]; est: [F, D] -> (alpha [F, M], new_est [F, D])."""
    alpha, new_est = resonator_step_batch_ref(q[None], est[None], codebooks,
                                              activation=activation)
    return alpha[0], new_est[0]
