"""Probabilistic rule abduction and execution (PrAE/NVSA-style, Sec. II-D).

The port of ``repro/core/symbolic.py``.  Operates on per-panel attribute
*value distributions* (soft beliefs from the factorizer or the CNN head).
For every attribute the engine scores each candidate rule by the probability
that the two complete rows of the RPM grid are consistent with it
(abduction), then executes the posterior-weighted rules on the incomplete
row to predict the missing panel's attribute distribution (execution), and
finally ranks the 8 candidate panels.

*Arithmetic* rules over modular attribute values are circular convolution /
correlation of probability vectors, computed here with ``torch.fft`` as the
reference does with ``jnp.fft`` (n = 5, 6 or 10: no kernel is involved).
"""
from __future__ import annotations

import torch

RULES = ("constant", "progression_p1", "progression_m1", "arithmetic_plus",
         "arithmetic_minus", "distribute_three")
NUM_RULES = len(RULES)


def _circconv_p(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Circular convolution of probability vectors (arithmetic_plus execution)."""
    n = p.shape[-1]
    fp = torch.fft.rfft(p, dim=-1) * torch.fft.rfft(q, dim=-1)
    return torch.clamp(torch.fft.irfft(fp, n=n, dim=-1), min=0.0)


def _circcorr_p(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Circular correlation: distribution of (a - b) mod n."""
    n = p.shape[-1]
    fp = torch.fft.rfft(p, dim=-1) * torch.conj(torch.fft.rfft(q, dim=-1))
    return torch.clamp(torch.fft.irfft(fp, n=n, dim=-1), min=0.0)


def _shift(p: torch.Tensor, k: int) -> torch.Tensor:
    return torch.roll(p, k, dims=-1)


def _row_rule_score(p1, p2, p3) -> torch.Tensor:
    """Probability each rule explains one complete row. p*: [..., n] -> [..., R-1]."""
    s_const = torch.sum(p1 * p2 * p3, dim=-1)
    s_prog_p = torch.sum(p1 * _shift(p2, -1) * _shift(p3, -2), dim=-1)
    s_prog_m = torch.sum(p1 * _shift(p2, 1) * _shift(p3, 2), dim=-1)
    s_arith_p = torch.sum(_circconv_p(p1, p2) * p3, dim=-1)
    s_arith_m = torch.sum(_circcorr_p(p1, p2) * p3, dim=-1)
    return torch.stack([s_const, s_prog_p, s_prog_m, s_arith_p, s_arith_m],
                       dim=-1)


def abduce_rules(grid_p: torch.Tensor) -> torch.Tensor:
    """Rule posterior per attribute from the two complete rows.

    grid_p: [..., 3, 3, n] panel attribute distributions -> [..., R] posterior.
    """
    s_row0 = _row_rule_score(grid_p[..., 0, 0, :], grid_p[..., 0, 1, :],
                             grid_p[..., 0, 2, :])
    s_row1 = _row_rule_score(grid_p[..., 1, 0, :], grid_p[..., 1, 1, :],
                             grid_p[..., 1, 2, :])
    score = s_row0 * s_row1  # independent rows, shared rule
    # distribute_three is a cross-row constraint: both rows carry the *same*
    # set of three distinct values (in some order).
    set0 = torch.mean(grid_p[..., 0, :, :], dim=-2)  # [..., n] row-0 value set
    set1 = torch.mean(grid_p[..., 1, :, :], dim=-2)
    distinct0 = 1 - torch.sum(grid_p[..., 0, 0, :] * grid_p[..., 0, 1, :], dim=-1)
    distinct1 = 1 - torch.sum(grid_p[..., 1, 0, :] * grid_p[..., 1, 1, :], dim=-1)
    set_match = torch.sum(torch.minimum(set0, set1) * 3.0, dim=-1) / 3.0
    s_dist3 = (set_match ** 3) * distinct0 * distinct1
    score = torch.cat([score, s_dist3[..., None]], dim=-1)
    return score / (torch.sum(score, dim=-1, keepdim=True) + 1e-12)


def execute_rules(grid_p: torch.Tensor, rule_post: torch.Tensor) -> torch.Tensor:
    """Posterior-weighted prediction of panel (2,2)'s attribute distribution.

    grid_p: [..., 3, 3, n]; rule_post: [..., R] -> [..., n].
    """
    p7, p8 = grid_p[..., 2, 0, :], grid_p[..., 2, 1, :]
    preds = [
        (p7 + p8) / 2.0,  # constant
        _shift(p8, 1),  # progression +1: p9(v) = p8(v-1)
        _shift(p8, -1),  # progression -1: p9(v) = p8(v+1)
        _circconv_p(p7, p8),  # arithmetic_plus: v3 = v1 + v2
        _circcorr_p(p7, p8),  # arithmetic_minus: v3 = v1 - v2
    ]
    # distribute_three: the set from complete rows minus the two seen values.
    srow = (grid_p[..., 0, 0, :] + grid_p[..., 0, 1, :] + grid_p[..., 0, 2, :]) / 3.0
    d3 = torch.clamp(srow * (1 - p7) * (1 - p8), min=0.0)
    preds.append(d3 / (torch.sum(d3, dim=-1, keepdim=True) + 1e-12))
    pred = torch.einsum("...r,r...n->...n", rule_post, torch.stack(preds))
    return pred / (torch.sum(pred, dim=-1, keepdim=True) + 1e-12)


def score_candidates(pred_p: torch.Tensor, cand_values: torch.Tensor) -> torch.Tensor:
    """Log-likelihood of each candidate's attribute value under the prediction.

    pred_p: [..., n]; cand_values: [..., 8] int -> [..., 8] log-probs.
    """
    probs = torch.gather(pred_p, -1, torch.as_tensor(
        cand_values, device=pred_p.device).long())
    return torch.log(probs + 1e-9)


def solve_attribute_grids(grids: dict, candidates: dict) -> torch.Tensor:
    """End-to-end symbolic solve from soft grids.

    grids: attr -> [batch, 3, 3, n_a] distributions (panel (2,2) ignored);
    candidates: attr -> [batch, 8] int values.  Returns [batch] answer index.
    """
    total = 0.0
    for a, grid_p in grids.items():
        post = abduce_rules(grid_p)
        pred = execute_rules(grid_p, post)
        total = total + score_candidates(pred, candidates[a])
    return torch.argmax(total, dim=-1)
