"""PrAE: Probabilistic Abduction and Execution learner (paper workload 4).

The port of ``repro/models/prae.py``.  The VSA-free member of the paper's
workload set: the CNN's attribute heads emit probability vectors directly
and the symbolic engine (``core/symbolic.py``) abduces and executes on them,
with no hypervector bottleneck and no factorizer.  Its role in the paper
(and here) is the contrast class to NVSA, which routes everything through
bound representations.  Runs on the model's device.
"""
from __future__ import annotations

import torch

from repro_torch.core import symbolic as sym
from repro_torch.data import raven
from repro_torch.models import cnn


def perceive_probs(model: cnn.CNN, images: torch.Tensor,
                   cfg: cnn.CNNConfig) -> list:
    """images [..., H, W] -> per-attribute probability tensors [..., n_a]."""
    flat = images.reshape(-1, *images.shape[-2:])
    out = cnn.apply(model, flat, cfg)
    return [torch.softmax(l, dim=-1).reshape(*images.shape[:-2], -1)
            for l in out["attr_logits"]]


def candidate_scores(model: cnn.CNN, batch: dict,
                     cfg: cnn.CNNConfig) -> torch.Tensor:
    """Per-candidate totals [B, 8]: the sum over attributes of the log
    expected probability of the candidate's perceived value under the
    executed prediction.  batch: images [B, 9, H, W], candidate_images
    [B, 8, H, W] (tensors or numpy)."""
    dev = model.head_h_w.device
    images = torch.as_tensor(batch["images"], device=dev)
    cands = torch.as_tensor(batch["candidate_images"], device=dev)
    B = images.shape[0]
    ctx_p = perceive_probs(model, images[:, :8], cfg)  # per attr [B, 8, n]
    cand_p = perceive_probs(model, cands, cfg)  # [B, 8, n]
    total = torch.zeros((B, 8), device=dev)
    for a, name in enumerate(raven.ATTRS):
        n = raven.ATTR_SIZES[name]
        pad = torch.full((B, 1, n), 1.0 / n, device=dev)
        grid = torch.cat([ctx_p[a], pad], dim=1).reshape(B, 3, 3, n)
        post = sym.abduce_rules(grid)
        pred = sym.execute_rules(grid, post)  # [B, n]
        # score candidates by the expected probability of their perceived value
        total = total + torch.log(
            torch.einsum("bn,bcn->bc", pred, cand_p[a]) + 1e-9)
    return total


def solve(model: cnn.CNN, batch: dict, cfg: cnn.CNNConfig) -> torch.Tensor:
    """End-to-end PrAE solve: probabilities -> abduction -> execution -> pick."""
    return torch.argmax(candidate_scores(model, batch, cfg), dim=-1)


def accuracy(model: cnn.CNN, batch: dict, cfg: cnn.CNNConfig) -> torch.Tensor:
    pred = solve(model, batch, cfg)
    answer = torch.as_tensor(batch["answer"], device=pred.device)
    return torch.mean((pred == answer).float())
