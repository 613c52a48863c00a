"""Optimizers with the reference's update rules (SGD-M, AdamW, Adafactor).

The port of ``repro/train/optimizer.py``.  Each optimizer is a
``torch.optim.Optimizer`` whose ``step()`` applies the reference's rule to
every parameter that has a gradient; ``torch.optim.AdamW`` and
``torch.optim.Adafactor`` differ from it (weight decay added to the update
and multiplied by the lr, eps inside the bias-corrected root, factored
moments updated from the mean of g^2 + eps, the update's RMS clipped to 1),
so they are not used.  The reference's names stand: ``sgd``, ``adamw`` and
``adafactor`` construct the classes.

State is made when the optimizer is built, as the reference's ``init``
makes it, so :meth:`_Base.state_tree` has a fixed structure that a
checkpoint can hold.  The 1-based ``step`` is one 0-d int32 CPU tensor a
param group, shared by its parameters' state (``lr`` may be a callable of
it, as in the reference);
SGD's and AdamW's moments are kept in ``state_dtype`` (bf16 halves them) and
computed in fp32; Adafactor's are fp32.  Scalars are rounded to fp32 as the
reference's jnp computes them.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable

import numpy as np
import torch

f32 = np.float32


class _Base(torch.optim.Optimizer):
    """Shared plumbing: eager state, the step counter, the lr at a step."""

    def __init__(self, params, defaults: dict):
        super().__init__(params, defaults)
        for group in self.param_groups:
            # One counter a group, the same tensor in each parameter's state,
            # as the reference keeps one ``step`` for the whole tree.
            step = torch.zeros((), dtype=torch.int32)
            for p in group["params"]:
                self.state[p] = {"step": step, **self._init_state(p, group)}

    def _init_state(self, p: torch.Tensor, group: dict) -> dict:
        raise NotImplementedError

    def _update(self, p: torch.Tensor, g: torch.Tensor, state: dict,
                group: dict, step: int, lr: float) -> None:
        raise NotImplementedError

    def state_tree(self) -> list:
        """Every parameter's state dict in parameter order: the tensors a
        checkpoint saves and restores in place."""
        return [self.state[p] for group in self.param_groups
                for p in group["params"]]

    @torch.no_grad()
    def step(self, closure: Callable | None = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            live = [p for p in group["params"] if p.grad is not None]
            if not live:
                continue
            counter = self.state[live[0]]["step"]
            counter.add_(1)
            step = int(counter)
            lr = group["lr"]
            lr = float(lr(step)) if callable(lr) else float(f32(lr))
            for p in live:
                self._update(p, p.grad, self.state[p], group, step, lr)
        return loss


class SGD(_Base):
    """SGD with momentum: ``mu = momentum mu + g``, ``p -= lr mu``."""

    def __init__(self, params: Iterable, lr: float | Callable,
                 momentum: float = 0.9, state_dtype=torch.float32):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      state_dtype=state_dtype))

    def _init_state(self, p, group):
        return {"mu": torch.zeros_like(p, dtype=group["state_dtype"])}

    def _update(self, p, g, state, group, step, lr):
        mu = group["momentum"] * state["mu"].float() + g
        p.copy_(p - lr * mu.to(p.dtype))
        state["mu"].copy_(mu)


class AdamW(_Base):
    """AdamW as the reference writes it: bias-corrected moments, eps added
    to the corrected root, weight decay added to the update (``u + wd
    p``) before the lr scales it."""

    def __init__(self, params: Iterable, lr: float | Callable,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, state_dtype=torch.float32):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay,
                                      state_dtype=state_dtype))

    def _init_state(self, p, group):
        return {"m": torch.zeros_like(p, dtype=group["state_dtype"]),
                "v": torch.zeros_like(p, dtype=group["state_dtype"])}

    def _update(self, p, g, state, group, step, lr):
        # The reference's arithmetic op for op, written in place: fp32
        # moments are updated where they lie, and a leaf costs two
        # leaf-sized temporaries (a full-width model's largest leaf is
        # 1.58 GB), not seven.
        b1, b2 = group["b1"], group["b2"]
        bc1 = float(f32(1) - f32(b1) ** f32(step))
        bc2 = float(f32(1) - f32(b2) ** f32(step))
        g = g.float()
        m32, v32 = state["m"].float(), state["v"].float()  # copies if bf16
        m32.mul_(b1).add_((1 - b1) * g)
        v32.mul_(b2).add_((1 - b2) * g * g)
        den = (v32 / bc2).sqrt_().add_(group["eps"])
        u = (m32 / bc1).div_(den)
        del den
        if group["weight_decay"]:
            u.add_(group["weight_decay"] * p.float())
        p.sub_(u.to(p.dtype).mul_(lr))
        if m32 is not state["m"]:
            state["m"].copy_(m32)
            state["v"].copy_(v32)


class Adafactor(_Base):
    """Factored second moments: a leaf whose last two dims are both at least
    ``min_dim_size_to_factor`` keeps a row and a column mean (O(n + m)
    state) in place of its full second moment; the update's RMS is clipped
    to 1."""

    def __init__(self, params: Iterable, lr: float | Callable = 1e-2,
                 decay: float = 0.8, eps: float = 1e-30,
                 min_dim_size_to_factor: int = 128):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      min_dim=min_dim_size_to_factor))

    @staticmethod
    def factored(shape, min_dim: int) -> bool:
        return len(shape) >= 2 and shape[-1] >= min_dim \
            and shape[-2] >= min_dim

    def _init_state(self, p, group):
        kw = dict(dtype=torch.float32, device=p.device)
        if self.factored(p.shape, group["min_dim"]):
            return {"vr": torch.zeros(p.shape[:-1], **kw),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **kw)}
        return {"v": torch.zeros(p.shape, **kw)}

    def _update(self, p, g, state, group, step, lr):
        eps = group["eps"]
        beta = float(f32(1) - f32(step) ** f32(-group["decay"]))
        g = g.float()
        g2 = g * g + eps
        if "vr" in state:
            vr = beta * state["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
            vc = beta * state["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
            denom = torch.sqrt(
                vr[..., None] * vc[..., None, :]
                / (torch.mean(vr, dim=-1, keepdim=True)[..., None] + eps))
            u = g / (denom + eps)
            state["vr"].copy_(vr)
            state["vc"].copy_(vc)
        else:
            v = beta * state["v"] + (1 - beta) * g2
            u = g / (torch.sqrt(v) + eps)
            state["v"].copy_(v)
        # update clipping (RMS <= 1) as in the original paper
        rms = torch.sqrt(torch.mean(u * u) + eps)
        u = u / torch.clamp(rms, min=1.0)
        p.copy_(p - lr * u.to(p.dtype))


sgd, adamw, adafactor = SGD, AdamW, Adafactor  # the reference's names


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` (an iterable of tensors, ``None`` skipped, or a dict
    of them) in place so that their global L2 norm is at most ``max_norm``,
    by ``min(1, max_norm / (norm + 1e-9))`` as the reference does.  Returns
    ``(grads, norm)``; the norm stays a 0-d fp32 tensor on the grads'
    device (no host sync)."""
    ts = [g for g in (grads.values() if isinstance(grads, dict) else grads)
          if g is not None]
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in ts))
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for g in ts:
        g.mul_(scale.to(g.dtype))
    return grads, norm


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable[[int], float]:
    """Linear warmup to ``peak_lr``, then a cosine down to ``floor x
    peak_lr`` at ``total``; computed in fp32 as the reference does."""

    def lr(step) -> float:
        s = f32(int(step))
        if s < warmup:
            return float(f32(peak_lr) * s / f32(max(warmup, 1)))
        frac = np.clip((s - f32(warmup)) / f32(max(total - warmup, 1)),
                       f32(0), f32(1))
        # cos rounded once from float64: XLA's fp32 cos is within an ulp
        cos = f32(math.cos(float(f32(math.pi) * frac)))
        return float(f32(peak_lr) * (f32(floor) + f32(1 - floor) * f32(0.5)
                                     * (f32(1) + cos)))

    return lr


def wsd_schedule(peak_lr: float, warmup: int, total: int,
                 decay_frac: float = 0.1) -> Callable[[int], float]:
    """Warmup-Stable-Decay (MiniCPM's schedule): linear warmup, a plateau at
    ``peak_lr``, a linear decay over the last ``decay_frac`` of ``total``."""
    decay_start = int(total * (1 - decay_frac))

    def lr(step) -> float:
        s = f32(int(step))
        if s < warmup:
            return float(f32(peak_lr) * s / f32(max(warmup, 1)))
        if s < decay_start:
            return float(f32(peak_lr))
        return float(f32(peak_lr) * np.clip(
            f32(1) - (s - f32(decay_start))
            / f32(max(total - decay_start, 1)), f32(0), f32(1)))

    return lr
