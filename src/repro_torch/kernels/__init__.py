"""Hand-written CUDA kernels, each beside its plain PyTorch version."""
from __future__ import annotations

import torch


def refuse_grad(name: str, *operands) -> None:
    """Raise ``RuntimeError`` where autograd would need ``name``'s gradient.

    The kernels have no backward, as the reference's ``pallas_call`` has
    none (``jax.grad`` through it raises).  With grad enabled and an operand
    that requires it, an entry point raises on every device, the CPU's plain
    version included, so that one training script cannot differentiate
    there and silently cut the gradient on the card.  Inference (no operand
    requires grad, or ``torch.no_grad()``) is untouched.
    """
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in operands):
        raise RuntimeError(
            f"{name}: the kernel has no gradient, as the reference's "
            "pallas_call has none, and an operand requires grad; training "
            "binds through impl='fft' (or call it under torch.no_grad())")
