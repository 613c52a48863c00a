"""Device policy of the port.

Every entry point takes ``device=`` and defaults to ``"cuda"``: the port
runs on the card unless the caller asks for the CPU.  Asking for CUDA where
there is none raises; nothing continues on the CPU behind the caller's back.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` for CUDA on
    a machine without a usable GPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev


def disable_tf32() -> None:
    """Full fp32 for matmuls and cuDNN convolutions (parity runs call this:
    the reference computes in fp32, and TF32 keeps about three digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def generator(seed) -> torch.Generator:
    """A CPU ``torch.Generator`` from an int seed (a Generator passes
    through).  Random tensors are drawn on the CPU and then moved, so one
    seed gives the same numbers on every device."""
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator().manual_seed(int(seed))
