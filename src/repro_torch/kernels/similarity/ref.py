"""Plain PyTorch version of the int8 codebook similarity (factorizer Step 2).

The CPU path of :mod:`.ops` runs it, and ``chip_smoke.py`` holds the CUDA
kernel against it on the card.
"""
from __future__ import annotations

import torch


def similarity_int8_ref(q: torch.Tensor, w_int8: torch.Tensor,
                        w_scale: torch.Tensor) -> torch.Tensor:
    """q: [N, D] fp32; w_int8: [M, D] int8; w_scale: [M, 1] fp32 -> [N, M] fp32."""
    wf = w_int8.to(torch.float32) * w_scale
    return q.to(torch.float32) @ wf.T
