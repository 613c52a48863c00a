"""Published peaks of the chips the benchmark runs on.

NVIDIA H100 SXM5 data sheet, dense rates without sparsity, at the full
700 W power limit; a run records the card's power limit beside them.
"""
from __future__ import annotations

H100 = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flops": 67e12,  # CUDA cores, outside the tensor cores
    "tf32_flops": 495e12,
    "bf16_flops": 989e12,
    "int8_ops": 1979e12,
}


def for_device(kind: str) -> dict | None:
    """The peak table of a device named ``kind`` (``torch.cuda.get_device_name``),
    or None: a run elsewhere (the CPU rehearsal) reports no share of a peak."""
    return H100 if "H100" in kind else None
