"""Operations and bytes of the benchmarked work, from shapes alone.

Rooflines and ``mfu`` divide by these.  A count is what the algorithm needs
for its inputs, not what an implementation happens to move: every input
byte read once, every output byte written once.
"""
from __future__ import annotations


def similarity_int8(n: int, m: int, d: int) -> dict:
    """One launch of int8 codebook scores: q ``[n, d]`` fp32 against w
    ``[m, d]`` int8 with one fp32 scale a row, scores ``[n, m]`` fp32.  The
    products are fp32 on the CUDA cores (the kernel widens each int8 exactly
    and multiplies in fp32)."""
    return {"flops": 2 * n * m * d,
            "bytes": 4 * n * d + m * d + 4 * m + 4 * n * m,
            "peak": "fp32_flops"}


def roofline_seconds(count: dict, peaks: dict) -> float:
    """The least time a launch can take: its operations at the peak of the
    precision it computes in or its bytes at the memory rate, the longer."""
    return max(count["flops"] / peaks[count["peak"]],
               count["bytes"] / peaks["hbm_bytes_per_s"])


def row_sweep_flops(num_factors: int, codebook_size: int, dim: int) -> int:
    """Multiply-adds of one row's sweep that are matrix work: per factor the
    scores against M atoms and the projection back onto them, each 2 M D:
    4 F M D in all.  FFTs, noise and normalisation are not counted."""
    return 4 * num_factors * codebook_size * dim
