"""Counter-based standard normals: Philox-4x32-10 and Box-Muller.

A frozen copy of the generator the served factorizer draws its noise from.
Every sample is a pure function of (row key, row sweep index, factor, stream
tag, element index):

    key     = (a mod 2^32, b mod 2^32)              for a row key (a, b)
    counter = (element // 4, sweep << 12 | factor << 2 | tag, a >> 32, b >> 32)

Each 32-bit word lives in an int64 tensor, masked after every step; the
multipliers are split into 16-bit halves so no product overflows.  One call
gives four words, turned into normals by ``sqrt(-2 ln u1) * (cos, sin)(2 pi
u2)`` with ``u1 = (w + 1) / 2^32`` and ``u2 = w' / 2^32`` in float64, then
rounded to float32.
"""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
MULTIPLIERS = (0xD2511F53, 0xCD9E8D57)
KEY_STEPS = (0x9E3779B9, 0xBB67AE85)
ROUNDS = 10

SCORES, PROJECTION, RESTART = 0, 1, 2  # stream tags


def _mulhilo(m: int, x: torch.Tensor) -> tuple:
    a = x * (m >> 16)
    b = x * (m & 0xFFFF)
    s = a + (b >> 16)
    return s >> 16, ((s & 0xFFFF) << 16) | (b & 0xFFFF)


def philox4x32(counter: tuple, key: tuple) -> tuple:
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(ROUNDS):
        if r:
            k0 = (k0 + KEY_STEPS[0]) & MASK32
            k1 = (k1 + KEY_STEPS[1]) & MASK32
        hi0, lo0 = _mulhilo(MULTIPLIERS[0], c0)
        hi1, lo1 = _mulhilo(MULTIPLIERS[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def normal(keys: torch.Tensor, sweep: torch.Tensor, tag: int, factors: int,
           n: int) -> torch.Tensor:
    """Standard normals ``[N, factors, n]`` float32 for int64 row keys
    ``[N, 2]`` at each row's own sweep index ``[N]``."""
    dev = keys.device
    sweep = sweep.to(torch.int64).reshape(-1)
    a = keys[:, 0, None, None]
    b = keys[:, 1, None, None]
    f = torch.arange(factors, dtype=torch.int64, device=dev)[None, :, None]
    groups = torch.arange(-(-n // 4), dtype=torch.int64, device=dev)[None, None]
    tagged = (sweep[:, None, None] << 12) | (f << 2) | tag
    words = philox4x32((groups, tagged, a >> 32, b >> 32),
                       (a & MASK32, b & MASK32))
    w = torch.stack(words, dim=-1).reshape(keys.shape[0], factors, -1)
    w = w.to(torch.float64).reshape(keys.shape[0], factors, -1, 2)
    r = torch.sqrt(-2.0 * torch.log((w[..., 0] + 1.0) * 2.0 ** -32))
    theta = (2.0 * math.pi * 2.0 ** -32) * w[..., 1]
    z = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    return z.reshape(keys.shape[0], factors, -1)[..., :n].to(torch.float32)
