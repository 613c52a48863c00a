"""Counter-based random numbers for the stochastic resonator (paper Sec. IV-B).

The port's counterpart of the ``jax.random`` calls in the reference
factorizer.  A stateless generator: every sample is a pure function of

    (row key, row sweep index, factor, stream tag, element index),

so a row's noise does not depend on its slot, the batch it rides in, the
batch size, or on a resize, preemption or replay.  The reference threads
split keys through its loop instead; the two give different numbers, and
the port is compared with it statistically.

The integer stream is Philox-4x32-10 (Salmon et al., SC'11, the generator
of Random123 and of cuRAND), written in int64 tensor ops so that it runs
unchanged, and gives the same bits, on the CPU and on the card:

* every 32-bit word lives in an int64 tensor and is masked with
  ``& 0xFFFFFFFF`` after each step, so no value is ever negative and
  ``>>`` never meets torch's arithmetic shift of negative numbers;
* Philox's multipliers exceed 2^31, so a 32 x 32-bit product would
  overflow int64: :func:`_mulhilo` multiplies by the multiplier's two
  16-bit halves, each product below 2^48.

Counter and key of one Philox call, for a row key ``(a, b)`` (int64, each
below 2^62, as :func:`repro_torch.core.factorizer.draw_keys` draws them):

    key     = (a mod 2^32, b mod 2^32)
    counter = (element // 4, sweep << 12 | factor << 2 | tag, a >> 32, b >> 32)

One call gives four words, which Box-Muller turns into the normals of
elements ``4g .. 4g+3``: ``sqrt(-2 ln u1) * (cos, sin)(2 pi u2)`` with
``u1 = (w + 1) / 2^32`` in (0, 1] and ``u2 = w' / 2^32``, computed in
float64 and rounded to float32.  The 32-bit uniforms cut the tails at
6.66 standard deviations.
"""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)  # round multipliers
PHILOX_W = (0x9E3779B9, 0xBB67AE85)  # key schedule (golden ratio, sqrt 3)
ROUNDS = 10

# Stream tags: one per place the factorizer draws noise.
SCORES, PROJECTION, RESTART = 0, 1, 2
MAX_FACTORS = 1 << 10
MAX_SWEEP = 1 << 20


def _mulhilo(m: int, x: torch.Tensor) -> tuple:
    """``(hi, lo)`` 32-bit words of the 64-bit product ``m * x`` for a
    constant ``m < 2^32`` and int64 ``x`` in [0, 2^32), without overflow:
    ``m * x = a * 2^16 + b`` with ``a = x * (m >> 16)``, ``b = x * (m & 0xFFFF)``,
    both below 2^48."""
    a = x * (m >> 16)
    b = x * (m & 0xFFFF)
    s = a + (b >> 16)  # m * x >> 16, below 2^49
    return s >> 16, ((s & 0xFFFF) << 16) | (b & 0xFFFF)


def philox4x32(counter: tuple, key: tuple, rounds: int = ROUNDS) -> tuple:
    """Philox-4x32 on int64 tensors holding 32-bit words.

    ``counter`` is four tensors, ``key`` two, all broadcastable against each
    other, every value in [0, 2^32).  Returns the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(rounds):
        if r:
            k0 = (k0 + PHILOX_W[0]) & MASK32
            k1 = (k1 + PHILOX_W[1]) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bits(keys: torch.Tensor, sweep: torch.Tensor, tag: int, factors: int,
         n: int) -> torch.Tensor:
    """The raw words behind :func:`normal`: int64 ``[N, factors, 4 * ceil(n / 4)]``
    in [0, 2^32), word ``e`` of row ``i`` and factor ``f`` for element ``e``.

    ``keys`` is int64 ``[N, 2]`` (each entry in [0, 2^62)); ``sweep`` is
    ``[N]``, each row's own sweep index."""
    if not 0 <= tag < 4:
        raise ValueError(f"stream tag must be in [0, 4), got {tag}")
    if not 1 <= factors <= MAX_FACTORS:
        raise ValueError(f"factors must be in [1, {MAX_FACTORS}], got {factors}")
    _check_key_shape(keys)
    dev = keys.device
    sweep = torch.as_tensor(sweep, device=dev).to(torch.int64).reshape(-1)
    if sweep.shape[0] != keys.shape[0]:
        raise ValueError(f"sweep has {sweep.shape[0]} rows, keys {keys.shape[0]}")
    a = keys[:, 0, None, None]  # [N, 1, 1]
    b = keys[:, 1, None, None]
    f = torch.arange(factors, dtype=torch.int64, device=dev)[None, :, None]
    groups = torch.arange(-(-n // 4), dtype=torch.int64, device=dev)[None, None]
    tagged = (sweep[:, None, None] << 12) | (f << 2) | tag  # [N, F, 1]
    words = philox4x32((groups, tagged, a >> 32, b >> 32),
                       (a & MASK32, b & MASK32))
    return torch.stack(words, dim=-1).reshape(keys.shape[0], factors, -1)


def _check_key_shape(keys: torch.Tensor) -> None:
    if keys.dtype != torch.int64 or keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys must be int64 [N, 2], got {keys.dtype} "
                         f"{tuple(keys.shape)}")


def check_keys(keys: torch.Tensor) -> None:
    """Raise ``ValueError`` unless ``keys`` is int64 ``[N, 2]`` in [0, 2^62)
    (reads the values: one host sync for keys on the card)."""
    _check_key_shape(keys)
    if keys.numel() and (int(keys.min()) < 0 or int(keys.max()) >= 1 << 62):
        raise ValueError("row keys must lie in [0, 2^62)")


def normal(keys: torch.Tensor, sweep: torch.Tensor, tag: int, factors: int,
           n: int) -> torch.Tensor:
    """Standard normals, float32 ``[N, factors, n]``: element ``e`` of factor
    ``f`` of row ``i`` is a pure function of ``(keys[i], sweep[i], f, tag, e)``.

    The values of ``keys`` (see :func:`check_keys`) and of ``sweep`` (in
    [0, 2^20)) are the caller's to guarantee: reading them here would cost
    a host sync on every draw."""
    w = bits(keys, sweep, tag, factors, n).to(torch.float64)
    w = w.reshape(*w.shape[:-1], -1, 2)  # (u1, u2) pairs
    r = torch.sqrt(-2.0 * torch.log((w[..., 0] + 1.0) * 2.0 ** -32))
    theta = (2.0 * math.pi * 2.0 ** -32) * w[..., 1]
    z = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    return z.reshape(*z.shape[:-2], -1)[..., :n].to(torch.float32)
