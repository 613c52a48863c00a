"""Per-request sampling specs for LM serving.

The port of ``repro/lm/sampling.py``.  :class:`SamplingSpec` is what
``LMEngine.submit(..., sampling=...)`` and ``ServeEngine.add_request``
accept: temperature / top-k with a per-request seed.  The random numbers
behind each emitted token are a pure function of ``(seed, absolute
position)`` — not of wall-clock or engine state — so a replayed request
(fault recovery, resize re-queue) regenerates bit-equal tokens, the same
warm-handoff contract greedy decode gets for free.

The reference keys ``jax.random.categorical`` with ``fold_in(PRNGKey(seed),
position)``; the port cannot reproduce those bits.  It draws Gumbel noise
from the port's counter-based Philox-4x32-10 (:mod:`repro_torch.core.rng`,
the same words on the CPU and on the card) and takes
``argmax(logits / T + gumbel)``, an exact draw from ``softmax(logits / T)``
— so it is held against the reference statistically, not bit for bit.

Validation lives in ``__post_init__``: ``temperature=0`` (zero temperature
IS greedy, ask for that) and ``top_k < 1`` die at construction.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import rng

# Philox counter word 3: which stream a draw belongs to.
POSITION_STREAM, ROW_STREAM = 0x5A4D, 0x524F


@dataclasses.dataclass(frozen=True)
class SamplingSpec:
    temperature: float = 1.0
    top_k: int | None = None
    seed: int = 0

    def __post_init__(self):
        if not self.temperature > 0:
            raise ValueError(
                f"temperature must be > 0, got {self.temperature} — "
                "temperature=0 is greedy argmax; pass sampling=None (the "
                "greedy default) instead of dividing logits by zero")
        if self.top_k is not None and self.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")


def gumbel(seed: int, index: torch.Tensor, stream: int,
           n: int) -> torch.Tensor:
    """Standard Gumbel noise, float64 ``[len(index), n]`` on ``index``'s
    device: entry ``(i, v)`` is a pure function of ``(seed, index[i],
    stream, v)`` (Philox key: the seed's two 32-bit halves; counter: ``(v //
    4, index low word, index high word, stream)``)."""
    idx = index.to(torch.int64).reshape(-1, 1)
    groups = torch.arange(-(-n // 4), dtype=torch.int64,
                          device=idx.device)[None]
    seed = int(seed)
    key = (torch.tensor(seed & rng.MASK32, device=idx.device),
           torch.tensor((seed >> 32) & rng.MASK32, device=idx.device))
    words = rng.philox4x32((groups, idx & rng.MASK32,
                            (idx >> 32) & rng.MASK32,
                            torch.full_like(idx, stream)), key)
    w = torch.stack(words, dim=-1).reshape(idx.shape[0], -1)[:, :n]
    u = (w.to(torch.float64) + 0.5) * 2.0 ** -32  # in (0, 1)
    return -torch.log(-torch.log(u))


def _top_k(lg: torch.Tensor, k: int | None) -> torch.Tensor:
    if k is None or k >= lg.shape[-1]:
        return lg
    kth = torch.topk(lg, k, dim=-1).values[..., -1:]
    return torch.where(lg >= kth, lg, torch.full((), -torch.inf,
                                                 dtype=lg.dtype,
                                                 device=lg.device))


def sample_token(logits: torch.Tensor, spec: SamplingSpec,
                 position: int) -> int:
    """Sample one token id from [V] logits at an absolute sequence position.
    Deterministic in ``(spec.seed, position)`` — see the module doc."""
    lg = _top_k(logits.float(), spec.top_k) / spec.temperature
    pos = torch.tensor([position], device=lg.device)
    g = gumbel(spec.seed, pos, POSITION_STREAM, lg.shape[-1])[0]
    return int(torch.argmax(lg.double() + g))


def categorical(logits: torch.Tensor, seed: int,
                temperature: float = 1.0) -> torch.Tensor:
    """One draw per row of [B, V] logits from ``softmax(logits / T)``; row
    ``b`` uses the noise of ``(seed, b)``.  Returns [B] int64."""
    lg = logits.float() / temperature
    rows = torch.arange(lg.shape[0], device=lg.device)
    return torch.argmax(lg.double() + gumbel(seed, rows, ROW_STREAM,
                                             lg.shape[-1]), dim=-1)
