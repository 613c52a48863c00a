"""Inputs made from ``--seed``: codebooks, queries, keys and RAVEN tasks.

The same seed gives the same inputs.  Tensors are drawn on the run's device
with a ``torch.Generator`` there, in a few large calls; host-side draws
(task attributes, keys) use numpy.  Both the program and the reference are
handed what is made here.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def stream_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one named stream of a run's seed."""
    x = np.uint64(seed % 2 ** 64)
    for t in tags:
        x = _splitmix(np.array([x ^ np.uint64(t % 2 ** 64)], dtype=np.uint64))[0]
    return int(x >> np.uint64(1))


def _splitmix(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        z = x + _GOLDEN
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def row_keys(seed: int, start: int, n: int) -> np.ndarray:
    """Keys int64 ``[n, 2]`` in [0, 2^62) of rows ``start .. start + n - 1``
    of a run: a counter hash, so row r's key does not depend on how many
    rows were drawn before it."""
    base = np.uint64(stream_seed(seed, 0x6B657973))
    with np.errstate(over="ignore"):
        ctr = (np.arange(2 * start, 2 * (start + n), dtype=np.uint64)
               * _GOLDEN) ^ base
    return (_splitmix(ctr) >> np.uint64(2)).astype(np.int64).reshape(n, 2)


def device_generator(seed: int, tag: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, tag))
    return gen


def unitary_atoms(gen: torch.Generator, shape: tuple, dim: int, blocks: int,
                  device) -> torch.Tensor:
    """Real hypervectors ``shape + (dim,)`` float32 whose every block has a
    unit-magnitude spectrum (DC and Nyquist bins +-1), scaled by
    1 / sqrt(blocks)."""
    lanes = dim // blocks
    nfreq = lanes // 2 + 1
    lead = tuple(shape) + (blocks,)
    theta = torch.rand(lead + (nfreq,), generator=gen, dtype=torch.float64,
                       device=device) * (2 * math.pi)
    spec = torch.polar(torch.ones_like(theta), theta)
    signs = torch.randint(0, 2, (2,) + lead, generator=gen,
                          device=device) * 2.0 - 1.0
    spec[..., 0] = signs[0].to(spec.dtype)
    if lanes % 2 == 0:
        spec[..., nfreq - 1] = signs[1].to(spec.dtype)
    x = torch.fft.irfft(spec, n=lanes, dim=-1) / math.sqrt(blocks)
    return x.reshape(*shape, dim).to(torch.float32)


def bind_indices(atoms: torch.Tensor, idx: torch.Tensor,
                 blocks: int) -> torch.Tensor:
    """The product vector of one atom per factor: atoms ``[F, M, D]``,
    ``idx [..., F]`` -> ``[..., D]`` (block-wise circular convolution)."""
    F, _, D = atoms.shape
    picked = atoms[torch.arange(F, device=atoms.device), idx.long()]
    lanes = D // blocks
    spec = torch.fft.rfft(picked.reshape(*picked.shape[:-1], blocks, lanes),
                          dim=-1)
    out = torch.fft.irfft(torch.prod(spec, dim=-3), n=lanes, dim=-1)
    return out.reshape(*idx.shape[:-1], D)


# RAVEN attribute-level tasks ("center" constellation; type 5, size 6,
# colour 10), the generator of Zhang et al. (CVPR 2019) as I-RAVEN draws
# its candidates: the answer plus 7 distractors that perturb 1-2 attributes.
ATTRS = ("type", "size", "color")
ATTR_SIZES = {"type": 5, "size": 6, "color": 10}
RULES = ("constant", "progression_p1", "progression_m1", "arithmetic_plus",
         "arithmetic_minus", "distribute_three")


def _row(rule: str, first: int, n: int, rng) -> np.ndarray:
    a = np.array([first, 0, 0], dtype=np.int64)
    if rule == "constant":
        a[1] = a[2] = a[0]
    elif rule == "progression_p1":
        a[1], a[2] = (a[0] + 1) % n, (a[0] + 2) % n
    elif rule == "progression_m1":
        a[1], a[2] = (a[0] - 1) % n, (a[0] - 2) % n
    elif rule == "arithmetic_plus":
        a[1] = rng.integers(0, n)
        a[2] = (a[0] + a[1]) % n
    elif rule == "arithmetic_minus":
        a[1] = rng.integers(0, n)
        a[2] = (a[0] - a[1]) % n
    else:
        raise ValueError(rule)
    return a


def _grid(rule: str, n: int, rng) -> np.ndarray:
    g = np.zeros((3, 3), dtype=np.int32)
    if rule == "distribute_three":
        vals = rng.choice(n, size=3, replace=False)
        for r in range(3):
            g[r] = np.roll(vals, r)
        return g
    for r in range(3):
        g[r] = _row(rule, rng.integers(0, n), n, rng)
    return g


def raven_task(rng) -> tuple:
    """One task: (context attributes ``[8, 3]``, candidate attributes
    ``[8, 3]``, answer index)."""
    rules = {a: RULES[rng.integers(0, len(RULES))] for a in ATTRS}
    grid = {a: _grid(rules[a], ATTR_SIZES[a], rng) for a in ATTRS}
    truth = {a: grid[a][2, 2] for a in ATTRS}
    cand = np.zeros((8, 3), dtype=np.int64)
    answer = int(rng.integers(0, 8))
    seen = {tuple(truth[a] for a in ATTRS)}
    for c in range(8):
        attrs = dict(truth)
        if c != answer:
            while True:
                attrs = dict(truth)
                for a in rng.choice(ATTRS, size=rng.integers(1, 3),
                                    replace=False):
                    attrs[a] = (attrs[a] + rng.integers(1, ATTR_SIZES[a])) \
                        % ATTR_SIZES[a]
                if tuple(attrs[a] for a in ATTRS) not in seen:
                    seen.add(tuple(attrs[a] for a in ATTRS))
                    break
        cand[c] = [attrs[a] for a in ATTRS]
    ctx = np.stack([grid[a].reshape(9)[:8] for a in ATTRS], -1)
    return ctx.astype(np.int64), cand, answer


def raven_tasks(seed: int, n: int) -> tuple:
    """``n`` tasks of a run: context ``[n, 8, 3]``, candidates ``[n, 8, 3]``,
    answers ``[n]``."""
    out = [raven_task(np.random.default_rng([stream_seed(seed, 0x72617665), t]))
           for t in range(n)]
    return tuple(np.stack(col) for col in zip(*out))
