"""Vector-Symbolic Architecture (VSA) algebra with block-code binding.

The port of ``repro/core/vsa.py``.  A D-dimensional hypervector is viewed as
``B`` blocks of ``L`` lanes (D = B*L) and binding convolves each block
circularly.  Two familiar algebras are corner cases:

  * ``L == 1``  -> MAP / Hadamard binding (element-wise multiply),
  * ``B == 1``  -> HRR (full circular convolution over all D lanes).

Vectors are stored *flat* ``[..., D]``; the :class:`VSAConfig` carries the
block structure.  Binding runs through ``torch.fft`` (``impl='fft'``, the
default), the O(D*L) circulant contraction (``impl='direct'``, the oracle)
or the block circular convolution kernels (``impl='pallas'``, the
reference's name: the hand-written CUDA kernels of ``kernels/circconv`` on
the card, their plain versions on the CPU).

Random hypervectors are drawn from a CPU ``torch.Generator`` (or an int
seed) and then moved to ``device``, so one seed gives the same atoms on
every device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

import torch

from repro_torch.device import DEFAULT_DEVICE, generator as as_generator, resolve
from repro_torch.kernels.circconv import ops as cc_ops
from repro_torch.kernels.circconv import ref as cc_ref

Impl = Literal["fft", "direct", "pallas"]


@dataclasses.dataclass(frozen=True)
class VSAConfig:
    """Block-code VSA configuration.

    Attributes:
      dim:    total hypervector dimensionality D.
      blocks: number of independent circular-convolution blocks B.
      impl:   default binding implementation.
    """

    dim: int = 1024
    blocks: int = 1
    impl: Impl = "fft"

    def __post_init__(self):
        if self.dim % self.blocks != 0:
            raise ValueError(f"dim={self.dim} not divisible by blocks={self.blocks}")

    @property
    def lanes(self) -> int:
        """Block length L."""
        return self.dim // self.blocks

    def blockify(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(*x.shape[:-1], self.blocks, self.lanes)

    def flatten(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(*x.shape[:-2], self.dim)


# ---------------------------------------------------------------------------
# Random hypervectors
# ---------------------------------------------------------------------------

def random_bipolar(generator, shape, cfg: VSAConfig,
                   dtype=torch.float32, device=DEFAULT_DEVICE) -> torch.Tensor:
    """Dense bipolar (+-1) hypervectors (MAP algebra; NVSA-style codebooks).

    With ``cfg.blocks == cfg.dim`` (L=1) binding degenerates to the Hadamard
    product and these are self-inverse: unbind == bind.
    """
    dev = resolve(device)
    full = tuple(shape) + (cfg.dim,)
    bits = torch.randint(0, 2, full, generator=as_generator(generator))
    return torch.where(bits == 1, 1.0, -1.0).to(dtype=dtype, device=dev)


def random_unitary(generator, shape, cfg: VSAConfig,
                   dtype=torch.float32, device=DEFAULT_DEVICE) -> torch.Tensor:
    """Real hypervectors whose per-block DFT has unit magnitude everywhere.

    For such vectors binding with the involution is an exact unbind and the
    full vector has L2 norm 1 (each block norm 1, scaled by 1/sqrt(B)).
    """
    dev = resolve(device)
    generator = as_generator(generator)
    L = cfg.lanes
    lead = tuple(shape) + (cfg.blocks,)
    nfreq = L // 2 + 1
    theta = torch.rand(lead + (nfreq,), generator=generator,
                       dtype=torch.float64) * (2 * math.pi)
    spec = torch.polar(torch.ones_like(theta), theta)
    # DC (and Nyquist when L is even) bins of a real signal must be real: +/-1.
    sgn0 = torch.randint(0, 2, lead, generator=generator) * 2.0 - 1.0
    spec[..., 0] = sgn0.to(spec.dtype)
    if L % 2 == 0:
        sgnN = torch.randint(0, 2, lead, generator=generator) * 2.0 - 1.0
        spec[..., nfreq - 1] = sgnN.to(spec.dtype)
    x = torch.fft.irfft(spec, n=L, dim=-1) / math.sqrt(cfg.blocks)
    return cfg.flatten(x).to(dtype=dtype, device=dev)


# ---------------------------------------------------------------------------
# Core algebra
# ---------------------------------------------------------------------------

def _bind_fft(xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    fx = torch.fft.rfft(xb.float(), dim=-1)
    fy = torch.fft.rfft(yb.float(), dim=-1)
    return torch.fft.irfft(fx * fy, n=xb.shape[-1], dim=-1)


def _bind_direct(xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    """Reference O(L^2) circulant contraction: c[n] = sum_k x[k] y[(n-k) mod L]."""
    L = xb.shape[-1]
    n = torch.arange(L, device=xb.device)
    idx = (n[:, None] - n[None, :]) % L  # [n, k] -> (n - k) mod L
    Yc = yb[..., idx]  # [..., L(n), L(k)]
    return torch.einsum("...k,...nk->...n", xb.float(), Yc.float())


def bind(x: torch.Tensor, y: torch.Tensor, cfg: VSAConfig,
         impl: Impl | None = None) -> torch.Tensor:
    """Block-wise circular convolution binding. Shapes broadcast over leading dims."""
    impl = impl or cfg.impl
    xb, yb = cfg.blockify(x), cfg.blockify(y)
    if impl == "fft":
        out = _bind_fft(xb, yb)
    elif impl == "direct":
        out = _bind_direct(xb, yb)
    elif impl == "pallas":
        out = cc_ops.block_circconv(xb, yb)
    else:
        raise ValueError(f"unknown impl {impl!r}")
    return cfg.flatten(out).to(x.dtype)


def involution(x: torch.Tensor, cfg: VSAConfig) -> torch.Tensor:
    """Per-block index reversal y[n] = x[(-n) mod L]; FFT(inv(x)) = conj(FFT(x))."""
    return cfg.flatten(cc_ref.involute(cfg.blockify(x)))


def unbind(q: torch.Tensor, y: torch.Tensor, cfg: VSAConfig,
           impl: Impl | None = None) -> torch.Tensor:
    """Circular correlation: recovers x from q = bind(x, y) (exact for unitary y)."""
    impl = impl or cfg.impl
    if impl == "pallas":
        out = cc_ops.block_circcorr(cfg.blockify(q), cfg.blockify(y))
        return cfg.flatten(out).to(q.dtype)
    return bind(q, involution(y, cfg), cfg, impl=impl)


def bind_all(xs: torch.Tensor, cfg: VSAConfig, axis: int = 0) -> torch.Tensor:
    """Bind along ``axis``: bind(xs[0], bind(xs[1], ...)). Done in Fourier domain.

    ``axis`` indexes into the *flat* [..., D] layout (e.g. ``axis=-2`` binds a
    batch of atom stacks [..., F, D] -> [..., D] in one shot).
    """
    if cfg.lanes == 1:  # MAP corner: binding is the Hadamard product
        return torch.prod(xs, dim=axis)
    xb = cfg.blockify(xs).float()
    ax = axis if axis >= 0 else axis - 1  # blockify appends one trailing dim
    spec = torch.prod(torch.fft.rfft(xb, dim=-1), dim=ax)
    return cfg.flatten(torch.fft.irfft(spec, n=cfg.lanes, dim=-1))


def _norm2(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """L2 norm as the reference spells it: sqrt of the sum of squares."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim))


def bundle(xs: torch.Tensor, axis: int = 0, normalize: bool = True) -> torch.Tensor:
    """Superposition (elementwise sum), optionally L2-normalised."""
    s = torch.sum(xs, dim=axis)
    if normalize:
        s = s / (_norm2(s, keepdim=True) + 1e-9)
    return s


def similarity(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Cosine similarity over the last axis (broadcasts leading dims)."""
    num = torch.sum(x * y, dim=-1)
    den = _norm2(x) * _norm2(y) + 1e-9
    return num / den


def codebook_similarity(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Similarity of x [..., D] against a codebook [M, D] -> [..., M]."""
    xn = x / (_norm2(x, keepdim=True) + 1e-9)
    cn = codebook / (_norm2(codebook, keepdim=True) + 1e-9)
    return xn @ cn.T


def normalize_sign(x: torch.Tensor) -> torch.Tensor:
    """Bipolar saturation sign(x) with sign(0) := +1 (resonator nonlinearity)."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def normalize_unitary(x: torch.Tensor, cfg: VSAConfig) -> torch.Tensor:
    """Project each block's spectrum back onto unit magnitude (phasor projection)."""
    xb = cfg.blockify(x).float()
    spec = torch.fft.rfft(xb, dim=-1)
    spec = spec / (torch.abs(spec) + 1e-9)
    out = torch.fft.irfft(spec, n=cfg.lanes, dim=-1)
    out = out / math.sqrt(cfg.blocks)
    return cfg.flatten(out).to(x.dtype)
