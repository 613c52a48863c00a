"""Mamba (S6 selective SSM) block of the jamba hybrid architecture.

The port of ``repro/nn/mamba.py``.  The full-sequence path runs a chunked
scan: a loop over sequence chunks carries the [B, d_inner, N] state, and
inside a chunk the recurrence h_t = a_t * h_{t-1} + b_t is an associative
scan in ``jax.lax.associative_scan``'s own order (odd/even recursion), so
the products are the reference's up to the state read-out's fp32 sum over
N.  Decode is the O(1) recurrent update.  Elementwise steps run in the
working type one op at a time, as the reference's do (``softplus`` as
``logaddexp(x, 0)``, ``silu`` as in :mod:`repro_torch.nn.layers`);
``A_log`` is read in fp32, as the reference reads it.  Under autograd
each chunk of the full sequence runs under a checkpoint, as the
reference's chunk body does.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.nn import layers as L
from repro_torch.nn.common import rows_local, shard


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    expand: int = 2
    d_state: int = 16  # N
    d_conv: int = 4
    dt_rank: int | None = None  # defaults to max(1, d_model // 16)
    chunk: int = 64  # sequence chunk of the outer loop

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def rank(self) -> int:
        return self.dt_rank or max(1, self.d_model // 16)


def init_mamba(draw, cfg: MambaConfig) -> dict:
    """The reference's leaves and scales; ``draw(shape, scale)`` makes a
    normal leaf, ``draw(shape, None, fill=...)`` a constant or computed one
    (see :mod:`repro_torch.nn.transformer`)."""
    di, N, R = cfg.d_inner, cfg.d_state, cfg.rank
    lo, hi = math.log(1e-3), math.log(1e-1)

    def dt_bias(u):  # softplus^-1 of dt = exp(uniform(log 1e-3, log 1e-1))
        return torch.log(torch.expm1(torch.exp(lo + (hi - lo) * u)))

    def a_log(t):
        return torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                      device=t.device).expand(di, N))

    return {
        "in_proj": draw((cfg.d_model, 2 * di), (1.0 / cfg.d_model) ** 0.5),
        "conv_w": draw((cfg.d_conv, di), (1.0 / cfg.d_conv) ** 0.5),
        "conv_b": draw((di,), None, fill=0.0),
        "x_proj": draw((di, R + 2 * N), (1.0 / di) ** 0.5),
        "dt_proj_w": draw((R, di), (1.0 / R) ** 0.5),
        "dt_proj_b": draw((di,), None, fill=dt_bias, uniform=True),
        "A_log": draw((di, N), None, fill=a_log),
        "D": draw((di,), None, fill=1.0),
        "out_proj": draw((di, cfg.d_model), (1.0 / di) ** 0.5),
    }


def mamba_logical() -> dict:
    """The reference's logical axes of :func:`init_mamba`'s leaves."""
    return {
        "in_proj": ("embed", "mlp"), "conv_w": ("conv", "mlp"),
        "conv_b": ("mlp",), "x_proj": ("mlp", "state"),
        "dt_proj_w": ("state", "mlp"), "dt_proj_b": ("mlp",),
        "A_log": ("mlp", "state"), "D": ("mlp",), "out_proj": ("mlp", "embed"),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = ``logaddexp(x, 0)``, each step in x's dtype."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


# The leaves the scan's inputs read.  Under a mesh the scan runs on each
# rank's rows with these gathered (``rows_local``): DTensor's propagation
# through the scan's inputs asks for redistributions it does not support
# (torch 2.11: Shard to Partial).
_SSM = ("x_proj", "dt_proj_w", "dt_proj_b", "A_log")


def _ssm_inputs(p, x: torch.Tensor, cfg: MambaConfig) -> tuple:
    """Projections and the scan's elements: dA, dBx [B, S, di, N] fp32 and
    C [B, S, N]."""
    R, N = cfg.rank, cfg.d_state
    dt_bc = x @ p["x_proj"].to(x.dtype)  # [B, S, R + 2N]
    dt, Bm, Cm = torch.split(dt_bc, [R, N, N], dim=-1)
    dt = softplus(dt @ p["dt_proj_w"].to(x.dtype)
                  + p["dt_proj_b"].to(x.dtype))  # [B, S, di]
    A = -torch.exp(p["A_log"].float())  # [di, N]
    dA = torch.exp(dt.float()[..., None] * A)
    dBx = (dt * x).float()[..., None] * Bm.float()[..., None, :]
    return dA, dBx, Cm


def _combine(e1, e2):
    (a1, b1), (a2, b2) = e1, e2
    return a2 * a1, a2 * b1 + b2


def associative_scan(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """Inclusive scan of (a, b) pairs along axis 1 under
    (a1, b1) . (a2, b2) = (a2 a1, a2 b1 + b2), in the order of
    ``jax.lax.associative_scan``: pairs reduced, the odd positions scanned
    recursively, the even ones filled in from them."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2]))
    oa, ob = associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea, eb = torch.cat([a[:, :1], ea], 1), torch.cat([b[:, :1], eb], 1)
    out = []
    for e, o in ((ea, oa), (eb, ob)):  # interleave even and odd positions
        t = torch.empty((e.shape[0], n) + tuple(e.shape[2:]), dtype=e.dtype,
                        device=e.device)
        t[:, 0::2], t[:, 1::2] = e, o
        out.append(t)
    return tuple(out)


def _chunk_scan(carry_h: torch.Tensor, dA, dBx, Cm) -> tuple:
    """One chunk: the scan inside, the carried state injected."""
    a_cum, b_cum = associative_scan(dA, dBx)
    h = a_cum * carry_h[:, None] + b_cum  # [B, c, di, N]
    y = torch.einsum("bcdn,bcn->bcd", h, Cm.float())
    return h[:, -1], y


def mamba(p, x: torch.Tensor, cfg: MambaConfig, state: dict | None = None
          ) -> tuple:
    """x: [B, S, d_model] -> (y, new_state).

    state (decode, S == 1): {'conv': [B, d_conv - 1, di], 'ssm': [B, di, N]
    fp32}, not written; None for the full sequence, whose returned state
    carries ``ssm: None`` as the reference's does (a prefill hands no SSM
    state on)."""
    B, S, _ = x.shape
    di, N = cfg.d_inner, cfg.d_state
    xz = x @ p["in_proj"].to(x.dtype)
    xin, z = torch.chunk(xz, 2, dim=-1)  # [B, S, di]
    xin = shard(xin, "batch", "seq", "mlp")
    if state is None:
        pad = torch.zeros((B, cfg.d_conv - 1, di), dtype=xin.dtype,
                          device=x.device)
        xc = torch.cat([pad, xin], 1)
        conv = sum(xc[:, i:i + S] * p["conv_w"][i].to(x.dtype)
                   for i in range(cfg.d_conv)) + p["conv_b"].to(x.dtype)
        u = L._silu(conv)  # [B, S, di]
        pad_s = (-S) % cfg.chunk
        if pad_s:
            u = torch.nn.functional.pad(u, (0, 0, 0, pad_s))
        h = torch.zeros((B, di, N), dtype=torch.float32, device=x.device)

        def local_chunk(h, u_chunk, *ws):
            return _chunk_scan(h, *_ssm_inputs(dict(zip(_SSM, ws)), u_chunk,
                                               cfg))

        def chunk_body(h, u_chunk):
            # the chunk on each rank's rows under a mesh, its weights
            # gathered (_SSM)
            return rows_local(local_chunk, (h, u_chunk),
                              shared=tuple(p[n] for n in _SSM), n_out=2)

        # under autograd each chunk is checkpointed, as the reference's
        # scan body is: its [B, chunk, di, N] elements are rebuilt in the
        # backward pass, not kept for every chunk
        remat = L.recording(u, p)
        ys = []
        for c0 in range(0, u.shape[1], cfg.chunk):
            args = (h, u[:, c0:c0 + cfg.chunk])
            h, y_c = (checkpoint(chunk_body, *args, use_reentrant=False)
                      if remat else chunk_body(*args))
            ys.append(y_c)
        y = torch.cat(ys, 1)[:, :S]
        y = y.to(x.dtype) + u[:, :S] * p["D"].to(x.dtype)
        new_state = {"conv": xin[:, -(cfg.d_conv - 1):, :], "ssm": None}
    else:
        if S != 1:
            raise ValueError(f"a Mamba decode step takes one token, got {S}")
        conv_buf = torch.cat([state["conv"], xin], 1)  # [B, d_conv, di]
        conv = sum(conv_buf[:, i] * p["conv_w"][i].to(x.dtype)
                   for i in range(cfg.d_conv)) + p["conv_b"].to(x.dtype)
        u = L._silu(conv)[:, None, :]  # [B, 1, di]

        def local_step(u, ssm, *ws):
            dA, dBx, Cm = _ssm_inputs(dict(zip(_SSM, ws)), u, cfg)
            h = dA[:, 0] * ssm + dBx[:, 0]  # [B, di, N]
            y = torch.einsum("bdn,bn->bd", h, Cm[:, 0].float())[:, None]
            return y, h

        y, h = rows_local(local_step, (u, state["ssm"]),
                          shared=tuple(p[n] for n in _SSM), n_out=2)
        y = y.to(x.dtype) + u * p["D"].to(x.dtype)
        new_state = {"conv": conv_buf[:, 1:], "ssm": h}
    out = (y * L._silu(z)) @ p["out_proj"].to(x.dtype)
    return shard(out, "batch", "seq", "embed_act"), new_state


def init_mamba_state(batch: int, cfg: MambaConfig, dtype=torch.bfloat16,
                     device=None) -> dict:
    return {"conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, cfg.d_inner, cfg.d_state),
                               dtype=torch.float32, device=device)}
