"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM.

The port of ``repro/nn/xlstm.py``.  xlstm-125m alternates the two block
types.  Both are recurrences with O(1) decode state: the full sequence runs
the exact recurrent form one token at a time.  Under autograd the steps
run in checkpointed chunks of ``chunk`` tokens, as the reference's
``_chunked_scan`` does (:func:`_chunked_steps`); the numbers are the plain
loop's either way.

mLSTM state per head: matrix memory C [dh, dh], normaliser n [dh], gate
stabiliser m [].  sLSTM state per model dim: c, n, m, h.  Exponential
gating with the max-stabiliser; ``m`` starts at -1e9, so a fresh state is
not zeros.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.nn import layers as L
from repro_torch.nn.common import merge_heads, rows_local, shard, split_heads


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    d_model: int
    n_heads: int = 4
    expand: int = 2  # mLSTM up-projection factor
    chunk: int = 64  # BPTT chunk: residuals saved once per chunk, not per step

    @property
    def d_inner(self) -> int:
        return self.d_model * self.expand

    @property
    def dh(self) -> int:
        return self.d_inner // self.n_heads


def _chunked_steps(step, carry: tuple, S: int, chunk: int,
                   remat: bool) -> tuple:
    """``carry, h = step(carry, t)`` for t in 0..S-1 -> (carry, the h's
    stacked on axis 1).  With ``remat`` (autograd recording), S a multiple
    of ``chunk`` and longer than one chunk, each chunk of steps runs under a
    checkpoint, so the backward pass keeps one carry a chunk rather than
    every step's residuals: the reference's ``_chunked_scan``, with its
    plain-loop fallback."""
    def run(carry, t0: int, t1: int):
        hs = []
        for t in range(t0, t1):
            carry, h = step(carry, t)
            hs.append(h)
        return carry, torch.stack(hs, 1)

    if not remat or chunk <= 1 or S % chunk or S <= chunk:
        return run(carry, 0, S)
    outs = []
    for t0 in range(0, S, chunk):
        carry, h = checkpoint(run, carry, t0, t0 + chunk, use_reentrant=False)
        outs.append(h)
    return carry, torch.cat(outs, 1)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(draw, cfg: XLSTMConfig) -> dict:
    d, di, H = cfg.d_model, cfg.d_inner, cfg.n_heads
    s_in, s_i = (1.0 / d) ** 0.5, (1.0 / di) ** 0.5
    return {
        "up": draw((d, 2 * di), s_in),  # x branch + gate branch
        "q": draw((di, di), s_i), "k": draw((di, di), s_i),
        "v": draw((di, di), s_i),
        "i_gate": draw((di, H), s_i), "i_bias": draw((H,), None, fill=0.0),
        "f_gate": draw((di, H), s_i), "f_bias": draw((H,), None, fill=3.0),
        "o_gate": draw((di, di), s_i), "down": draw((di, d), s_i),
    }


def mlstm_logical() -> dict:
    """The reference's logical axes of :func:`init_mlstm`'s leaves."""
    return {"up": ("embed", "mlp"), "q": ("mlp", "mlp"), "k": ("mlp", "mlp"),
            "v": ("mlp", "mlp"), "i_gate": ("mlp", "heads"),
            "i_bias": ("heads",), "f_gate": ("mlp", "heads"),
            "f_bias": ("heads",), "o_gate": ("mlp", "mlp"),
            "down": ("mlp", "embed")}


def _mlstm_step(C, n, m, q, k, v, i_pre, f_pre, o) -> tuple:
    """One token for all heads. C: [B, H, dh, dh]; n: [B, H, dh]; m: [B, H];
    q/k/v/o: [B, H, dh]; i_pre/f_pre: [B, H]."""
    m_new = torch.maximum(f_pre + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(f_pre + m - m_new)
    C = f_g[..., None, None] * C + i_g[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = f_g[..., None] * n + i_g[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.abs(torch.einsum("bhd,bhd->bh", q, n))
    h = num / torch.clamp(den, min=1.0)[..., None]
    return C, n, m_new, h * torch.sigmoid(o)


def mlstm(p, x: torch.Tensor, cfg: XLSTMConfig, state=None) -> tuple:
    """x: [B, S, d] -> (y, state); ``state`` (None = fresh) is not written."""
    B, S, _ = x.shape
    H, dh = cfg.n_heads, cfg.dh
    up = x @ p["up"].to(x.dtype)
    xi, z = torch.chunk(up, 2, dim=-1)  # [B, S, di]
    xi = shard(xi, "batch", "seq", "mlp")

    def heads(w, scale=None):
        t = split_heads(xi @ p[w].to(x.dtype), H, dh).float()
        return t if scale is None else t * scale

    q, k = heads("q", dh ** -0.5), heads("k", dh ** -0.5)
    v, o = heads("v"), heads("o_gate")
    # the gate projections constrained to their heads before the bias is
    # added (a no-op without a mesh): under a mesh the product is a
    # partial sum over the inner dim's split, and torch 2.11's DTensor
    # would turn the heads-split bias into a partial sum to add it
    i_pre = (shard(xi @ p["i_gate"].to(x.dtype), "batch", "seq", "heads")
             + p["i_bias"].to(x.dtype)).float()
    f_pre = (shard(xi @ p["f_gate"].to(x.dtype), "batch", "seq", "heads")
             + p["f_bias"].to(x.dtype)).float()
    if state is None:
        state = init_mlstm_state(B, cfg, x.device)

    remat = L.recording(x, p)

    def steps(C, n, m, q, k, v, i_pre, f_pre, o):
        def step(carry, t):
            C, n, m, h = _mlstm_step(*carry, q[:, t], k[:, t], v[:, t],
                                     i_pre[:, t], f_pre[:, t], o[:, t])
            return (C, n, m), h

        (C, n, m), h = _chunked_steps(step, (C, n, m), S, cfg.chunk, remat)
        return C, n, m, h

    # the recurrence on each rank's rows under a mesh
    C, n, m, h = rows_local(steps, (state["C"], state["n"], state["m"], q, k,
                                    v, i_pre, f_pre, o), n_out=4)
    h = merge_heads(h).to(x.dtype)  # [B, S, di]
    y = (h * L._silu(z)) @ p["down"].to(x.dtype)
    return shard(y, "batch", "seq", "embed_act"), {"C": C, "n": n, "m": m}


def init_mlstm_state(batch: int, cfg: XLSTMConfig, device=None) -> dict:
    H, dh = cfg.n_heads, cfg.dh
    f32 = torch.float32
    return {"C": torch.zeros((batch, H, dh, dh), dtype=f32, device=device),
            "n": torch.zeros((batch, H, dh), dtype=f32, device=device),
            "m": torch.full((batch, H), -1e9, dtype=f32, device=device)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(draw, cfg: XLSTMConfig) -> dict:
    d = cfg.d_model
    s = (1.0 / d) ** 0.5

    def bias(t):  # z, i, f, o pre-activation biases: f starts at 3
        out = torch.zeros((4 * d,), dtype=torch.float32, device=t.device)
        out[2 * d:3 * d] = 3.0
        return out

    return {"zi": draw((d, 4 * d), s),  # z, i, f, o pre-activations
            "ri": draw((d, 4 * d), s),  # recurrent
            "bias": draw((4 * d,), None, fill=bias),
            "up": draw((d, 2 * d), s),
            "down": draw((2 * d, d), (1.0 / (2 * d)) ** 0.5)}


def slstm_logical() -> dict:
    """The reference's logical axes of :func:`init_slstm`'s leaves."""
    return {"zi": ("embed", "mlp"), "ri": ("embed", "mlp"), "bias": ("mlp",),
            "up": ("embed", "mlp"), "down": ("mlp", "embed")}


def _slstm_step(p, c, n, m, h, x_t) -> tuple:
    """One token. c, n, m: [B, d] fp32; h, x_t: [B, d] (x_t [B, 4d]) in
    the working type."""
    pre = x_t + h @ p["ri"].to(x_t.dtype) + p["bias"].to(x_t.dtype)
    z, i_pre, f_pre, o = torch.chunk(pre.float(), 4, dim=-1)
    m_new = torch.maximum(f_pre + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(f_pre + m - m_new)
    c = f_g * c + i_g * torch.tanh(z)
    n = f_g * n + i_g
    h_new = torch.sigmoid(o) * c / torch.clamp(n, min=1.0)
    return c, n, m_new, h_new.to(x_t.dtype)


def slstm(p, x: torch.Tensor, cfg: XLSTMConfig, state=None) -> tuple:
    """x: [B, S, d] -> (y, state); ``state`` (None = fresh) is not written."""
    B, S, d = x.shape
    xz = x @ p["zi"].to(x.dtype)  # [B, S, 4d]
    if state is None:
        state = init_slstm_state(B, cfg, x.device)

    remat = L.recording(x, p)

    def steps(c, n, m, h, xz, ri, bias):
        pr = {"ri": ri, "bias": bias}

        def step(carry, t):
            carry = _slstm_step(pr, *carry, xz[:, t])
            return carry, carry[3]

        (c, n, m, h), hseq = _chunked_steps(step, (c, n, m, h), S, cfg.chunk,
                                            remat)
        return c, n, m, h, hseq  # hseq [B, S, d]

    # the recurrence on each rank's rows under a mesh
    c, n, m, h, hseq = rows_local(
        steps, (state["c"], state["n"], state["m"], state["h"].to(x.dtype),
                xz), shared=(p["ri"], p["bias"]), n_out=5)
    a, b = torch.chunk(hseq @ p["up"].to(x.dtype), 2, dim=-1)
    y = torch.cat([L._gelu(a), b], -1) @ p["down"].to(x.dtype)
    return shard(y, "batch", "seq", "embed_act"), {"c": c, "n": n, "m": m, "h": h.float()}


def init_slstm_state(batch: int, cfg: XLSTMConfig, device=None) -> dict:
    d = cfg.d_model
    f32 = torch.float32
    return {"c": torch.zeros((batch, d), dtype=f32, device=device),
            "n": torch.zeros((batch, d), dtype=f32, device=device),
            "m": torch.full((batch, d), -1e9, dtype=f32, device=device),
            "h": torch.zeros((batch, d), dtype=f32, device=device)}
