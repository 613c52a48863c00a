"""Transformer building blocks of LM serving: norms, RoPE, GQA attention, MLPs.

The port of ``repro/nn/layers.py``, for attention-only serving.  Layers are
plain functions on tensors; a layer's parameters ``p`` are a mapping of
name to tensor (a ``dict``, or the ``ParameterDict`` / ``ModuleDict`` of
:class:`repro_torch.nn.transformer.LM`), laid out as in the reference: a
dense weight is ``[d_in, d_out]`` and the product is ``x @ w``.

Attention comes in the two serving layouts:

  * contiguous: a ``[B, Smax, G, dh]`` cache per layer and a dense masked
    softmax (:func:`attention_decode`);
  * paged: a shared block pool addressed through per-row block tables,
    decode attention through the ``flash_decode`` kernel
    (:func:`attention_decode_paged`) and chunked prefill with a dense
    causal mask (:func:`attention_prefill_paged`).

KV caches and pools are mutable serving state (the reference donates them
through its jitted dispatches): the port writes new KV into them in place
with ``index_put_`` and returns the same dicts.

Not ported yet (ROADMAP Queue A item 2): ``flash_attention`` and
``attention`` (the training / full-sequence forward) and M-RoPE.
"""
from __future__ import annotations

import dataclasses
import math

import torch

_NEG = -1e30  # the reference's mask sentinel


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, device=None):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """fp32 math, cast back to ``x``'s dtype."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def init_layernorm(d: int, device=None):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """fp32 math, cast back to ``x``'s dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["scale"]
            + p["bias"]).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 1e4, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: [B, S, H, dh]; positions: [B, S] int -> rotated x (fp32 math)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # [dh/2]
    ang = positions[..., None].float() * freqs  # [B, S, dh/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense projections
# ---------------------------------------------------------------------------

def _normal(generator: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=torch.float32)


def _dense_init(generator, d_in: int, d_out: int, bias: bool = False,
                scale: float | None = None, dtype=torch.float32):
    """``{"w": [d_in, d_out]}`` (+ ``"b"``) drawn on ``generator``'s device
    as the reference draws them (normal times ``d_in ** -0.5``), stored in
    ``dtype``."""
    scale = scale if scale is not None else (1.0 / d_in) ** 0.5
    p = {"w": (_normal(generator, (d_in, d_out)) * scale).to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=generator.device)
    return p


def dense(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int | None = None
    qkv_bias: bool = False
    rope_theta: float = 1e4
    mrope_sections: tuple | None = None  # set for qwen2-vl (not ported)
    causal: bool = True
    flash_block: int = 1024

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


def init_attention(generator, cfg: AttnConfig, dtype=torch.float32):
    dh = cfg.dh
    return {
        "q": _dense_init(generator, cfg.d_model, cfg.n_heads * dh,
                         cfg.qkv_bias, dtype=dtype),
        "k": _dense_init(generator, cfg.d_model, cfg.n_kv_heads * dh,
                         cfg.qkv_bias, dtype=dtype),
        "v": _dense_init(generator, cfg.d_model, cfg.n_kv_heads * dh,
                         cfg.qkv_bias, dtype=dtype),
        "o": _dense_init(generator, cfg.n_heads * dh, cfg.d_model,
                         dtype=dtype),
    }


def _qkv(p, x: torch.Tensor, cfg: AttnConfig, positions) -> tuple:
    if cfg.mrope_sections is not None:
        raise NotImplementedError("M-RoPE is not ported yet (ROADMAP Queue A "
                                  "item 2, the rest of the LM path)")
    B, S, _ = x.shape
    dh = cfg.dh
    q = dense(p["q"], x).reshape(B, S, cfg.n_heads, dh)
    k = dense(p["k"], x).reshape(B, S, cfg.n_kv_heads, dh)
    v = dense(p["v"], x).reshape(B, S, cfg.n_kv_heads, dh)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _quant_kv(t: torch.Tensor) -> tuple:
    """Per-(token, head) symmetric int8 quantisation of a ``[.., dh]`` slab:
    ``scale = amax / 127 + 1e-9`` in fp32, values rounded half to even."""
    amax = t.abs().amax(-1, keepdim=True)
    scale = amax.float() / 127.0 + 1e-9
    q = torch.clamp(torch.round(t.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def _dense_softmax_out(qf, k, v, valid, spec_s: str, spec_o: str):
    """``softmax(where(valid, q . k, -1e30)) . v`` in fp32."""
    s = torch.einsum(spec_s, qf, k)
    s = torch.where(valid, s, torch.full((), _NEG, dtype=s.dtype,
                                         device=s.device))
    return torch.einsum(spec_o, torch.softmax(s, dim=-1), v)


# ---------------------------------------------------------------------------
# Contiguous KV cache
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, max_len: int, cfg: AttnConfig,
                  dtype=torch.bfloat16, device=None) -> dict:
    G, dh = cfg.n_kv_heads, cfg.dh
    cache = {"k": torch.zeros((batch, max_len, G, dh), dtype=dtype,
                              device=device),
             "v": torch.zeros((batch, max_len, G, dh), dtype=dtype,
                              device=device),
             "len": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if dtype == torch.int8:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros((batch, max_len, G, 1),
                                      dtype=torch.float32, device=device)
    return cache


def attention_decode(p, x: torch.Tensor, cache: dict, cfg: AttnConfig,
                     positions, active=None) -> tuple:
    """Single-token decode against a contiguous cache, in place.

    x: [B, 1, d]; cache: {'k','v': [B, Smax, G, dh], 'len': [B]} (+
    'k_scale','v_scale' when int8).  Writes the new KV at position
    ``len`` of each active row (``active`` [B] bool; None = every row) and
    advances those rows' ``len``; rows not active keep their cache.
    Returns ``(out [B, 1, d], cache)``.
    """
    B = x.shape[0]
    q, k_new, v_new = _qkv(p, x, cfg, positions)
    pos = cache["len"].long()
    rows = torch.arange(B, device=x.device)
    if active is not None:
        rows = rows[active]
    at = (rows, pos[rows])
    if cache["k"].dtype == torch.int8:
        kq, ks = _quant_kv(k_new[:, 0])
        vq, vs = _quant_kv(v_new[:, 0])
        for name, val in (("k", kq), ("v", vq), ("k_scale", ks),
                          ("v_scale", vs)):
            cache[name].index_put_(at, val[rows])
        k = cache["k"].float() * cache["k_scale"]
        v = cache["v"].float() * cache["v_scale"]
    else:
        for name, val in (("k", k_new[:, 0]), ("v", v_new[:, 0])):
            cache[name].index_put_(at, val[rows].to(cache[name].dtype))
        k, v = cache["k"].float(), cache["v"].float()
    Smax, G = k.shape[1], k.shape[2]
    rep = cfg.n_heads // G
    qf = (q.float() * cfg.dh ** -0.5).reshape(B, 1, G, rep, cfg.dh)
    valid = torch.arange(Smax, device=x.device)[None, :] <= pos[:, None]
    out = _dense_softmax_out(qf, k, v, valid[:, None, None, None, :],
                             "bqgrd,bkgd->bqgrk", "bqgrk,bkgd->bqgrd")
    out = out.reshape(B, 1, cfg.n_heads * cfg.dh).to(x.dtype)
    cache["len"].index_add_(0, rows, torch.ones_like(rows,
                                                     dtype=torch.int32))
    return dense(p["o"], out), cache


# ---------------------------------------------------------------------------
# Paged KV attention (block-table pool; see repro_torch.lm.paging)
# ---------------------------------------------------------------------------

def init_kv_pool(num_blocks: int, block_size: int, cfg: AttnConfig,
                 dtype=torch.bfloat16, device=None) -> dict:
    """Shared KV block pool: ``num_blocks`` live blocks plus ONE trash block
    at physical index ``num_blocks`` — KV writes of inactive rows and padded
    prefill tokens land there.  Blocks are reused without zeroing: the
    per-row ``kv_lens`` make stale positions unreachable."""
    G, dh = cfg.n_kv_heads, cfg.dh
    nbp = num_blocks + 1
    pool = {"k": torch.zeros((nbp, block_size, G, dh), dtype=dtype,
                             device=device),
            "v": torch.zeros((nbp, block_size, G, dh), dtype=dtype,
                             device=device)}
    if dtype == torch.int8:
        for name in ("k_scale", "v_scale"):
            pool[name] = torch.zeros((nbp, block_size, G, 1),
                                     dtype=torch.float32, device=device)
    return pool


def _pool_write(pool: dict, phys, off, k_new, v_new) -> dict:
    """Write one token per row into the pool at ``(phys[r], off[r])``, in
    place.  k_new/v_new: [R, G, dh] (one token per row).  Several rows may
    target the trash block; which of them lands there does not matter."""
    at = (phys.long(), off.long())
    if pool["k"].dtype == torch.int8:
        kq, ks = _quant_kv(k_new)
        vq, vs = _quant_kv(v_new)
        for name, val in (("k", kq), ("v", vq), ("k_scale", ks),
                          ("v_scale", vs)):
            pool[name].index_put_(at, val)
    else:
        for name, val in (("k", k_new), ("v", v_new)):
            pool[name].index_put_(at, val.to(pool[name].dtype))
    return pool


def attention_decode_paged(p, x: torch.Tensor, pool: dict, cfg: AttnConfig,
                           table, kv_lens, active, *,
                           use_flash: bool = True) -> tuple:
    """Single-token decode against a paged KV pool.

    x: [B, 1, d]; pool: {'k','v': [NBP, bs, G, dh]} (+ scales when int8);
    table: [B, W] int32 block table; kv_lens: [B] int32 pre-write lengths;
    active: [B] bool — inactive rows write their KV to the trash block (and
    their output is garbage the caller ignores).  The pool is written in
    place.  Attention is one ``flash_decode`` call (the CUDA kernel for
    tensors on the card).  Returns ``(out, pool)``.
    """
    from repro_torch.kernels.flash_decode import ops as _fd

    B = x.shape[0]
    q, k_new, v_new = _qkv(p, x, cfg, kv_lens[:, None])
    bs = pool["k"].shape[1]
    trash = pool["k"].shape[0] - 1
    W = table.shape[1]
    lens = kv_lens.long()
    rows = torch.arange(B, device=x.device)
    blk = torch.clamp(lens // bs, max=W - 1)
    phys = torch.where(active, table[rows, blk].long(),
                       torch.full_like(lens, trash))
    _pool_write(pool, phys, lens % bs, k_new[:, 0], v_new[:, 0])
    G = pool["k"].shape[2]
    rep = cfg.n_heads // G
    qf = (q.float() * cfg.dh ** -0.5).reshape(B, G, rep, cfg.dh)
    out = _fd.flash_decode(qf, pool, table, kv_lens + 1, use_flash=use_flash)
    out = out.reshape(B, 1, cfg.n_heads * cfg.dh).to(x.dtype)
    return dense(p["o"], out), pool


def attention_prefill_paged(p, x: torch.Tensor, pool: dict, cfg: AttnConfig,
                            row_table, len0: int, count: int) -> tuple:
    """Chunked prefill for ONE slot against the paged pool.

    x: [1, C, d] — a static-width chunk whose first ``count`` tokens are
    real (the tail is padding whose KV goes to the trash block);
    row_table: [W] int32; len0: the KV length before the chunk.  Causal
    masking is per query position (kv pos <= len0 + i), so one call gives
    the logits of C single-token decode calls.  The pool is written in
    place.  Returns ``(out [1, C, d], pool)``.
    """
    C = x.shape[1]
    dev = x.device
    idx = len0 + torch.arange(C, device=dev)  # absolute positions [C]
    q, k_new, v_new = _qkv(p, x, cfg, idx[None])
    bs = pool["k"].shape[1]
    trash = pool["k"].shape[0] - 1
    W = row_table.shape[0]
    within = torch.arange(C, device=dev) < count
    phys = torch.where(within, row_table[torch.clamp(idx // bs, max=W - 1)]
                       .long(), torch.full_like(idx, trash))
    _pool_write(pool, phys, idx % bs, k_new[0], v_new[0])
    tab = row_table.long()
    k = pool["k"][tab].float()  # [W, bs, G, dh]
    v = pool["v"][tab].float()
    if "k_scale" in pool:
        k = k * pool["k_scale"][tab]
        v = v * pool["v_scale"][tab]
    G, dh = k.shape[2], k.shape[3]
    k = k.reshape(W * bs, G, dh)
    v = v.reshape(W * bs, G, dh)
    rep = cfg.n_heads // G
    qf = (q.float() * cfg.dh ** -0.5).reshape(1, C, G, rep, dh)
    valid = torch.arange(W * bs, device=dev)[None, :] <= idx[:, None]
    out = _dense_softmax_out(qf, k, v, valid[None, :, None, None, :],
                             "bcgrd,kgd->bcgrk", "bcgrk,kgd->bcgrd")
    out = out.reshape(1, C, cfg.n_heads * cfg.dh).to(x.dtype)
    return dense(p["o"], out), pool


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_swiglu(generator, d_model: int, d_ff: int, dtype=torch.float32):
    return {"gate": _dense_init(generator, d_model, d_ff, dtype=dtype),
            "up": _dense_init(generator, d_model, d_ff, dtype=dtype),
            "down": _dense_init(generator, d_ff, d_model, dtype=dtype)}


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference's JAX computes it:
    ``x * (1 / (1 + exp(-x)))``, every step rounded to ``x``'s dtype (in
    bf16 this differs from ``F.silu``, which rounds once, in about a third
    of the entries)."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    h = _silu(dense(p["gate"], x)) * dense(p["up"], x)
    return dense(p["down"], h)


def init_gelu_mlp(generator, d_model: int, d_ff: int, bias: bool = True,
                  dtype=torch.float32):
    return {"up": _dense_init(generator, d_model, d_ff, bias, dtype=dtype),
            "down": _dense_init(generator, d_ff, d_model, bias, dtype=dtype)}


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh approximation, its default) as JAX computes it:
    ``x * (0.5 * (1 + tanh(c * (x + 0.044715 * x**3))))`` with the
    constants and every step in ``x``'s dtype."""
    def const(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    inner = const(math.sqrt(2 / math.pi)) * (x + const(0.044715) * (x * x * x))
    return x * (const(0.5) * (1 + torch.tanh(inner)))


def gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    return dense(p["down"], _gelu(dense(p["up"], x)))
