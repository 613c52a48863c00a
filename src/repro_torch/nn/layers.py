"""Transformer building blocks: norms, RoPE / M-RoPE, GQA attention, MLPs.

The port of ``repro/nn/layers.py``.  Layers are
plain functions on tensors; a layer's parameters ``p`` are a mapping of
name to tensor (a ``dict``, or the ``ParameterDict`` / ``ModuleDict`` of
:class:`repro_torch.nn.transformer.LM`), laid out as in the reference: a
dense weight is ``[d_in, d_out]`` and the product is ``x @ w``.

Attention comes in the full-sequence form (:func:`attention`, train /
prefill / encoder: :func:`flash_attention`, the reference's blockwise
online softmax over KV blocks in fp32, written out as a loop) and in the
two serving layouts:

  * contiguous: a ``[B, Smax, G, dh]`` cache per layer and a dense masked
    softmax (:func:`attention_decode`);
  * paged: a shared block pool addressed through per-row block tables,
    decode attention through the ``flash_decode`` kernel
    (:func:`attention_decode_paged`) and chunked prefill with a dense
    causal mask (:func:`attention_prefill_paged`).

The full-sequence layers are differentiable (training); where the
reference checkpoints a loop body for its backward pass (the KV-block body
of :func:`flash_attention`), the port runs the same body under
``torch.utils.checkpoint`` whenever autograd records it (:func:`recording`).

KV caches and pools are mutable serving state (the reference donates them
through its jitted dispatches): the port writes new KV into them in place
with ``index_put_`` and returns the same dicts.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.nn.common import (current_mesh, is_dtensor, local_map,
                                   merge_heads, rows_local, shard,
                                   split_heads)

_NEG = -1e30  # the reference's mask sentinel


def recording(*tensors) -> bool:
    """Whether autograd records an op on ``tensors`` now: grad mode on and
    one of them (a tensor, or a mapping of tensors such as a layer's
    parameters) requiring grad."""
    if not torch.is_grad_enabled():
        return False
    for t in tensors:
        ts = (t,) if isinstance(t, torch.Tensor) else t.values()
        if any(x.requires_grad for x in ts):
            return True
    return False


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


def rmsnorm_logical() -> dict:
    return {"scale": ("embed_act",)}


def init_layernorm(d: int, device=None):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm_logical() -> dict:
    return {"scale": ("embed_act",), "bias": ("embed_act",)}


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


def _section_ids(sections: tuple, n: int, device) -> torch.Tensor:
    """``jnp.repeat(arange(3), sections, total_repeat_length=n)``: the
    position stream of each frequency (cut at ``n``, or the last stream
    repeated up to it)."""
    ids = [i for i, k in enumerate(sections) for _ in range(k)][:n]
    ids += [ids[-1]] * (n - len(ids))
    return torch.tensor(ids, dtype=torch.long, device=device)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, sections: tuple,
                theta: float = 1e6) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: 3 position streams (t, h, w) own disjoint
    frequency sections of the head dim.  x: [B, S, H, dh]; positions3:
    [B, 3, S]; ``sections`` sum to dh / 2 (e.g. (16, 24, 24) for dh = 128)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)  # [dh/2]
    sec = _section_ids(sections, dh // 2, x.device)
    pos = positions3.float()[:, sec, :]  # [B, dh/2, S]
    ang = pos.transpose(1, 2) * freqs  # [B, S, dh/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense projections
# ---------------------------------------------------------------------------

def _dense_init(draw, d_in: int, d_out: int, bias: bool = False,
                scale: float | None = None):
    """``{"w": [d_in, d_out]}`` (+ zero ``"b"``), normal times ``d_in **
    -0.5`` as the reference draws them; ``draw(shape, scale)`` makes a leaf
    (see :func:`repro_torch.nn.transformer.init`)."""
    scale = scale if scale is not None else (1.0 / d_in) ** 0.5
    p = {"w": draw((d_in, d_out), scale)}
    if bias:
        p["b"] = draw((d_out,), None, fill=0.0)
    return p


def _dense_logical(logical: tuple, bias: bool = False) -> dict:
    """The logical axes of :func:`_dense_init`'s leaves, the reference's."""
    lg = {"w": logical}
    if bias:
        lg["b"] = (logical[-1],)
    return lg


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
    mrope_sections: tuple | None = None  # set for qwen2-vl
    causal: bool = True
    flash_block: int = 1024

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


def init_attention(draw, cfg: AttnConfig):
    dh = cfg.dh
    return {
        "q": _dense_init(draw, cfg.d_model, cfg.n_heads * dh, cfg.qkv_bias),
        "k": _dense_init(draw, cfg.d_model, cfg.n_kv_heads * dh,
                         cfg.qkv_bias),
        "v": _dense_init(draw, cfg.d_model, cfg.n_kv_heads * dh,
                         cfg.qkv_bias),
        "o": _dense_init(draw, cfg.n_heads * dh, cfg.d_model),
    }


def attention_logical(cfg: AttnConfig) -> dict:
    return {"q": _dense_logical(("embed", "heads"), cfg.qkv_bias),
            "k": _dense_logical(("embed", "kv_heads"), cfg.qkv_bias),
            "v": _dense_logical(("embed", "kv_heads"), cfg.qkv_bias),
            "o": _dense_logical(("heads", "embed"))}


def _qkv(p, x: torch.Tensor, cfg: AttnConfig, positions) -> tuple:
    """q [B, S, H, dh], k/v [B, S, G, dh], rotated by RoPE at ``positions``
    [B, S] (none when None) or by M-RoPE at ``positions`` [B, 3, S]."""
    B, S, _ = x.shape
    dh = cfg.dh
    q = split_heads(dense(p["q"], x), cfg.n_heads, dh)
    k = split_heads(dense(p["k"], x), cfg.n_kv_heads, dh)
    v = split_heads(dense(p["v"], x), cfg.n_kv_heads, dh)
    if cfg.mrope_sections is not None:
        if positions is None:
            raise ValueError("M-RoPE needs explicit positions [B, 3, S]")
        q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
    elif positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    # Only the q heads get an explicit constraint; k/v inherit the weight
    # sharding (forcing n_kv < mesh axis size causes involuntary resharding).
    q = shard(q, "batch", "seq", "heads", None)
    return q, k, v


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, block: int, q_offset: int = 0
                    ) -> torch.Tensor:
    """Blockwise-softmax attention, the reference's loop over KV blocks.

    q: [B, Sq, H, dh]; k, v: [B, Sk, G, dh] with H = G * rep (GQA; KV heads
    repeated up to H).  Keys are padded to a multiple of ``block`` and
    visited block by block in order, each keeping a running max, sum and
    fp32 accumulator; masked scores are -1e30, as in the reference, so the
    numbers are the reference's up to fp32 summation order.  Under
    autograd each block runs under a checkpoint, as the reference's scan
    body does, so the backward pass keeps no [B, Sq, H, block] scores of
    any block.  Returns [B, Sq, H, dh] in q's dtype.
    """
    B, Sq, H, dh = q.shape
    Sk, G = k.shape[1], k.shape[2]
    rep = H // G
    qf = q.float() * dh ** -0.5
    if rep > 1:  # each KV head repeated rep times: [B, Sk, H, dh]
        k = k[:, :, :, None].expand(B, Sk, G, rep, dh).reshape(B, Sk, H, dh)
        v = v[:, :, :, None].expand(B, Sk, G, rep, dh).reshape(B, Sk, H, dh)
    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, Sq, H), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, H), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, H, dh), dtype=torch.float32, device=dev)

    def body(m, l, acc, kj, vj, j0: int):
        """One KV block: the running (m, l, acc) updated."""
        kj, vj = kj.float(), vj.float()
        n = kj.shape[1]
        if n < block:  # the padded tail of the last block
            kj = torch.nn.functional.pad(kj, (0, 0, 0, 0, 0, block - n))
            vj = torch.nn.functional.pad(vj, (0, 0, 0, 0, 0, block - n))
        s = torch.einsum("bqhd,bkhd->bqhk", qf, kj)
        s = shard(s, "batch", "seq", "heads", None)
        kv_pos = j0 + torch.arange(block, device=dev)
        valid = (kv_pos < Sk)[None, :]
        if causal:
            valid = valid & (kv_pos[None, :] <= q_pos[:, None])
        s = torch.where(valid[None, :, None, :], s,
                        torch.full((), _NEG, dtype=torch.float32, device=dev))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bqhk,bkhd->bqhd", p, vj)
        return m_new, l, acc

    remat = recording(qf, k, v)
    for j0 in range(0, Sk, block):
        args = (m, l, acc, k[:, j0:j0 + block], v[:, j0:j0 + block], j0)
        m, l, acc = (checkpoint(body, *args, use_reentrant=False) if remat
                     else body(*args))
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.to(q.dtype)


def sharded_flash_attention(q, k, v, **kw) -> torch.Tensor:
    """:func:`flash_attention`, run on each rank's rows under a mesh
    (:func:`repro_torch.nn.common.rows_local`; the heads gathered).  GSPMD
    partitions the reference's blockwise loop over batch and heads; DTensor
    cannot propagate through the loop's products once batch and heads are
    both split, so the port splits the rows only."""
    return rows_local(lambda q, k, v: flash_attention(q, k, v, **kw),
                      (q, k, v))


def attention(p, x: torch.Tensor, cfg: AttnConfig,
              positions=None) -> torch.Tensor:
    """Full-sequence (train / prefill / encoder) attention. x: [B, S, d]."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    out = sharded_flash_attention(q, k, v, causal=cfg.causal,
                                  block=min(cfg.flash_block, S))
    return shard(dense(p["o"], merge_heads(out)), "batch", "seq", "embed_act")


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
    'k_scale','v_scale' when int8).  Every row attends as the reference's
    does, its new KV written at position ``len`` (dropped for a row already
    at ``Smax``); afterwards only the ``active`` rows ([B] bool; None =
    every row) keep that write and advance ``len``, the others get their
    old entry back (the reference's masked merge: an idle row's output
    still feeds what the batch shares, such as MoE capacity).  No host
    sync.  Returns ``(out [B, 1, d], cache)``.
    """
    B = x.shape[0]
    q, k_new, v_new = _qkv(p, x, cfg, positions)
    if current_mesh() is not None and is_dtensor(cache["k"]):
        out = _decode_sharded(q, k_new, v_new, cache, cfg, active)
        cache["len"].add_(1 if active is None else active.to(torch.int32))
        return shard(dense(p["o"], out), "batch", None, "embed_act"), cache
    Smax = cache["k"].shape[1]
    pos = cache["len"].long()
    rows = torch.arange(B, device=x.device)
    at = (rows, torch.clamp(pos, max=Smax - 1))
    if cache["k"].dtype == torch.int8:
        kq, ks = _quant_kv(k_new[:, 0])
        vq, vs = _quant_kv(v_new[:, 0])
        new = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        new = {"k": k_new[:, 0], "v": v_new[:, 0]}
    fits = (pos < Smax)[:, None, None]
    saved = {}
    for name, val in new.items():
        saved[name] = cache[name][at]
        cache[name].index_put_(at, torch.where(
            fits, val.to(cache[name].dtype), saved[name]))
    if "k_scale" in cache:
        k = cache["k"].float() * cache["k_scale"]
        v = cache["v"].float() * cache["v_scale"]
    else:
        k, v = cache["k"].float(), cache["v"].float()
    G = k.shape[2]
    rep = cfg.n_heads // G
    qf = (q.float() * cfg.dh ** -0.5).reshape(B, 1, G, rep, cfg.dh)
    valid = torch.arange(Smax, device=x.device)[None, :] <= pos[:, None]
    out = _dense_softmax_out(qf, k, v, valid[:, None, None, None, :],
                             "bqgrd,bkgd->bqgrk", "bqgrk,bkgd->bqgrd")
    out = out.reshape(B, 1, cfg.n_heads * cfg.dh).to(x.dtype)
    if active is None:
        cache["len"].add_(1)
    else:
        keep = active[:, None, None]
        for name in new:
            cache[name].index_put_(at, torch.where(keep, cache[name][at],
                                                   saved[name]))
        cache["len"].add_(active.to(torch.int32))
    return shard(dense(p["o"], out), "batch", None, "embed_act"), cache


def _decode_sharded(q, k_new, v_new, cache: dict, cfg: AttnConfig,
                    active) -> torch.Tensor:
    """:func:`attention_decode`'s cache write and attention under a mesh,
    on a cache split over rows and sequence (the dry-run's decode cells).

    Each rank writes the new KV where its span of the sequence holds the
    row's position and attends over its span; the partial softmax is
    combined across the sequence's mesh axes (the max, then the sums), as
    flash decoding does.  GSPMD partitions the reference's dense softmax
    over a sharded sequence so; DTensor has no in-place write to a sharded
    tensor.  The same numbers as the one-device path up to the order of
    the softmax's sums.  Returns the attention output [B, 1, H * dh]."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Shard

    kc = cache["k"]
    mesh = kc.device_mesh
    names = mesh.mesh_dim_names

    def dims(d):
        return [i for i, pl in enumerate(kc.placements)
                if isinstance(pl, Shard) and pl.dim == d]

    def entry(ds):
        return (tuple(names[i] for i in ds) if len(ds) > 1
                else (names[ds[0]] if ds else None))

    row_dims, seq_dims = dims(0), dims(1)
    rows, seq = entry(row_dims), entry(seq_dims)
    leaf_names = [n for n in ("k", "v", "k_scale", "v_scale") if n in cache]
    Smax, H, dh = kc.shape[1], cfg.n_heads, cfg.dh
    pos = cache["len"].long()
    act = pos >= 0 if active is None else active

    def combine(t, op):
        for i in seq_dims:
            t = funcol.all_reduce(t, op, (mesh, i))
        return t

    def local(q, k_new, v_new, pos, act, *leaves):
        c = dict(zip(leaf_names, leaves))
        Bl, S_loc = q.shape[0], c["k"].shape[1]
        off = 0
        for i in seq_dims:
            off = off * mesh.size(i) + mesh.get_local_rank(i)
        off *= S_loc
        idx = pos - off
        fits = (pos < Smax) & (idx >= 0) & (idx < S_loc)
        at = (torch.arange(Bl, device=q.device), torch.clamp(idx, 0, S_loc - 1))
        if c["k"].dtype == torch.int8:
            kq, ks = _quant_kv(k_new[:, 0])
            vq, vs = _quant_kv(v_new[:, 0])
            new = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        else:
            new = {"k": k_new[:, 0], "v": v_new[:, 0]}
        saved = {}
        for name, val in new.items():
            saved[name] = c[name][at]
            c[name].index_put_(at, torch.where(
                fits[:, None, None], val.to(c[name].dtype), saved[name]))
        k, v = c["k"].float(), c["v"].float()
        if "k_scale" in c:
            k, v = k * c["k_scale"], v * c["v_scale"]
        G = k.shape[2]
        qf = (q.float() * dh ** -0.5).reshape(Bl, 1, G, H // G, dh)
        valid = ((off + torch.arange(S_loc, device=q.device))[None, :]
                 <= pos[:, None])[:, None, None, None, :]
        s = torch.einsum("bqgrd,bkgd->bqgrk", qf, k)
        s = torch.where(valid, s, torch.full((), _NEG, device=q.device))
        m = combine(s.amax(-1), "max")
        e = torch.where(valid, torch.exp(s - m[..., None]),
                        torch.zeros((), device=q.device))
        l = combine(e.sum(-1), "sum")
        acc = combine(torch.einsum("bqgrk,bkgd->bqgrd", e, v), "sum")
        out = (acc / l[..., None]).reshape(Bl, 1, H * dh).to(q.dtype)
        if active is not None:
            keep = (act & fits)[:, None, None]
            for name in new:
                c[name].index_put_(at, torch.where(keep, c[name][at],
                                                   saved[name]))
        return out

    tok, vec, cspec = (rows, None, None, None), (rows,), (rows, seq, None, None)
    return local_map(local, (q, k_new, v_new, pos, act,
                             *[cache[n] for n in leaf_names]),
                     [tok, tok, tok, vec, vec] + [cspec] * len(leaf_names),
                     [(rows, None, None)])


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
    return shard(dense(p["o"], out), "batch", None, "embed_act"), pool


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
    return shard(dense(p["o"], out), "batch", "seq", "embed_act"), pool


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_swiglu(draw, d_model: int, d_ff: int):
    return {"gate": _dense_init(draw, d_model, d_ff),
            "up": _dense_init(draw, d_model, d_ff),
            "down": _dense_init(draw, d_ff, d_model)}


def swiglu_logical() -> dict:
    return {"gate": _dense_logical(("embed", "mlp")),
            "up": _dense_logical(("embed", "mlp")),
            "down": _dense_logical(("mlp", "embed"))}


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference's JAX computes it:
    ``x * (1 / (1 + exp(-x)))``, every step rounded to ``x``'s dtype (in
    bf16 this differs from ``F.silu``, which rounds once, in about a third
    of the entries)."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    h = _silu(dense(p["gate"], x)) * dense(p["up"], x)
    h = shard(h, "batch", "seq", "mlp")
    return shard(dense(p["down"], h), "batch", "seq", "embed_act")


def init_gelu_mlp(draw, d_model: int, d_ff: int, bias: bool = True):
    return {"up": _dense_init(draw, d_model, d_ff, bias),
            "down": _dense_init(draw, d_ff, d_model, bias)}


def gelu_mlp_logical(bias: bool = True) -> dict:
    return {"up": _dense_logical(("embed", "mlp"), bias),
            "down": _dense_logical(("mlp", "embed"), bias)}


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh approximation, its default) as JAX computes it:
    ``x * (0.5 * (1 + tanh(c * (x + 0.044715 * x**3))))`` with the
    constants and every step in ``x``'s dtype."""
    def const(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    inner = const(math.sqrt(2 / math.pi)) * (x + const(0.044715) * (x * x * x))
    return x * (const(0.5) * (1 + torch.tanh(inner)))


def gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    h = shard(_gelu(dense(p["up"], x)), "batch", "seq", "mlp")
    return shard(dense(p["down"], h), "batch", "seq", "embed_act")
