"""Paged transformer entry points: decode and chunked prefill over a KV pool.

The port of ``repro/lm/model.py``.  Mirrors
:func:`repro_torch.nn.transformer.decode_step`'s loop over layers, but
threads the stacked KV *pool* (shared physical blocks) plus a block
``table``/``kv_lens`` pair instead of a per-row contiguous cache:

  * :func:`decode_step_paged` — one token for every slot; KV writes land at
    ``table[row, len // bs]`` (the trash block for inactive rows), and each
    layer's attention is one ``flash_decode`` call (one launch of the CUDA
    kernel for tensors on the card);
  * :func:`prefill_chunk_paged` — a static-width prompt chunk for ONE slot:
    one call per chunk instead of one per token, causally masked per query
    so the emitted logits equal the token-by-token path.

The pool is written in place (the reference donates it).  Both entry
points run under ``torch.no_grad()``: serving builds no graph, whatever the
model's layout and the caller's grad mode.  Each layer attends with its own
configuration (``cfg.attn_cfg(layer=i)``): full attention, or a sliding
window over the last ``cfg.sliding_window`` positions (``attn_pattern``),
whose decode is ``flash_decode`` over the window.  A dropless MoE routes
only the chunk's real tokens and the step's active rows; with a recorder
(``obs``) each layer's MoE half runs in a ``moe`` span (args ``layer``,
``tokens``, ``call``) and ``moe_stats`` (:class:`repro_torch.nn.moe.
MoEStats`) keeps its experts touched and largest group on the device.
Paging takes attention-only stacks, with an MLP or MoE half (``attn_mlp`` /
``attn_moe``; each layer's kind from ``block_pattern``):
:func:`check_paging_supported` rejects stateful block patterns (mamba /
xLSTM / cross-attention / encoders) and M-RoPE with the reason, as the
reference does.
"""
from __future__ import annotations

import torch

from repro_torch import obs as obs_mod
from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.nn import layers as L
from repro_torch.nn import transformer as T


def paging_unsupported_reason(cfg) -> str | None:
    """None when ``cfg`` can serve paged, else a human-readable reason."""
    bad = [k for k in cfg.block_pattern
           if not k.startswith("attn") or "cross" in k]
    if bad:
        return (f"paged serving needs attention-only block patterns, got "
                f"{cfg.block_pattern} (unsupported: {bad})")
    if cfg.encoder is not None:
        return "encoder-decoder (whisper) stacks are not paged"
    if cfg.mrope_sections is not None:
        return "M-RoPE (multi-stream positions) is not paged"
    if cfg.vision_patches:
        return "vision-prefix stacks are not paged"
    unknown = set(cfg.attn_pattern) - {"full", "sliding"}
    if unknown:
        return f"unknown attention kinds {sorted(unknown)}"
    if "sliding" in cfg.attn_pattern and cfg.sliding_window is None:
        return "sliding layers need a sliding_window"
    return None


def check_paging_supported(cfg) -> None:
    reason = paging_unsupported_reason(cfg)
    if reason is not None:
        raise ValueError(reason)


def init_pool(cfg, num_blocks: int, block_size: int,
              device=DEFAULT_DEVICE) -> dict:
    """Per-layer pools, stacked: every leaf is ``[n_layers, num_blocks + 1,
    block_size, ...]`` (the +1 is each layer's trash block)."""
    check_paging_supported(cfg)
    dev = resolve(device)
    dtype = torch.int8 if cfg.kv_cache_dtype == "int8" else torch.bfloat16
    one = L.init_kv_pool(num_blocks, block_size, cfg.attn_cfg(), dtype, "meta")
    return {k: torch.zeros((cfg.n_layers,) + tuple(v.shape), dtype=v.dtype,
                           device=dev) for k, v in one.items()}


def layer_pool(pool: dict, layer: int) -> dict:
    """One layer's pool: views into the stacked leaves, written in place."""
    return {k: v[layer] for k, v in pool.items()}


def _ffn_half(blk, i: int, cfg, x, valid, obs, track: str, moe_stats,
              tokens: int | None):
    """Layer ``i``'s MLP or MoE half; a MoE half inside a ``moe`` span
    when ``obs`` records, its call logged in ``moe_stats`` where given."""
    kind = cfg.kind(i)
    if not (kind.endswith("moe") and obs.enabled):
        return T._ffn_half(blk, kind, cfg, x, valid)[0]
    args = {"layer": i, "tokens": tokens}
    if moe_stats is not None:
        args["call"] = moe_stats.calls  # the index record() gives the call
    with obs.span("moe", track=track, cat="lm", args=args):
        x, aux = T._ffn_half(blk, kind, cfg, x, valid)
        if moe_stats is not None:
            moe_stats.record(aux["expert_counts"])
    return x


@torch.no_grad()
def decode_step_paged(model, cfg, pool: dict, table, kv_lens, tokens, active,
                      *, use_flash: bool = True, obs=None,
                      obs_track: str = "lm", moe_stats=None,
                      routed: int | None = None) -> tuple:
    """One decode step. tokens [B, 1]; table [B, W] int32; kv_lens [B]
    int32 pre-write lengths; active [B] bool (the rows a dropless MoE
    routes).  ``routed``: the active rows' count, for the ``moe`` spans'
    args.  Returns (logits [B, 1, V] fp32, pool).  Reads nothing back to
    the host."""
    obs = obs if obs is not None else obs_mod.NULL
    x = T._embed(model, cfg, tokens)
    memo: dict = {}  # what the step's layers share (L._memo)
    for i, blk in enumerate(model.blocks):
        h = T._norm(cfg, blk["ln1"], x)
        a, _ = L.attention_decode_paged(
            blk["attn"], h, layer_pool(pool, i), cfg.attn_cfg(layer=i), table,
            kv_lens, active, use_flash=use_flash, memo=memo)
        x = _ffn_half(blk, i, cfg, x + a, active[:, None], obs, obs_track,
                      moe_stats, routed)
    return T._logits(model, cfg, x), pool


@torch.no_grad()
def prefill_chunk_paged(model, cfg, pool: dict, row_table, len0: int, tokens,
                        count: int, *, obs=None, obs_track: str = "lm",
                        moe_stats=None) -> tuple:
    """Prefill one static-width chunk for one slot.  tokens [1, C] (first
    ``count`` real, tail padded; a dropless MoE routes the real ones);
    row_table [W] int32; len0 the KV length before the chunk.  Returns
    (logits [1, C, V] fp32, pool)."""
    obs = obs if obs is not None else obs_mod.NULL
    x = T._embed(model, cfg, tokens)
    valid = (torch.arange(tokens.shape[1], device=x.device)[None] < count
             if cfg.moe_dropless else None)
    memo: dict = {}  # what the chunk's layers share (L._memo)
    for i, blk in enumerate(model.blocks):
        h = T._norm(cfg, blk["ln1"], x)
        a, _ = L.attention_prefill_paged(
            blk["attn"], h, layer_pool(pool, i), cfg.attn_cfg(layer=i),
            row_table, len0, count, memo)
        x = _ffn_half(blk, i, cfg, x + a, valid, obs, obs_track, moe_stats,
                      count)
    return T._logits(model, cfg, x), pool
