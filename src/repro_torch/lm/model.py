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
model's layout and the caller's grad mode.  Paging takes
attention-only stacks, with an MLP or MoE half (``attn_mlp`` /
``attn_moe``; each layer's kind from ``block_pattern``):
:func:`check_paging_supported` rejects stateful block patterns (mamba /
xLSTM / cross-attention / encoders) and M-RoPE with the reason, as the
reference does.
"""
from __future__ import annotations

import torch

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


@torch.no_grad()
def decode_step_paged(model, cfg, pool: dict, table, kv_lens, tokens, active,
                      *, use_flash: bool = True) -> tuple:
    """One decode step. tokens [B, 1]; table [B, W] int32; kv_lens [B]
    int32 pre-write lengths; active [B] bool.  Returns (logits [B, 1, V]
    fp32, pool).  Reads nothing back to the host."""
    x = T._embed(model, cfg, tokens)
    for i, blk in enumerate(model.blocks):
        h = T._norm(cfg, blk["ln1"], x)
        a, _ = L.attention_decode_paged(
            blk["attn"], h, layer_pool(pool, i), cfg.attn_cfg(), table,
            kv_lens, active, use_flash=use_flash)
        x = T._ffn_half(blk, cfg.kind(i), cfg, x + a)[0]
    return T._logits(model, cfg, x), pool


@torch.no_grad()
def prefill_chunk_paged(model, cfg, pool: dict, row_table, len0: int, tokens,
                        count: int) -> tuple:
    """Prefill one static-width chunk for one slot.  tokens [1, C] (first
    ``count`` real, tail padded); row_table [W] int32; len0 the KV length
    before the chunk.  Returns (logits [1, C, V] fp32, pool)."""
    x = T._embed(model, cfg, tokens)
    for i, blk in enumerate(model.blocks):
        h = T._norm(cfg, blk["ln1"], x)
        a, _ = L.attention_prefill_paged(
            blk["attn"], h, layer_pool(pool, i), cfg.attn_cfg(), row_table,
            len0, count)
        x = T._ffn_half(blk, cfg.kind(i), cfg, x + a)[0]
    return T._logits(model, cfg, x), pool
