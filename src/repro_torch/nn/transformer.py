"""Model assembly: the decoder stack of LM serving.

The port of ``repro/nn/transformer.py`` for attention-only stacks
(``block_pattern=("attn_mlp",)``, e.g. Llama 3.2 3B).  :class:`ModelConfig`
keeps every field of the reference; a config the port cannot run yet (MoE,
Mamba, xLSTM, cross-attention, encoders, M-RoPE, vision prefixes) raises
``NotImplementedError`` where a model is built from it.

The model is an ``nn.Module``, :class:`LM`: the embedding, one block per
layer (``ln1``, ``attn``, ``ln2``, ``mlp``), ``final_ln`` and ``lm_head``.
The reference keeps fp32 parameters and casts every matmul weight to
``activ_dtype`` on each call; the port stores those weights (embedding and
head included) already in ``activ_dtype``, which gives the same numbers and
halves the bytes a bf16 decode step reads.  Norm scales stay fp32.  The
reference's scan over stacked periods is a Python loop over layers here.

Not ported yet (ROADMAP Queue A item 2): ``forward`` and ``loss_fn`` (the
training / full-sequence path), stateful blocks and their caches.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn
import torch.nn.functional as F

from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.nn import layers as L

_LATER = "ROADMAP Queue A item 2, the rest of the LM path"


@dataclasses.dataclass(frozen=True)
class EncoderConfig:  # whisper-style; not ported yet
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    n_frames: int = 1500


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    block_pattern: tuple = ("attn_mlp",)
    norm: str = "rmsnorm"  # or "layernorm"
    mlp_kind: str = "swiglu"  # or "gelu"
    qkv_bias: bool = False
    rope_theta: float = 1e4
    mrope_sections: tuple | None = None  # qwen2-vl (not ported)
    vision_patches: int = 0  # qwen2-vl stub frontend (not ported)
    moe: Any = None  # MoEConfig (nn/moe.py, not ported)
    mamba: Any = None  # MambaConfig (nn/mamba.py, not ported)
    xlstm: Any = None  # XLSTMConfig (nn/xlstm.py, not ported)
    encoder: EncoderConfig | None = None  # whisper (not ported)
    tie_embeddings: bool = False
    remat: bool = True
    remat_policy: str = "full"
    kv_cache_dtype: str = "bf16"  # "int8": halves decode cache traffic
    param_dtype: Any = torch.float32
    activ_dtype: Any = torch.bfloat16

    @property
    def period(self) -> int:
        return len(self.block_pattern)

    @property
    def n_periods(self) -> int:
        if self.n_layers % self.period:
            raise ValueError(f"{self.n_layers} layers are not a whole number "
                             f"of periods of {self.block_pattern}")
        return self.n_layers // self.period

    def attn_cfg(self, causal=True) -> L.AttnConfig:
        return L.AttnConfig(self.d_model, self.n_heads, self.n_kv_heads,
                            self.head_dim, self.qkv_bias, self.rope_theta,
                            self.mrope_sections, causal=causal)


def unsupported_reason(cfg: ModelConfig) -> str | None:
    """None when the port can build ``cfg``, else what it lacks."""
    bad = [k for k in cfg.block_pattern if k != "attn_mlp"]
    if bad:
        return (f"block kinds {bad} of {cfg.block_pattern} are not ported yet"
                " (attn_moe waits for nn/moe.py; mamba, xLSTM and "
                "cross-attention blocks for their modules)")
    for name in ("moe", "mamba", "xlstm", "encoder"):
        if getattr(cfg, name) is not None:
            return f"{name} configs are not ported yet"
    if cfg.mrope_sections is not None or cfg.vision_patches:
        return "M-RoPE and vision prefixes are not ported yet"
    return None


def check_supported(cfg: ModelConfig) -> None:
    reason = unsupported_reason(cfg)
    if reason is not None:
        raise NotImplementedError(f"{cfg.name}: {reason} ({_LATER})")


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------

def _as_module(tree: dict) -> nn.Module:
    """A nested dict of tensors as ``ModuleDict`` / ``ParameterDict``s of
    frozen parameters (layers read them as ``p["w"]``, as from a dict)."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                 for k, v in tree.items()})
    return nn.ModuleDict({k: _as_module(v) for k, v in tree.items()})


class LM(nn.Module):
    """Decoder stack: ``embed`` [V, d], ``blocks[l]`` (``ln1``, ``attn``
    with ``q``/``k``/``v``/``o`` dense weights ``[d_in, d_out]``, ``ln2``,
    ``mlp``), ``final_ln`` and ``lm_head`` [d, V] (None when tied)."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor, blocks: list,
                 final_ln: dict, lm_head: torch.Tensor | None):
        super().__init__()
        check_supported(cfg)
        if len(blocks) != cfg.n_layers:
            raise ValueError(f"{len(blocks)} blocks for {cfg.n_layers} layers")
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.blocks = nn.ModuleList(_as_module(b) for b in blocks)
        self.final_ln = _as_module(final_ln)
        self.lm_head = (None if lm_head is None
                        else nn.Parameter(lm_head, requires_grad=False))

    @property
    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    @property
    def device(self) -> torch.device:
        return self.embed.device


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _norm_init(cfg: ModelConfig, device):
    return (L.init_rmsnorm(cfg.d_model, device) if cfg.norm == "rmsnorm"
            else L.init_layernorm(cfg.d_model, device))


def _init_block(generator, cfg: ModelConfig, dtype, device) -> dict:
    def moved(tree):
        return {k: moved(v) if isinstance(v, dict) else v.to(device)
                for k, v in tree.items()}

    attn = L.init_attention(generator, cfg.attn_cfg(), dtype)
    if cfg.mlp_kind == "swiglu":
        mlp = L.init_swiglu(generator, cfg.d_model, cfg.d_ff, dtype)
    else:
        mlp = L.init_gelu_mlp(generator, cfg.d_model, cfg.d_ff, dtype=dtype)
    return {"ln1": _norm_init(cfg, device), "attn": moved(attn),
            "ln2": _norm_init(cfg, device), "mlp": moved(mlp)}


def init(cfg: ModelConfig, generator=0, device=DEFAULT_DEVICE) -> LM:
    """Random weights as the reference draws them (normal, times
    ``d_in ** -0.5`` for dense weights and ``d_model ** -0.5`` for the
    embedding and head; unit norm scales), on ``device``.

    An int ``generator`` seeds a generator ON ``device``, so a full-width
    model (3.6 G normals for Llama 3.2 3B) is drawn on the card in seconds
    rather than on the CPU in minutes; the numbers therefore differ between
    a CPU and a CUDA model of one seed.  A ``torch.Generator`` draws on its
    own device, and the weights are then moved.  Parity with the reference
    goes through :func:`repro_torch.convert.lm_params_from_reference`, not
    through this function.
    """
    check_supported(cfg)
    dev = resolve(device)
    gen = (generator if isinstance(generator, torch.Generator)
           else torch.Generator(device=dev).manual_seed(int(generator)))
    wd = cfg.activ_dtype
    scale = cfg.d_model ** -0.5
    embed = (L._normal(gen, (cfg.vocab, cfg.d_model)) * scale).to(wd)
    head = None
    if not cfg.tie_embeddings:
        head = (L._normal(gen, (cfg.d_model, cfg.vocab)) * scale).to(wd)
    blocks = [_init_block(gen, cfg, wd, dev) for _ in range(cfg.n_layers)]
    return LM(cfg, embed.to(dev), blocks, _norm_init(cfg, dev),
              None if head is None else head.to(dev))


def param_count(model: LM) -> int:
    return sum(p.numel() for p in model.parameters())


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    return L.rmsnorm(p, x) if cfg.norm == "rmsnorm" else L.layernorm(p, x)


def _embed(model: LM, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.long(), model.embed).to(cfg.activ_dtype)


def _ffn_half(p, kind: str, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """``x + mlp(norm(x))`` of one ``attn_mlp`` block."""
    h = _norm(cfg, p["ln2"], x)
    if cfg.mlp_kind == "swiglu":
        return x + L.swiglu(p["mlp"], h)
    return x + L.gelu_mlp(p["mlp"], h)


def _logits(model: LM, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = _norm(cfg, model.final_ln, x)
    return (x @ model.head.to(cfg.activ_dtype)).float()


# ---------------------------------------------------------------------------
# Decode (contiguous cache)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=DEFAULT_DEVICE) -> dict:
    """Per-layer contiguous KV caches, stacked: ``k``/``v``
    ``[n_layers, batch, max_len, G, dh]`` (+ scales when int8) and ``len``
    ``[n_layers, batch]``, as the reference stacks its periods."""
    check_supported(cfg)
    dev = resolve(device)
    if cfg.kv_cache_dtype == "int8":
        dtype = torch.int8
    one = L.init_kv_cache(batch, max_len, cfg.attn_cfg(), dtype, dev)
    return {k: v[None].repeat((cfg.n_layers,) + (1,) * v.dim())
            for k, v in one.items()}


def layer_cache(cache: dict, layer: int) -> dict:
    """One layer's cache: views into the stacked leaves, written in place."""
    return {k: v[layer] for k, v in cache.items()}


def decode_step(model: LM, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, active=None) -> tuple:
    """One decode step. tokens [B, 1] -> (logits [B, 1, vocab] fp32, cache).

    Each row's position is its current cache length.  The cache is written
    in place for the ``active`` rows ([B] bool; None = all); rows not active
    keep their cache and length (the reference's masked merge)."""
    x = _embed(model, cfg, tokens)
    positions = cache["len"][0].clone()[:, None]
    for i, blk in enumerate(model.blocks):
        h = _norm(cfg, blk["ln1"], x)
        a, _ = L.attention_decode(blk["attn"], h, layer_cache(cache, i),
                                  cfg.attn_cfg(), positions, active)
        x = _ffn_half(blk, "attn_mlp", cfg, x + a)
    return _logits(model, cfg, x), cache
