"""Model assembly: heterogeneous-block decoder stacks.

The port of ``repro/nn/transformer.py``; one config drives the ten
reference architectures and Mellum2, which the reference does not have.  A
``block_pattern`` (cycled over layers) names each layer's kind:

    attn_mlp | attn_moe | attn_cross_mlp (whisper decoder) |
    mamba_mlp | mamba_moe | mlstm | slstm

and an ``attn_pattern`` (cycled over layers too) its attention's: ``full``
(every earlier position; RoPE scaled by ``yarn`` where set) or ``sliding``
(the last ``sliding_window`` positions, plain RoPE).

The model is an ``nn.Module``, :class:`LM`: the embedding, one block per
layer (layer ``i`` is of kind ``block_pattern[i % period]``), ``final_ln``,
``lm_head`` and, for encoder-decoder stacks, the encoder's blocks,
``enc_ln`` and ``enc_pos``.

Two storage layouts.  The reference keeps fp32 parameters and casts every
matmul weight (and bias) to ``activ_dtype`` on each call.  The **training
layout** (``init(..., trainable=True)``) is the reference's: every leaf in
``cfg.param_dtype`` (fp32), a trainable ``nn.Parameter``, cast on use.  The
**serving layout** (the default) is frozen and stores the matmul weights
already in ``activ_dtype``, which gives the same numbers and halves the
bytes a bf16 step reads; what the reference reads in fp32 stays fp32: norm
scales and biases, and Mamba's ``A_log`` (:func:`stored_dtype`).
:func:`serving_copy` turns a trained model into the serving layout.  The
reference's scan over stacked periods is a Python loop over layers.

Entry points: :func:`forward` (full sequence) and :func:`loss_fn`
(next-token CE plus the MoE aux terms), which build an autograd graph when
the caller's grad mode and the parameters ask for one; under a graph with
``cfg.remat`` each period runs under ``torch.utils.checkpoint``, as the
reference's ``jax.checkpoint`` of its period body.  :func:`init_cache` and
:func:`decode_step` (one token against the contiguous caches, written in
place for the ``active`` rows; never differentiated), :func:`abstract_init`
and :func:`count_params_cfg` (shapes only).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.nn import layers as L
from repro_torch.nn import mamba as Mb
from repro_torch.nn import moe as Moe
from repro_torch.nn import xlstm as Xl
from repro_torch.nn.common import (current_mesh, merge_heads, shard,
                                   split_heads)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:  # whisper-style
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
    mrope_sections: tuple | None = None  # qwen2-vl
    vision_patches: int = 0  # qwen2-vl stub frontend: patches replace prefix tokens
    moe: Moe.MoEConfig | None = None
    mamba: Mb.MambaConfig | None = None
    xlstm: Xl.XLSTMConfig | None = None
    encoder: EncoderConfig | None = None  # whisper
    tie_embeddings: bool = False
    remat: bool = True
    remat_policy: str = "full"
    kv_cache_dtype: str = "bf16"  # "int8": halves decode cache traffic
    param_dtype: Any = torch.float32
    activ_dtype: Any = torch.bfloat16
    attn_pattern: tuple = ("full",)  # "full" | "sliding", cycled over layers
    sliding_window: int | None = None  # keys a "sliding" layer sees
    yarn: L.YaRN | None = None  # the RoPE scaling of "full" layers
    moe_dropless: bool = False  # MoE layers: Moe.moe_dropless, no capacity

    @property
    def period(self) -> int:
        return len(self.block_pattern)

    @property
    def n_periods(self) -> int:
        if self.n_layers % self.period:
            raise ValueError(f"{self.n_layers} layers are not a whole number "
                             f"of periods of {self.block_pattern}")
        return self.n_layers // self.period

    def kind(self, layer: int) -> str:
        return self.block_pattern[layer % self.period]

    def attn_kind(self, layer: int) -> str:
        """``"full"`` or ``"sliding"``: layer ``layer``'s attention."""
        kind = self.attn_pattern[layer % len(self.attn_pattern)]
        if kind not in ("full", "sliding"):
            raise ValueError(f"unknown attention kind {kind!r}")
        if kind == "sliding" and self.sliding_window is None:
            raise ValueError("a sliding layer needs sliding_window")
        return kind

    def attn_cfg(self, causal=True, layer: int = 0) -> L.AttnConfig:
        """Layer ``layer``'s self-attention: a sliding layer's window and
        plain RoPE, or a full layer's RoPE with ``yarn``."""
        sliding = self.attn_kind(layer) == "sliding"
        return L.AttnConfig(self.d_model, self.n_heads, self.n_kv_heads,
                            self.head_dim, self.qkv_bias, self.rope_theta,
                            self.mrope_sections, causal=causal,
                            window=self.sliding_window if sliding else None,
                            yarn=None if sliding else self.yarn)

    def xattn_cfg(self) -> L.AttnConfig:
        """Cross-attention of ``attn_cross_mlp`` blocks: MHA, no bias, no
        RoPE, not causal (queries from the decoder, K/V from the encoder)."""
        return L.AttnConfig(self.d_model, self.n_heads, self.n_heads,
                            causal=False)

    def encoder_cfg(self) -> "ModelConfig":
        """The encoder's blocks as a stack of ``attn_mlp`` of its widths."""
        e = self.encoder
        return dataclasses.replace(
            self, n_layers=e.n_layers, d_model=e.d_model, n_heads=e.n_heads,
            n_kv_heads=e.n_heads, d_ff=e.d_ff, block_pattern=("attn_mlp",),
            mrope_sections=None)


def stored_dtype(cfg: ModelConfig, path: tuple, trainable: bool = False):
    """The dtype the port stores a parameter in, by its path of names.  In
    the training layout, ``cfg.param_dtype``.  In the serving layout: fp32
    for norm parameters (``ln*``, ``final_ln``, ``enc_ln``) and ``A_log``,
    which the reference reads without a cast; ``activ_dtype`` for the rest,
    which the reference casts to it on every use."""
    if trainable:
        return cfg.param_dtype
    if path[0] in ("final_ln", "enc_ln") or any(
            k.startswith("ln") for k in path[:-1]) or path[-1] == "A_log":
        return torch.float32
    return cfg.activ_dtype


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------

def _as_module(tree: dict, trainable: bool) -> nn.Module:
    """A nested dict of tensors as ``ModuleDict`` / ``ParameterDict``s of
    parameters, trainable or frozen (layers read them as ``p["w"]``, as
    from a dict)."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=trainable)
                                 for k, v in tree.items()})
    return nn.ModuleDict({k: _as_module(v, trainable)
                          for k, v in tree.items()})


def _tree(module: nn.Module) -> dict:
    """The inverse of :func:`_as_module`: nested dicts of the parameters."""
    if isinstance(module, nn.ParameterDict):
        return dict(module.items())
    return {k: _tree(v) for k, v in module.items()}


class LM(nn.Module):
    """Decoder stack: ``embed`` [V, d], ``blocks[l]`` (by kind: ``ln1``,
    ``attn`` with ``q``/``k``/``v``/``o`` dense weights ``[d_in, d_out]``,
    ``lnx``/``xattn``, ``mamba``, ``mlstm``, ``slstm``, ``ln2``, ``mlp`` or
    ``moe``), ``final_ln``, ``lm_head`` [d, V] (None when tied) and, with an
    encoder, ``enc_blocks`` / ``enc_ln`` / ``enc_pos`` [n_frames, d].  The
    tensors are taken as they are; ``trainable`` says whether the
    parameters require grad (the training layout) or are frozen."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor, blocks: list,
                 final_ln: dict, lm_head: torch.Tensor | None,
                 encoder: dict | None = None, trainable: bool = False):
        super().__init__()
        if len(blocks) != cfg.n_layers:
            raise ValueError(f"{len(blocks)} blocks for {cfg.n_layers} layers")
        if (encoder is None) != (cfg.encoder is None):
            raise ValueError(f"{cfg.name}: the encoder's parameters must be "
                             "given exactly when the config has an encoder")
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=trainable)
        self.blocks = nn.ModuleList(_as_module(b, trainable) for b in blocks)
        self.final_ln = _as_module(final_ln, trainable)
        self.lm_head = (None if lm_head is None
                        else nn.Parameter(lm_head, requires_grad=trainable))
        self.enc_blocks = self.enc_ln = self.enc_pos = None
        if encoder is not None:
            self.enc_blocks = nn.ModuleList(_as_module(b, trainable)
                                            for b in encoder["blocks"])
            self.enc_ln = _as_module(encoder["ln"], trainable)
            self.enc_pos = nn.Parameter(encoder["pos"],
                                        requires_grad=trainable)

    @property
    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def tree(self) -> dict:
        """The parameters as :class:`LM`'s arguments: ``embed``,
        ``blocks`` (a list over layers of nested dicts), ``final_ln``,
        ``lm_head`` (None when tied), ``encoder`` (None without one)."""
        encoder = None
        if self.enc_blocks is not None:
            encoder = {"blocks": [_tree(b) for b in self.enc_blocks],
                       "ln": _tree(self.enc_ln), "pos": self.enc_pos}
        return {"embed": self.embed,
                "blocks": [_tree(b) for b in self.blocks],
                "final_ln": _tree(self.final_ln), "lm_head": self.lm_head,
                "encoder": encoder}


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

class _Draw:
    """Makes parameter leaves as the reference's init does, in fp32 on
    ``device``: ``draw(shape, scale)`` a normal times ``scale``;
    ``draw(shape, None, fill=c)`` a constant; ``fill`` a function of a
    uniform [0, 1) draw (``uniform=True``) or of an empty tensor on the
    device, for computed leaves.  On the ``meta`` device nothing is drawn
    or allocated."""

    def __init__(self, generator, device: torch.device):
        self.gen, self.device = generator, device

    def __call__(self, shape, scale, fill=None, uniform: bool = False):
        shape = tuple(shape)
        if self.device.type == "meta":
            return torch.empty(shape, dtype=torch.float32, device="meta")
        if scale is not None:
            return torch.randn(shape, generator=self.gen, device=self.device,
                               dtype=torch.float32) * scale
        if callable(fill):
            base = (torch.rand(shape, generator=self.gen, device=self.device)
                    if uniform else torch.empty(shape, device=self.device))
            return fill(base).float()
        return torch.full(shape, float(fill), dtype=torch.float32,
                          device=self.device)


def _norm_init(cfg: ModelConfig, d: int, device):
    return (L.init_rmsnorm(d, device) if cfg.norm == "rmsnorm"
            else L.init_layernorm(d, device))


def _init_block(draw, kind: str, cfg: ModelConfig) -> dict:
    dev = draw.device
    p = {"ln1": _norm_init(cfg, cfg.d_model, dev)}
    if kind.startswith("attn"):
        p["attn"] = L.init_attention(draw, cfg.attn_cfg())
        if "cross" in kind:
            p["lnx"] = _norm_init(cfg, cfg.d_model, dev)
            p["xattn"] = L.init_attention(draw, cfg.xattn_cfg())
    elif kind.startswith("mamba"):
        p["mamba"] = Mb.init_mamba(draw, cfg.mamba)
    elif kind == "mlstm":
        p["mlstm"] = Xl.init_mlstm(draw, cfg.xlstm)
        return p  # xLSTM blocks have no separate MLP
    elif kind == "slstm":
        p["slstm"] = Xl.init_slstm(draw, cfg.xlstm)
        return p
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    p["ln2"] = _norm_init(cfg, cfg.d_model, dev)
    if kind.endswith("moe"):
        p["moe"] = Moe.init_moe(draw, cfg.moe)
    elif cfg.mlp_kind == "swiglu":
        p["mlp"] = L.init_swiglu(draw, cfg.d_model, cfg.d_ff)
    else:
        p["mlp"] = L.init_gelu_mlp(draw, cfg.d_model, cfg.d_ff)
    return p


def _norm_logical(cfg: ModelConfig) -> dict:
    return (L.rmsnorm_logical() if cfg.norm == "rmsnorm"
            else L.layernorm_logical())


def _block_logical(kind: str, cfg: ModelConfig) -> dict:
    """The reference's logical axes of one block's leaves (unstacked)."""
    lg = {"ln1": _norm_logical(cfg)}
    if kind.startswith("attn"):
        lg["attn"] = L.attention_logical(cfg.attn_cfg())
        if "cross" in kind:
            lg["lnx"] = _norm_logical(cfg)
            lg["xattn"] = L.attention_logical(cfg.xattn_cfg())
    elif kind.startswith("mamba"):
        lg["mamba"] = Mb.mamba_logical()
    elif kind in ("mlstm", "slstm"):
        lg[kind] = Xl.mlstm_logical() if kind == "mlstm" else Xl.slstm_logical()
        return lg
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    lg["ln2"] = _norm_logical(cfg)
    if kind.endswith("moe"):
        lg["moe"] = Moe.moe_logical()
    elif cfg.mlp_kind == "swiglu":
        lg["mlp"] = L.swiglu_logical()
    else:
        lg["mlp"] = L.gelu_mlp_logical()
    return lg


def _stacked(tree):
    """Every logical tuple of ``tree`` with the ``("layers",)`` prefix of a
    leaf stacked over periods."""
    if isinstance(tree, dict):
        return {k: _stacked(v) for k, v in tree.items()}
    return ("layers",) + tree


def param_logical(cfg: ModelConfig) -> dict:
    """The reference's logical-axes tree (``repro.nn.transformer.init``'s
    second result): ``embed``, ``lm_head`` (untied), ``final_ln``,
    ``blocks`` (a list over the pattern's positions, each leaf prefixed by
    ``"layers"``, the axis the reference stacks periods on) and, with an
    encoder, ``enc_blocks`` (a one-entry list), ``enc_ln`` and ``enc_pos``.
    The port keeps one block a layer; :func:`leaf_logical` gives each of
    its parameters its entry."""
    lg = {"embed": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        lg["lm_head"] = ("embed", "vocab")
    lg["final_ln"] = _norm_logical(cfg)
    lg["blocks"] = [_stacked(_block_logical(k, cfg)) for k in cfg.block_pattern]
    if cfg.encoder is not None:
        lg["enc_blocks"] = [_stacked(_block_logical("attn_mlp",
                                                    cfg.encoder_cfg()))]
        lg["enc_ln"] = _norm_logical(cfg)
        lg["enc_pos"] = ("seq", "embed_act")
    return lg


def leaf_logical(cfg: ModelConfig) -> dict:
    """``{parameter name of the LM: logical axes}``: the entry of
    :func:`param_logical` for each of the port's per-layer leaves, without
    the ``"layers"`` axis (a port block is one layer, not a stack)."""
    lg = param_logical(cfg)
    out = {}

    def walk(prefix: str, tree, strip: bool):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(f"{prefix}.{k}" if prefix else k, v, strip)
        else:
            out[prefix] = tree[1:] if strip else tree

    for name in ("embed", "lm_head", "final_ln", "enc_ln", "enc_pos"):
        if name in lg:
            walk(name, lg[name], False)
    for i in range(cfg.n_layers):
        walk(f"blocks.{i}", lg["blocks"][i % cfg.period], True)
    if cfg.encoder is not None:
        for i in range(cfg.encoder.n_layers):
            walk(f"enc_blocks.{i}", lg["enc_blocks"][0], True)
    return out


def replace_params(model: "LM", make, requires_grad: bool | None = None
                   ) -> "LM":
    """Replace every parameter of ``model`` in place by ``make(name, p,
    logical)`` (its :func:`leaf_logical` entry), requiring grad as
    ``requires_grad`` says (as before when None)."""
    logical = leaf_logical(model.cfg)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        grad = p.requires_grad if requires_grad is None else requires_grad
        setattr(mod, leaf, nn.Parameter(make(name, p, logical[name]),
                                        requires_grad=grad))
    return model


def distribute(model: "LM", mesh, rules: dict | None = None) -> "LM":
    """Put every parameter of ``model`` onto ``mesh`` (a ``DeviceMesh``) as
    a DTensor placed by its logical axes (:func:`leaf_logical`, the rules'
    ``spec_for``, mesh axes that do not divide a dim left out), in place.
    Every rank calls it with the same values (``distribute_tensor``).  Run
    the model under ``nn.common.sharding_ctx(mesh, rules)``."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.nn.common import (DEFAULT_RULES, placements, sanitize,
                                       spec_for)

    rules = rules or DEFAULT_RULES

    def make(name, p, lg):
        spec = sanitize(spec_for(lg, mesh, rules), p.shape, mesh)
        return distribute_tensor(p.detach(), mesh, placements(spec, mesh))

    return replace_params(model, make)


def cast_tree(cfg: ModelConfig, tree, path: tuple = (),
              trainable: bool = False):
    """``tree`` (a tensor, None, or nested dicts of them at ``path``) with
    every leaf detached and copied into its :func:`stored_dtype`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: cast_tree(cfg, v, path + (k,), trainable)
                for k, v in tree.items()}
    return tree.detach().to(stored_dtype(cfg, path, trainable), copy=True)


def init(cfg: ModelConfig, generator=0, device=DEFAULT_DEVICE,
         trainable: bool = False) -> LM:
    """Random weights as the reference draws them (normal, times
    ``d_in ** -0.5`` for dense weights and ``d_model ** -0.5`` for the
    embedding and head; the reference's constants for biases, norms and
    Mamba's and xLSTM's gates), on ``device``, in the serving layout or,
    with ``trainable=True``, the training layout.

    An int ``generator`` seeds a generator ON ``device``, so a full-width
    model is drawn on the card in seconds rather than on the CPU in
    minutes; the numbers therefore differ between a CPU and a CUDA model of
    one seed.  A ``torch.Generator`` draws on its own device.  ``device=
    "meta"`` builds the shapes and dtypes only (:func:`abstract_init`).
    Parity with the reference goes through
    :func:`repro_torch.convert.lm_params_from_reference`, not through this
    function.
    """
    dev = torch.device("meta") if str(device) == "meta" else resolve(device)
    gen = None
    if dev.type != "meta":
        gen = (generator if isinstance(generator, torch.Generator)
               else torch.Generator(device=dev).manual_seed(int(generator)))
    draw = _Draw(gen, dev if gen is None else gen.device)
    cast = functools.partial(cast_tree, cfg, trainable=trainable)
    scale = cfg.d_model ** -0.5
    embed = cast(draw((cfg.vocab, cfg.d_model), scale), ("embed",))
    head = None
    if not cfg.tie_embeddings:
        head = cast(draw((cfg.d_model, cfg.vocab), scale), ("lm_head",))
    blocks = [cast(_init_block(draw, cfg.kind(i), cfg))
              for i in range(cfg.n_layers)]
    encoder = None
    if cfg.encoder is not None:
        e, ecfg = cfg.encoder, cfg.encoder_cfg()
        encoder = {
            "blocks": [cast(_init_block(draw, "attn_mlp", ecfg))
                       for _ in range(e.n_layers)],
            "ln": cast(_norm_init(cfg, e.d_model, draw.device), ("enc_ln",)),
            "pos": cast(draw((e.n_frames, e.d_model), 0.01), ("enc_pos",))}
    final_ln = cast(_norm_init(cfg, cfg.d_model, draw.device), ("final_ln",))
    model = LM(cfg, embed, blocks, final_ln, head, encoder, trainable)
    return model.to(dev)


def serving_copy(model: LM) -> LM:
    """A frozen copy of ``model`` in the serving layout: every leaf cast to
    its :func:`stored_dtype` (bf16 matmul weights at the default
    ``activ_dtype``) in new storage, so training the original on does not
    move it.  Equal to :func:`repro_torch.convert.lm_params_from_reference`
    of the same fp32 parameters."""
    cast = functools.partial(cast_tree, model.cfg)
    t = model.tree()
    encoder = t["encoder"] and {
        "blocks": [cast(b) for b in t["encoder"]["blocks"]],
        "ln": cast(t["encoder"]["ln"], ("enc_ln",)),
        "pos": cast(t["encoder"]["pos"], ("enc_pos",))}
    return LM(model.cfg, cast(t["embed"], ("embed",)),
              [cast(b) for b in t["blocks"]],
              cast(t["final_ln"], ("final_ln",)),
              cast(t["lm_head"], ("lm_head",)), encoder)


def param_count(model: LM) -> int:
    return sum(p.numel() for p in model.parameters())


def abstract_init(cfg: ModelConfig, trainable: bool = False) -> LM:
    """The model's parameters as ``meta`` tensors: every shape and stored
    dtype, in the serving or the training layout, nothing allocated (the
    398 B config builds at once).  The reference returns its logical axes
    with its shapes; here they are :func:`param_logical` (the reference's
    tree) and :func:`leaf_logical` (per parameter name)."""
    return init(cfg, device="meta", trainable=trainable)


def count_params_cfg(cfg: ModelConfig) -> tuple:
    """(total params, active-per-token params) from shapes alone, as the
    reference counts them: active leaves out (E - top_k) / E of the expert
    weights (``moe`` ``gate``/``up``/``down``)."""
    total = moe_total = 0
    for name, leaf in abstract_init(cfg).named_parameters():
        total += leaf.numel()
        parts = name.split(".")
        if "moe" in parts and parts[-1] in ("gate", "up", "down"):
            moe_total += leaf.numel()
    active = total - moe_total
    if cfg.moe is not None and moe_total:
        active += moe_total * cfg.moe.top_k / cfg.moe.num_experts
    return int(total), int(active)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """The block's norm.  Under a mesh its output is constrained to the
    ``seq`` rule: the residual's Megatron-SP split of the sequence
    (``seq_res``) is gathered here, where the tensor-parallel products
    start, as Megatron-SP does.  DTensor cannot feed a product a tensor
    split on both batch and sequence (it flattens them), which GSPMD
    can."""
    h = L.rmsnorm(p, x) if cfg.norm == "rmsnorm" else L.layernorm(p, x)
    return shard(h, "batch", "seq", "embed_act")


def _embed(model: LM, cfg: ModelConfig, tokens: torch.Tensor,
           vision_embeds=None) -> torch.Tensor:
    # the table's FSDP split of `embed` is gathered before the lookup (a
    # no-op without a mesh): DTensor's vocab-split lookup mis-masks a table
    # split on both dims
    table = shard(model.embed, "vocab", "embed_act")
    emb = F.embedding(tokens.long(), table).to(cfg.activ_dtype)
    if cfg.vision_patches and vision_embeds is not None:
        # under a mesh the vocab-split lookup is reduced before the concat:
        # DTensor cannot slice its masked partial sum of fake tensors
        emb = shard(emb, "batch", "seq", "embed_act")
        P = cfg.vision_patches
        emb = torch.cat([vision_embeds.to(cfg.activ_dtype), emb[:, P:]], 1)
    return shard(emb, "batch", "seq", "embed_act")


def _cross_attention(p, cfg: ModelConfig, x: torch.Tensor,
                     enc_out: torch.Tensor) -> torch.Tensor:
    """``x + xattn(lnx(x), enc_out)``: queries from the decoder, K/V from
    the encoder output (recomputed on every call, decode steps included)."""
    h = _norm(cfg, p["lnx"], x)
    xcfg = cfg.xattn_cfg()
    q = split_heads(L.dense(p["xattn"]["q"], h), cfg.n_heads, xcfg.dh)
    k = split_heads(L.dense(p["xattn"]["k"], enc_out), cfg.n_heads, xcfg.dh)
    v = split_heads(L.dense(p["xattn"]["v"], enc_out), cfg.n_heads, xcfg.dh)
    o = L.sharded_flash_attention(q, k, v, causal=False, block=512)
    # constrained as self-attention's output is (a no-op without a mesh):
    # its gradient then reaches the output projection split by rows only
    return x + shard(L.dense(p["xattn"]["o"], merge_heads(o)),
                     "batch", "seq", "embed_act")


def _ffn_half(p, kind: str, cfg: ModelConfig, x: torch.Tensor,
              valid=None) -> tuple:
    """``(x + ffn(ln2(x)), aux)``: the MLP, or the MoE with its aux terms.
    ``valid`` (the serving entries': the tokens a dropless MoE routes; None
    for all) also leaves out a dropless MoE's loss terms."""
    h = _norm(cfg, p["ln2"], x)
    if kind.endswith("moe") and cfg.moe_dropless:
        m, aux = Moe.moe_dropless(p["moe"], h, cfg.moe, valid,
                                  losses=valid is None)
        return x + m, aux
    if kind.endswith("moe"):
        m, aux = Moe.moe(p["moe"], h, cfg.moe)
        return x + m, aux
    if cfg.mlp_kind == "swiglu":
        return x + L.swiglu(p["mlp"], h), {}
    return x + L.gelu_mlp(p["mlp"], h), {}


def _apply_block(p, kind: str, cfg: ModelConfig, x: torch.Tensor,
                 positions, enc_out, layer: int = 0) -> tuple:
    """One block (layer ``layer``) over a full sequence.  Returns (x,
    aux)."""
    h = _norm(cfg, p["ln1"], x)
    if kind.startswith("attn"):
        x = x + L.attention(p["attn"], h, cfg.attn_cfg(layer=layer),
                            positions)
        if "cross" in kind:
            x = _cross_attention(p, cfg, x, enc_out)
    elif kind.startswith("mamba"):
        x = x + Mb.mamba(p["mamba"], h, cfg.mamba)[0]
    elif kind == "mlstm":
        return x + Xl.mlstm(p["mlstm"], h, cfg.xlstm)[0], {}
    elif kind == "slstm":
        return x + Xl.slstm(p["slstm"], h, cfg.xlstm)[0], {}
    return _ffn_half(p, kind, cfg, x)


def _logits(model: LM, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = _norm(cfg, model.final_ln, x)
    return shard((x @ model.head.to(cfg.activ_dtype)).float(),
                 "batch", "seq", "vocab")


# ---------------------------------------------------------------------------
# Forward (full sequence)
# ---------------------------------------------------------------------------

def _encoder_forward(model: LM, cfg: ModelConfig, frames: torch.Tensor):
    """Encoder frames [B, n_frames, d] -> encoder output, through causal
    ``attn_mlp`` blocks without positions, as the reference's."""
    x = frames.to(cfg.activ_dtype) + model.enc_pos.to(cfg.activ_dtype)
    ecfg = cfg.encoder_cfg()
    for bp in model.enc_blocks:
        x, _ = _apply_block(bp, "attn_mlp", ecfg, x, None, None)
    return _norm(cfg, model.enc_ln, x)


def _period(model: LM, cfg: ModelConfig, p0: int, x: torch.Tensor,
            positions, enc_out) -> tuple:
    """The layers of the period starting at layer ``p0``: (x, summed aux)."""
    auxes: dict = {}
    for i in range(p0, p0 + cfg.period):
        x, aux = _apply_block(model.blocks[i], cfg.kind(i), cfg, x,
                              positions, enc_out, i)
        aux.pop("expert_counts", None)  # a serving counter, not a loss term
        for k, v in aux.items():
            auxes[k] = auxes.get(k, 0.0) + v
    # Megatron-SP: the remat-saved period boundary is sharded over `model`
    # along the sequence, cutting saved-activation memory by the TP degree.
    if x.shape[1] > 1:
        x = shard(x, "batch", "seq_res", "embed_act")
    return x, auxes


def _save_matmuls(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the outputs of 2-D matmuls (every ``x @ w``), recompute the rest
    (batched products such as attention's and the experts' included)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)`` under the reference's remat of a period: ``"full"``
    saves the period's inputs only and recomputes the rest in the backward
    pass; any other policy also keeps the matmul outputs."""
    kw = {}
    if cfg.remat_policy != "full":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_matmuls)
    return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)


def forward(model: LM, cfg: ModelConfig, tokens: torch.Tensor,
            positions=None, vision_embeds=None, encoder_frames=None) -> tuple:
    """tokens [B, S] -> (logits [B, S, vocab] fp32, aux).  ``positions``
    [B, S] default to 0..S-1 (M-RoPE stacks need [B, 3, S]);
    ``vision_embeds`` [B, P, d] replace the first P token embeddings;
    ``encoder_frames`` [B, n_frames, d] feed the encoder.  ``aux`` sums the
    MoE layers' ``load_balance``, ``router_z`` and ``dropped_frac`` (per
    period, then over periods, as the reference's scan does; 0.0 without
    MoE).  Differentiable; with ``cfg.remat`` and a graph to build, each
    period is checkpointed (:func:`_remat`), which moves no number."""
    B, S = tokens.shape
    x = _embed(model, cfg, tokens, vision_embeds)
    if positions is None and cfg.mrope_sections is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    enc_out = (_encoder_forward(model, cfg, encoder_frames)
               if cfg.encoder is not None else None)
    remat = cfg.remat and L.recording(*model.parameters())
    aux_acc = {"load_balance": 0.0, "router_z": 0.0, "dropped_frac": 0.0}
    per_period: dict = {}
    for p0 in range(0, cfg.n_layers, cfg.period):
        args = (model, cfg, p0, x, positions, enc_out)
        x, auxes = _remat(cfg, _period, *args) if remat else _period(*args)
        for k, v in auxes.items():
            per_period.setdefault(k, []).append(v)
    for k, vs in per_period.items():
        aux_acc[k] = torch.stack(vs).sum()
    return _logits(model, cfg, x), aux_acc


def loss_fn(model: LM, cfg: ModelConfig, batch: dict) -> tuple:
    """Next-token CE.  batch: ``tokens`` [B, S] (+ ``positions``,
    ``vision_embeds``, ``encoder_frames``, ``loss_mask`` [B, S]).  Returns
    (total = ce + 0.01 load_balance + router_z, {"ce", aux...})."""
    logits, aux = forward(model, cfg, batch["tokens"],
                          positions=batch.get("positions"),
                          vision_embeds=batch.get("vision_embeds"),
                          encoder_frames=batch.get("encoder_frames"))
    targets = batch["tokens"][:, 1:].long()
    lg = logits[:, :-1]
    lse = torch.logsumexp(lg, -1)
    if current_mesh() is None:
        target_logit = torch.gather(lg, -1, targets[..., None])[..., 0]
    else:
        # CE without gathering along the vocab-sharded axis, as the
        # reference: the one-hot contraction keeps the logits vocab-sharded
        # (one term is nonzero, so the same number as the gather)
        onehot = (targets[..., None] == torch.arange(
            cfg.vocab, device=lg.device)).to(lg.dtype)
        onehot = shard(onehot, "batch", "seq", "vocab")
        target_logit = torch.einsum("bsv,bsv->bs", lg, onehot)
    nll = lse - target_logit
    mask = batch.get("loss_mask")
    mask = (mask[:, 1:].to(nll.dtype) if mask is not None
            else torch.ones_like(nll))
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    total = loss + 0.01 * aux["load_balance"] + aux["router_z"]
    return total, {"ce": loss, **aux}


# ---------------------------------------------------------------------------
# Decode (contiguous caches)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=DEFAULT_DEVICE) -> list:
    """Caches mirroring the reference's: a list over the pattern's
    positions, each ``{"self": KV cache}`` (``k``/``v`` [P, batch, max_len,
    G, dh], scales when int8, ``len`` [P, batch]), ``{"mamba": {conv, ssm}}``,
    ``{"mlstm": {C, n, m}}`` or ``{"slstm": {c, n, m, h}}``, every leaf
    stacked over the P periods.  Layer ``i`` is period ``i // period`` of
    position ``i % period``."""
    dev = resolve(device)
    if cfg.kv_cache_dtype == "int8":
        dtype = torch.int8
    per = []
    for kind in cfg.block_pattern:
        if kind.startswith("attn"):
            c = {"self": L.init_kv_cache(batch, max_len, cfg.attn_cfg(),
                                         dtype, dev)}
        elif kind.startswith("mamba"):
            # the conv window in the type a step leaves it in (the
            # reference's state is promoted to it by its first step)
            c = {"mamba": Mb.init_mamba_state(
                batch, cfg.mamba, torch.promote_types(dtype, cfg.activ_dtype),
                dev)}
        elif kind == "mlstm":
            c = {"mlstm": Xl.init_mlstm_state(batch, cfg.xlstm, dev)}
        else:
            c = {"slstm": Xl.init_slstm_state(batch, cfg.xlstm, dev)}
        per.append({name: {k: v[None].repeat((cfg.n_periods,)
                                             + (1,) * v.dim())
                           for k, v in leaves.items()}
                    for name, leaves in c.items()})
    return per


def cache_logical(cfg: ModelConfig) -> list:
    """Logical axes of the cache tree, as the reference names them (the
    port shards nothing; kept for the dry-run tables)."""
    per = []
    for kind in cfg.block_pattern:
        if kind.startswith("attn"):
            kv = {"k": ("layers", "batch", "seq", "kv_heads", None),
                  "v": ("layers", "batch", "seq", "kv_heads", None),
                  "len": ("layers", "batch")}
            if cfg.kv_cache_dtype == "int8":
                kv["k_scale"] = ("layers", "batch", "seq", "kv_heads", None)
                kv["v_scale"] = ("layers", "batch", "seq", "kv_heads", None)
            per.append({"self": kv})
        elif kind.startswith("mamba"):
            per.append({"mamba": {"conv": ("layers", "batch", None, "mlp"),
                                  "ssm": ("layers", "batch", "mlp", None)}})
        elif kind == "mlstm":
            per.append({"mlstm": {"C": ("layers", "batch", "heads", None, None),
                                  "n": ("layers", "batch", "heads", None),
                                  "m": ("layers", "batch", "heads")}})
        else:
            per.append({"slstm": {k: ("layers", "batch", "mlp") for k in
                                  ("c", "n", "m", "h")}})
    return per


def layer_cache(cache: list, cfg: ModelConfig, layer: int) -> dict:
    """Layer ``layer``'s caches: views into the stacked leaves, written in
    place."""
    period, bi = divmod(layer, cfg.period)
    return {name: {k: v[period] for k, v in leaves.items()}
            for name, leaves in cache[bi].items()}


def _merge_state(dst: dict, new: dict, active) -> None:
    """Write ``new`` into the state ``dst`` in place, on the ``active`` rows
    only (None = every row): the reference's masked merge."""
    for k, t in dst.items():
        n = new[k].to(t.dtype)
        if active is not None:
            n = torch.where(active.reshape((-1,) + (1,) * (t.dim() - 1)), n,
                            t)
        t.copy_(n)


def _first_len(cache: list, cfg: ModelConfig, batch: int, device):
    """Each row's position: the KV length of the first attention layer, or
    zeros for stacks without attention (their positions are unused)."""
    for bi, kind in enumerate(cfg.block_pattern):
        if kind.startswith("attn"):
            return cache[bi]["self"]["len"][0].clone()
    return torch.zeros((batch,), dtype=torch.int32, device=device)


def _decode_block(p, kind: str, cfg: ModelConfig, x, positions, enc_out,
                  lc: dict, active, layer: int = 0) -> torch.Tensor:
    h = _norm(cfg, p["ln1"], x)
    if kind.startswith("attn"):
        a, _ = L.attention_decode(p["attn"], h, lc["self"],
                                  cfg.attn_cfg(layer=layer), positions,
                                  active)
        x = x + a
        if "cross" in kind:
            x = _cross_attention(p, cfg, x, enc_out)
    elif kind.startswith("mamba"):
        m, st = Mb.mamba(p["mamba"], h, cfg.mamba, lc["mamba"])
        _merge_state(lc["mamba"], st, active)
        x = x + m
    else:  # mlstm / slstm
        fn = Xl.mlstm if kind == "mlstm" else Xl.slstm
        m, st = fn(p[kind], h, cfg.xlstm, lc[kind])
        _merge_state(lc[kind], st, active)
        return x + m
    return _ffn_half(p, kind, cfg, x)[0]


@torch.no_grad()
def decode_step(model: LM, cfg: ModelConfig, cache: list,
                tokens: torch.Tensor, active=None, positions=None,
                enc_out=None) -> tuple:
    """One decode step. tokens [B, 1] -> (logits [B, 1, vocab] fp32, cache).

    Each row's position defaults to its current KV length (M-RoPE stacks
    need explicit ``positions`` [B, 3, 1]; encoder-decoder stacks need
    ``enc_out``).  Every row is computed as the reference computes it; the
    caches are then written in place on the ``active`` rows ([B] bool; None
    = all) only, so the other rows keep their state and length (the
    reference's masked merge)."""
    B = tokens.shape[0]
    x = _embed(model, cfg, tokens)
    if positions is None and cfg.mrope_sections is None:
        positions = _first_len(cache, cfg, B, x.device)[:, None].expand(
            tokens.shape)
    for i, blk in enumerate(model.blocks):
        x = _decode_block(blk, cfg.kind(i), cfg, x, positions, enc_out,
                          layer_cache(cache, cfg, i), active, i)
    return _logits(model, cfg, x), cache
