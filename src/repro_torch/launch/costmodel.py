"""Analytic FLOP / HBM-byte model per (arch x shape).

The port of ``repro/launch/costmodel.py``: the reference's arithmetic over
the port's ``ModelConfig``, term for term in the same order, so the floats
are the reference's bit for bit.  Why analytic: the reference's XLA cost
analysis reports a loop body once, whatever its trip count; the port's
eager counter (:func:`repro_torch.compat.cost_analysis`) sees every
iteration but counts what the code runs (flash attention's masked causal
blocks, norms), not the model's work.  ``tests/test_torch_costmodel.py``
holds the two against each other per block kind.

All counts are *global* (whole step, all chips).  Conventions: one MAC = 2
FLOPs; causal attention scores cost half of the full S^2 rectangle; train =
3x forward (activation + two grad matmuls per dot) + 1x forward recompute
when remat policy is 'full'.
"""
from __future__ import annotations

import dataclasses

from repro_torch.nn.transformer import ModelConfig


@dataclasses.dataclass
class StepCost:
    flops: float
    hbm_bytes: float  # param + activation + cache traffic, bf16/fp32 weighted


def _attn_flops(cfg: ModelConfig, B: int, Sq: int, Skv: int, causal: bool) -> float:
    dh = cfg.dh if hasattr(cfg, "dh") else (cfg.head_dim or cfg.d_model // cfg.n_heads)
    proj = 2 * B * Sq * cfg.d_model * (2 * cfg.n_heads * dh + 2 * cfg.n_kv_heads * dh)
    sc = 2 * B * Sq * Skv * cfg.n_heads * dh * 2  # scores + AV
    if causal and Sq == Skv:
        sc *= 0.5
    return proj + sc


def _mlp_flops(cfg: ModelConfig, B: int, S: int) -> float:
    mult = 3 if cfg.mlp_kind == "swiglu" else 2
    return 2 * B * S * cfg.d_model * cfg.d_ff * mult


def _moe_flops(cfg: ModelConfig, B: int, S: int) -> float:
    m = cfg.moe
    return (2 * B * S * cfg.d_model * m.num_experts  # router
            + 2 * B * S * cfg.d_model * m.d_ff * 3 * m.top_k)


def _mamba_flops(cfg: ModelConfig, B: int, S: int) -> float:
    m = cfg.mamba
    di, N, R = m.d_inner, m.d_state, m.rank
    return (2 * B * S * cfg.d_model * 2 * di  # in_proj
            + 2 * B * S * di * m.d_conv  # conv
            + 2 * B * S * di * (R + 2 * N)  # x_proj
            + 2 * B * S * R * di  # dt_proj
            + 8 * B * S * di * N  # selective scan + C*h
            + 2 * B * S * di * cfg.d_model)  # out_proj


def _mlstm_flops(cfg: ModelConfig, B: int, S: int) -> float:
    x = cfg.xlstm
    di, H, dh = x.d_inner, x.n_heads, x.dh
    return (2 * B * S * cfg.d_model * 2 * di  # up
            + 3 * 2 * B * S * di * di  # q, k, v
            + 2 * B * S * di * di  # o gate
            + 8 * B * S * H * dh * dh  # state update + read
            + 2 * B * S * di * cfg.d_model)  # down


def _slstm_flops(cfg: ModelConfig, B: int, S: int) -> float:
    d = cfg.d_model
    return 2 * B * S * d * 4 * d * 2 + 2 * B * S * d * 2 * d * 2


def forward_flops(cfg: ModelConfig, B: int, Sq: int, Skv: int | None = None,
                  decode: bool = False) -> float:
    """One forward pass; for decode Sq=1 and Skv = cache length."""
    Skv = Skv or Sq
    total = 0.0
    for li in range(cfg.n_layers):
        kind = cfg.block_pattern[li % cfg.period]
        if kind.startswith("attn"):
            total += _attn_flops(cfg, B, Sq, Skv, causal=not decode)
            if "cross" in kind and cfg.encoder is not None:
                total += _attn_flops(cfg, B, Sq, cfg.encoder.n_frames, causal=False)
        elif kind.startswith("mamba"):
            total += _mamba_flops(cfg, B, Sq)
        elif kind == "mlstm":
            total += _mlstm_flops(cfg, B, Sq)
            continue
        elif kind == "slstm":
            total += _slstm_flops(cfg, B, Sq)
            continue
        if kind.endswith("moe"):
            total += _moe_flops(cfg, B, Sq)
        elif not kind.startswith(("mlstm", "slstm")):
            total += _mlp_flops(cfg, B, Sq)
    total += 2 * B * Sq * cfg.d_model * cfg.vocab  # lm head
    if cfg.encoder is not None and not decode:
        e = cfg.encoder
        enc = dataclasses.replace(
            cfg, n_layers=e.n_layers, d_model=e.d_model, n_heads=e.n_heads,
            n_kv_heads=e.n_heads, d_ff=e.d_ff, block_pattern=("attn_mlp",),
            encoder=None, moe=None, mlp_kind="gelu")
        for _ in range(e.n_layers):
            total += _attn_flops(enc, B, e.n_frames, e.n_frames, causal=False)
            total += _mlp_flops(enc, B, e.n_frames)
    return total


def step_cost(cfg: ModelConfig, n_params: int, kind: str, B: int, S: int,
              param_bytes: int = 4, act_bytes: int = 2) -> StepCost:
    """Whole-step FLOPs + HBM traffic for train / prefill / decode."""
    if kind == "train":
        fwd = forward_flops(cfg, B, S)
        mult = 4.0 if (cfg.remat and cfg.remat_policy == "full") else 3.0
        flops = mult * fwd
        # params: read fwd + read bwd + grads written + optimizer update r/w
        p_traffic = n_params * param_bytes * 6
        act = 14 * B * S * cfg.d_model * cfg.n_layers * act_bytes
        return StepCost(flops, p_traffic + act)
    if kind == "prefill":
        flops = forward_flops(cfg, B, S)
        return StepCost(flops, n_params * param_bytes
                        + 10 * B * S * cfg.d_model * cfg.n_layers * act_bytes)
    # decode: one token against an S-long cache
    flops = forward_flops(cfg, B, 1, Skv=S, decode=True)
    dh = cfg.head_dim or cfg.d_model // cfg.n_heads
    n_attn = sum(1 for li in range(cfg.n_layers)
                 if cfg.block_pattern[li % cfg.period].startswith("attn"))
    cache_bytes = 1 + 4.0 / dh if cfg.kv_cache_dtype == "int8" else act_bytes
    cache = B * S * cfg.n_kv_heads * dh * 2 * n_attn * cache_bytes  # read k+v
    return StepCost(flops, n_params * param_bytes + cache)
