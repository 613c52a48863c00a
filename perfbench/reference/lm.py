"""A decoder-only language model of the starcoder2 family in plain PyTorch,
float32, over whole sequences: no cache, no paging, no kernels and no
batching across requests beyond padding a block of them to one length.

Each layer: ``x + attn(ln1(x))`` then ``x + mlp(ln2(x))``, LayerNorm with
scale and bias (eps from the configuration), grouped-query attention (K/V
heads repeated over their query heads) with RoPE (rotate-half, frequencies
``theta ** (-2i / dh)``) at positions 0, 1, ... and a causal mask, and a
tanh-GELU MLP; then the final LayerNorm and the output head.  Biases where
the configuration has them (``qkv_bias``, ``mlp_bias``, ``o_bias``).

The weights are the benchmark's (``systems/lm_serving.py`` draws them),
a dict of tensors in the type they are served in; each layer's are
upcast to float32 as it runs.  Matrix products run in float32 with TF32
off.  :func:`output_logits` is the entry: the logits at the positions that
predicted a request's output tokens, its prompt and output fed whole
(teacher forcing).

Stand-ins, for the control and for planted faults (``PERF.md`` §2):
``fmt`` computes in a lower precision: ``fp8_kv`` and ``int8_kv`` serve K
and V in float8 e4m3 or int8 (one scale a token and head), ``fp8`` also
rounds every matrix product's operands to float8 e4m3 (a weight with one
scale an output column, an activation one a token); ``fault`` breaks one
part: ``rope_shift`` (queries rotated one position ahead of their keys),
``last_block_out`` (the query's own KV block of ``block_size`` positions
left out of its attention), ``skip_layer`` (layer ``n_layers // 2``
skipped) and ``ln_no_bias`` (every LayerNorm without its bias).
"""
from __future__ import annotations

import math

import torch

FORMATS = ("fp8_kv", "int8_kv", "fp8")
FAULTS = ("rope_shift", "last_block_out", "skip_layer", "ln_no_bias")
FP8_MAX = 448.0  # largest finite float8 e4m3fn


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def layernorm(p: dict, x: torch.Tensor, eps: float,
              bias: bool = True) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) / torch.sqrt(var + eps) * p["scale"].float()
    return y + p["bias"].float() if bias else y


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, heads, dh] rotated by position (rotate-half pairing)."""
    dh = x.shape[-1]
    inv = theta ** (-torch.arange(0, dh, 2, dtype=torch.float64,
                                  device=x.device) / dh)
    ang = (positions.double()[:, None] * inv[None]).float()  # [S, dh/2]
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1 + torch.tanh(math.sqrt(2 / math.pi)
                                     * (x + 0.044715 * x ** 3)))


def rounded(t: torch.Tensor, fmt: str) -> torch.Tensor:
    """float32 ``t`` in ``fmt`` (``fp8`` e4m3 or ``int8``) with one scale
    (``amax / qmax``) for each row of its last dimension, back in
    float32."""
    qmax = FP8_MAX if fmt == "fp8" else 127.0
    scale = t.abs().amax(-1, keepdim=True) / qmax + 1e-12
    if fmt == "fp8":
        return (t / scale).to(torch.float8_e4m3fn).float() * scale
    return torch.clamp(torch.round(t / scale), -127, 127) * scale


def linear(x: torch.Tensor, w: torch.Tensor, b=None,
           fmt: str | None = None) -> torch.Tensor:
    w = w.float()
    if fmt == "fp8":
        x, w = rounded(x, "fp8"), rounded(w.T, "fp8").T
    y = x @ w
    return y if b is None else y + b.float()


def served(t: torch.Tensor, fmt: str | None) -> torch.Tensor:
    """K or V ``[..., dh]`` as a cache served in ``fmt`` holds it
    (``bf16_kv``: rounded to bfloat16, the pool's own type)."""
    if fmt in ("fp8", "fp8_kv"):
        return rounded(t, "fp8")
    if fmt == "bf16_kv":
        return t.to(torch.bfloat16).float()
    return rounded(t, "int8") if fmt == "int8_kv" else t


def attention(blk: dict, h: torch.Tensor, cfg: dict, fmt: str | None,
              fault: str | None) -> torch.Tensor:
    B, S, _ = h.shape
    H, G, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = linear(h, blk["q_w"], blk.get("q_b"), fmt).reshape(B, S, H, dh)
    k = linear(h, blk["k_w"], blk.get("k_b"), fmt).reshape(B, S, G, dh)
    v = linear(h, blk["v_w"], blk.get("v_b"), fmt).reshape(B, S, G, dh)
    pos = torch.arange(S, device=h.device)
    q = rope(q, pos + (1 if fault == "rope_shift" else 0), cfg["rope_theta"])
    k = rope(k, pos, cfg["rope_theta"])
    k, v = served(k, fmt), served(v, fmt)
    rep = H // G
    k = k.repeat_interleave(rep, dim=2)  # KV head g serves q heads g*rep..
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * dh ** -0.5
    qi = torch.arange(S, device=h.device)[:, None]
    ki = torch.arange(S, device=h.device)[None, :]
    allowed = ki <= qi
    if fault == "last_block_out":
        allowed = ki < qi - qi % cfg["block_size"]
    s = s.masked_fill(~allowed, float("-inf"))
    p = torch.softmax(s, -1).nan_to_num(0.0)  # a row with no key reads 0
    o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, H * dh)
    return linear(o, blk["o_w"], blk.get("o_b"), fmt)


def hidden(weights: dict, cfg: dict, tokens: torch.Tensor,
           fmt: str | None = None, fault: str | None = None) -> torch.Tensor:
    """The final LayerNorm's output ``[B, S, d]`` float32 of ``tokens [B,
    S]``; padding at the end of a row does not reach its earlier
    positions (the mask is causal)."""
    eps = cfg["norm_eps"]
    bias = fault != "ln_no_bias"
    x = weights["embed"][tokens].float()
    for i, blk in enumerate(weights["blocks"]):
        if fault == "skip_layer" and i == len(weights["blocks"]) // 2:
            continue
        x = x + attention(blk, layernorm(blk["ln1"], x, eps, bias), cfg, fmt,
                          fault)
        m = layernorm(blk["ln2"], x, eps, bias)
        m = gelu_tanh(linear(m, blk["up_w"], blk.get("up_b"), fmt))
        x = x + linear(m, blk["down_w"], blk.get("down_b"), fmt)
    return layernorm(weights["final_ln"], x, eps, bias)


def output_logits(weights: dict, cfg: dict, prompts: list, outputs: list, *,
                  fmt: str | None = None, fault: str | None = None,
                  block_tokens: int = 8192) -> list:
    """For each request (``prompts[j]``, ``outputs[j]``: int64 token
    tensors on the weights' device), the float32 logits ``[n_out, V]`` at
    the positions that predict its output tokens: position ``P - 1 + t``
    of ``prompt + output[:-1]`` predicts ``output[t]``.  Requests run in
    blocks of at most ``block_tokens`` padded tokens, longest first."""
    no_tf32()
    seqs = [torch.cat([p, o[:-1]]) for p, o in zip(prompts, outputs)]
    order = sorted(range(len(seqs)), key=lambda j: -len(seqs[j]))
    out: list = [None] * len(seqs)
    head = weights["head"]
    dev = head.device
    s = 0
    while s < len(order):
        S = len(seqs[order[s]])
        n = max(1, min(len(order) - s, block_tokens // S))
        block = order[s:s + n]
        toks = torch.zeros((n, S), dtype=torch.int64, device=dev)
        for r, j in enumerate(block):
            toks[r, :len(seqs[j])] = seqs[j]
        with torch.no_grad():
            h = hidden(weights, cfg, toks, fmt, fault)
            rows = [h[r, len(prompts[j]) - 1:len(seqs[j])]
                    for r, j in enumerate(block)]
            logits = linear(torch.cat(rows), head, fmt=fmt)
            for j, part in zip(block, logits.split([len(x) for x in rows])):
                out[j] = part
        s += n
    return out
