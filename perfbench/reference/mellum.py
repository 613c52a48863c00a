"""Mellum2-12B-A2.5B in plain PyTorch, float32, over whole sequences: no
cache, no paging, no kernels.

The configuration is the benchmark's file (``configs/mellum2-12b-a2.5b.json``,
the published ``config.json``'s keys).  Layer l, ``sliding_attention`` or
``full_attention`` as ``layer_types`` says:

    h  = x + W_o Attn_l(RMSNorm_1(x)),    x' = h + MoE(RMSNorm_2(h))

then the final RMSNorm and the untied head; ``RMSNorm(x) = x / sqrt(mean(x^2)
+ eps) g``.  Attention: ``num_attention_heads`` query heads over
``num_key_value_heads`` KV heads of ``head_dim``, no bias, RoPE
(rotate-half) at positions 0, 1, ..., scores ``q . k / sqrt(head_dim)``,
causal; a sliding layer's query i sees key j only if ``i - sliding_window <
j <= i``.  RoPE: a sliding layer's ``inv_freq_i = theta ** (-2i / dh)``; a
full layer's is YaRN's (``rope_parameters["full_attention"]``): ``inv_freq_i
(1 - r_i) + inv_freq_i / factor r_i``, ``r_i = clamp((i - low) / (high -
low), 0, 1)``, ``low = floor(c(beta_fast))``, ``high = ceil(c(beta_slow))``,
``c(n) = dh ln(original / (2 pi n)) / (2 ln theta)``, with cos and sin both
times ``attention_factor``.  MoE: ``p = softmax(W_r x)`` over
``num_experts``, the top ``num_experts_per_tok`` (a tie to the lower
expert), weights ``p_top / sum(p_top)``, ``y = sum_k w_k W_down,k (silu(
W_gate,k x) * W_up,k x)``, no token dropped, no shared expert.  Angles in
float64, cast to float32.

The weights are the benchmark's (``systems/lm_moe_serving.py`` draws them),
in the type they are served in; each layer's are upcast to float32 as it
runs.  Matrix products run in float32 with TF32 off.  Requests are batched
layer by layer: the projections over every token of every request at once,
attention request by request in query blocks over the keys a block can
see, and each expert once a layer over every token routed to it (so a
token's contributions are added in ascending expert order).
:func:`output_logits` is the entry: the logits at the positions that
predicted a request's output tokens, its prompt and output fed whole.

Stand-ins (``PERF.md`` §2): ``fmt`` computes in a lower precision: ``fp8``
rounds every matrix product's operands to float8 e4m3 (a weight with one
scale an output column, an activation one a token) and K and V too;
``fp8_kv`` and ``int8_kv`` round K and V alone (one scale a token and
head); ``bf16_kv`` rounds K and V to the KV pool's bfloat16.  ``fault``
breaks one part: ``skip_layer`` (layer ``n // 2`` skipped),
``rope_shift`` (queries rotated one position ahead of their keys),
``window_off`` (sliding layers see the whole context), ``yarn_off`` (full
layers' plain RoPE at theta, no attention factor) and ``drop_1.25`` (the
dropping MoE of the reference package: each 512-position group of a
request routes at most ``round(512 K 1.25 / E)`` assignments to an expert,
in position order, and drops the rest).
"""
from __future__ import annotations

import math

import torch

from perfbench.reference.lm import no_tf32, rounded

FORMATS = ("fp8_kv", "int8_kv", "fp8")
FAULTS = ("skip_layer", "rope_shift", "window_off", "yarn_off", "drop_1.25")
DROP_GROUP = 512  # positions a routing group of the dropping MoE holds


def rmsnorm(g: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    return x / torch.sqrt(x.square().mean(-1, keepdim=True) + eps) * g.float()


def linear(x: torch.Tensor, w: torch.Tensor, fmt: str | None) -> torch.Tensor:
    w = w.float()
    if fmt == "fp8":
        x, w = rounded(x, "fp8"), rounded(w.T, "fp8").T
    return x @ w


def served(t: torch.Tensor, fmt: str | None) -> torch.Tensor:
    if fmt in ("fp8", "fp8_kv"):
        return rounded(t, "fp8")
    if fmt == "int8_kv":
        return rounded(t, "int8")
    return t.to(torch.bfloat16).float() if fmt == "bf16_kv" else t


def inv_freq(dh: int, rope: dict) -> tuple:
    """``(inv_freq [dh / 2] float64, attention factor)`` of one layer type's
    ``rope_parameters``."""
    theta = float(rope["rope_theta"])
    inv = theta ** (-torch.arange(0, dh, 2, dtype=torch.float64) / dh)
    if rope.get("rope_type", "default") == "default":
        return inv, 1.0
    if rope["rope_type"] != "yarn":
        raise ValueError(f"rope_type {rope['rope_type']!r}")
    factor = float(rope["factor"])
    orig = rope["original_max_position_embeddings"]

    def c(n):
        return dh * math.log(orig / (2 * math.pi * n)) / (2 * math.log(theta))

    low = max(math.floor(c(rope["beta_fast"])), 0)
    high = min(math.ceil(c(rope["beta_slow"])), dh - 1)
    i = torch.arange(dh // 2, dtype=torch.float64)
    r = torch.clamp((i - low) / max(high - low, 1e-3), 0.0, 1.0)
    mscale = rope.get("attention_factor")
    if mscale is None:
        mscale = 0.1 * math.log(factor) + 1.0
    return inv * (1 - r) + inv / factor * r, float(mscale)


def rope(x: torch.Tensor, pos: torch.Tensor, inv: torch.Tensor,
         mscale: float) -> torch.Tensor:
    """x [T, heads, dh] rotated at positions ``pos`` [T] (rotate-half)."""
    dh = x.shape[-1]
    ang = pos.double()[:, None] * inv.to(pos.device)[None]
    cos = (ang.cos() * mscale).float()[:, None]
    sin = (ang.sin() * mscale).float()[:, None]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(q, k, v, window: int | None, q_block: int = 1024):
    """One sequence's causal attention: q [S, H, dh] (pre-scaled), k, v
    [S, G, dh] -> [S, H * dh]; a query block attends only to the keys
    that its window reaches."""
    S, H, dh = q.shape
    G = k.shape[1]
    rep = H // G
    out = torch.empty((S, H, dh), dtype=torch.float32, device=q.device)
    for a in range(0, S, q_block):
        b = min(S, a + q_block)
        lo = 0 if window is None else max(0, a - window + 1)
        qi = torch.arange(a, b, device=q.device)[:, None]
        ki = torch.arange(lo, b, device=q.device)[None, :]
        allowed = ki <= qi
        if window is not None:
            allowed = allowed & (ki > qi - window)
        kk = k[lo:b].repeat_interleave(rep, dim=1)  # KV head g serves q heads
        vv = v[lo:b].repeat_interleave(rep, dim=1)  # g*rep .. g*rep + rep - 1
        s = torch.einsum("qhd,khd->hqk", q[a:b], kk)
        s = s.masked_fill(~allowed[None], float("-inf"))
        out[a:b] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), vv)
    return out.reshape(S, H * dh)


def kept(top_e: torch.Tensor, groups: torch.Tensor, E: int, cap: int):
    """[T, K] bool: the assignments the dropping MoE keeps.  In each routing
    group (``groups`` [T], its tokens in position order), an expert takes
    the first ``cap`` of its assignments in token-major order, as a stable
    sort by expert orders them."""
    T, K = top_e.shape
    key = (groups[:, None] * E + top_e).reshape(-1)  # (group, expert)
    order = torch.sort(key, stable=True).indices
    sk = key[order]
    first = torch.searchsorted(sk, sk)  # the run of each (group, expert)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(T * K, device=key.device) - first
    return (rank < cap).reshape(T, K)


def moe(blk: dict, x: torch.Tensor, cfg: dict, fmt, groups=None):
    """x [T, d] -> [T, d]; ``groups`` (the dropping fault's routing groups,
    None: dropless)."""
    E, K = cfg["num_experts"], cfg["num_experts_per_tok"]
    p = torch.softmax(linear(x, blk["router"], fmt), -1)
    top_p, top_e = torch.sort(p, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :K], top_e[:, :K]
    w = top_p / top_p.sum(-1, keepdim=True)
    if groups is not None:
        cap = max(1, round(DROP_GROUP * K * 1.25 / E))
        w = torch.where(kept(top_e, groups, E, cap), w, 0.0)
    y = torch.zeros_like(x)
    for e in range(E):
        tok, slot = torch.nonzero(top_e == e, as_tuple=True)
        if not len(tok):
            continue
        h = x[tok]
        a = linear(h, blk["gate"][e], fmt)
        h = a * torch.sigmoid(a) * linear(h, blk["up"][e], fmt)
        y[tok] += w[tok, slot, None] * linear(h, blk["down"][e], fmt)
    return y


def hidden(weights: dict, cfg: dict, seqs: list, fmt: str | None = None,
           fault: str | None = None) -> list:
    """The final RMSNorm's output ``[S_j, d]`` float32 of each token
    sequence ``seqs[j]`` (int64, on the weights' device)."""
    H, G, dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                cfg["head_dim"])
    eps, W = cfg["rms_norm_eps"], cfg["sliding_window"]
    lens = [len(s) for s in seqs]
    dev = weights["embed"].device
    pos = torch.cat([torch.arange(n, device=dev) for n in lens])
    groups = None
    if fault == "drop_1.25":
        groups = torch.cat([torch.full((n,), j, device=dev)
                            for j, n in enumerate(lens)]) * 10 ** 6 \
            + pos // DROP_GROUP
    ropes = {}
    for kind, r in cfg["rope_parameters"].items():
        if fault == "yarn_off":
            r = {"rope_type": "default", "rope_theta": r["rope_theta"]}
        ropes[kind] = inv_freq(dh, r)
    x = weights["embed"][torch.cat(seqs)].float()
    skip = cfg["num_hidden_layers"] // 2 if fault == "skip_layer" else None
    for i, blk in enumerate(weights["blocks"]):
        if i == skip:
            continue
        kind = cfg["layer_types"][i]
        window = W if kind == "sliding_attention" and fault != "window_off" \
            else None
        inv, mscale = ropes[kind]
        h = rmsnorm(blk["norm1"], x, eps)
        q = linear(h, blk["q_w"], fmt).reshape(-1, H, dh)
        k = linear(h, blk["k_w"], fmt).reshape(-1, G, dh)
        v = linear(h, blk["v_w"], fmt).reshape(-1, G, dh)
        q = rope(q, pos + (1 if fault == "rope_shift" else 0), inv, mscale)
        k = served(rope(k, pos, inv, mscale), fmt)
        v = served(v, fmt)
        q = q * dh ** -0.5
        o = torch.cat([attention(qs, ks, vs, window) for qs, ks, vs in zip(
            q.split(lens), k.split(lens), v.split(lens))])
        x = x + linear(o, blk["o_w"], fmt)
        x = x + moe(blk, rmsnorm(blk["norm2"], x, eps), cfg, fmt, groups)
    return list(rmsnorm(weights["final_norm"], x, eps).split(lens))


def output_logits(weights: dict, cfg: dict, prompts: list, outputs: list, *,
                  fmt: str | None = None, fault: str | None = None,
                  block_tokens: int = 65536) -> list:
    """For each request (``prompts[j]``, ``outputs[j]``: int64 token
    tensors on the weights' device), the float32 logits ``[n_out, V]`` at
    the positions that predict its output tokens: position ``P - 1 + t``
    of ``prompt + output[:-1]`` predicts ``output[t]``.  Requests run
    together in blocks of at most ``block_tokens`` tokens, longest
    first."""
    no_tf32()
    seqs = [torch.cat([p, o[:-1]]) for p, o in zip(prompts, outputs)]
    order = sorted(range(len(seqs)), key=lambda j: -len(seqs[j]))
    out: list = [None] * len(seqs)
    s = 0
    while s < len(order):
        block, n = [], 0
        while s < len(order) and (not block
                                  or n + len(seqs[order[s]]) <= block_tokens):
            block.append(order[s])
            n += len(seqs[order[s]])
            s += 1
        with torch.no_grad():
            hs = hidden(weights, cfg, [seqs[j] for j in block], fmt, fault)
            rows = [h[len(prompts[j]) - 1:] for j, h in zip(block, hs)]
            logits = linear(torch.cat(rows), weights["head"], fmt)
            for j, part in zip(block, logits.split([len(r) for r in rows])):
                out[j] = part
    return out
