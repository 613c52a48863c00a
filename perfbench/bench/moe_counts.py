"""Operations and bytes of a sliding-window, dropless-MoE decoder's serving
(Mellum2-12B-A2.5B), from shapes and counters alone.

As :mod:`.counts`: what the algorithm needs for its inputs, every input
byte read once and every output byte written once.  ``c`` is the
configuration's file (the published ``config.json``'s keys).
"""
from __future__ import annotations

import numpy as np

from perfbench.bench import lm_counts


def windows(c: dict) -> list:
    """Each layer's attention window: ``sliding_window`` for a sliding
    layer, None for a full one."""
    return [c["sliding_window"] if t == "sliding_attention" else None
            for t in c["layer_types"]]


def grouped_products(experts: int, tokens: int, c: dict) -> dict:
    """One MoE call's three grouped expert products (gate, up, down) over
    ``tokens`` routed tokens whose assignments reached ``experts``
    experts: the three bf16 matrices of each of those experts read once,
    the routed rows in and the products' rows out (bf16, ``d`` wide, an
    assignment each); ``6 d f`` FLOPs an assignment, on the tensor cores
    in bf16."""
    d, f = c["hidden_size"], c["moe_intermediate_size"]
    assignments = tokens * c["num_experts_per_tok"]
    return {"flops": int(6 * d * f * assignments),
            "bytes": int(2 * 3 * d * f * experts + 2 * 2 * d * assignments),
            "peak": "bf16_flops"}


def flash_decode_window(kv_lens, window: int | None, c: dict,
                        block_size: int) -> dict:
    """One layer's ``flash_decode`` launch over rows of KV lengths
    ``kv_lens`` (the new token's position included), a sliding layer's at
    its window: each row's last ``min(len, window)`` positions
    (:func:`perfbench.bench.lm_counts.flash_decode` at those lengths)."""
    L = np.asarray(kv_lens, dtype=np.int64)
    if window is not None:
        L = np.minimum(L, window)
    G = c["num_key_value_heads"]
    return lm_counts.flash_decode(L, G, c["num_attention_heads"] // G,
                                  c["head_dim"], c["kv_cache_dtype"] == "int8",
                                  block_size)


def context_sum(a, b, window: int | None) -> np.ndarray:
    """``sum(min(p + 1, window) for p in range(a, b))``, by entry: the keys
    the queries at positions ``a .. b - 1`` attend to."""
    def upto(n):
        n = np.asarray(n, dtype=np.float64)
        if window is None:
            return n * (n + 1) / 2
        w = float(window)
        return np.where(n <= w, n * (n + 1) / 2, w * (w + 1) / 2 + (n - w) * w)

    return upto(b) - upto(a)


def position_flops(c: dict) -> float:
    """Matrix FLOPs of one position through every layer: 2 a weight of q,
    k, v, o, the router and its top-k experts' three matrices."""
    d, f = c["hidden_size"], c["moe_intermediate_size"]
    q = c["num_attention_heads"] * c["head_dim"]
    kv = c["num_key_value_heads"] * c["head_dim"]
    per_layer = d * q + 2 * d * kv + q * d + d * c["num_experts"] \
        + c["num_experts_per_tok"] * 3 * d * f
    return 2.0 * c["num_hidden_layers"] * per_layer


def window_flops(c: dict, decodes, step_first, step_retire, prompt_len,
                 tokens, lo: int, hi: int) -> float:
    """FLOPs of the model work that engine steps ``lo .. hi`` did, as
    :func:`perfbench.bench.lm_counts.window_flops` counts them, with this
    model's matrices (:func:`position_flops`) and each layer's attention
    over its own context: a query at position ``p`` attends to ``p + 1``
    keys in a full layer and ``min(p + 1, window)`` in a sliding one, 4
    heads x head_dim FLOPs a key."""
    M = position_flops(c)
    A = 4.0 * c["num_attention_heads"] * c["head_dim"]
    head = 2.0 * c["hidden_size"] * c["vocab_size"]
    a = np.asarray(step_first, dtype=np.int64)
    P = np.asarray(prompt_len, dtype=np.int64)
    fill = np.where((a >= lo) & (a <= hi), P - 1, 0)
    before, upto = lm_counts.output_ranges(decodes, step_first, step_retire,
                                           tokens, lo, hi)
    m = (upto - before).astype(np.float64)
    attn = 0.0
    for w in windows(c):
        attn = attn + context_sum(0, fill, w) \
            + context_sum(P - 1 + before, P - 1 + upto, w)
    return float((fill * M + m * (M + head) + A * attn).sum())
