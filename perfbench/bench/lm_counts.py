"""Operations and bytes of language-model serving, from shapes alone.

As :mod:`.counts`: what the algorithm needs for its inputs, every input
byte read once and every output byte written once.
"""
from __future__ import annotations

import numpy as np


def flash_decode(kv_lens, kv_heads: int, rep: int, head_dim: int,
                 quantized: bool, block_size: int) -> dict:
    """One launch of paged decode attention over the live rows whose KV
    lengths (the new token's position included) are ``kv_lens``: each row's
    K and V read once at its length (bf16, or int8 with one fp32 scale a
    position and KV head), its block table's entries for those positions
    (int32) and its length (int32), q in and the output out (fp32
    ``[kv_heads, rep, head_dim]`` each).  The products, ``q . K`` and
    ``p . V``, run on the tensor cores in TF32."""
    L = np.asarray(kv_lens, dtype=np.int64)
    heads = kv_heads * rep
    per_position = 2 * kv_heads * (head_dim + 4 if quantized else 2 * head_dim)
    blocks = -(-L // block_size)
    return {"flops": int(4 * heads * head_dim * L.sum()),
            "bytes": int(per_position * L.sum() + 4 * blocks.sum()
                         + 4 * L.size + 2 * 4 * heads * head_dim * L.size),
            "peak": "tf32_flops"}


def matrix_params(c: dict) -> int:
    """Matrix weights one token meets in the layers: q, k, v, o and the
    MLP's up and down projections, times the layers."""
    d, f = c["d_model"], c["d_ff"]
    q, kv = c["n_heads"] * c["head_dim"], c["n_kv_heads"] * c["head_dim"]
    return c["n_layers"] * (d * q + 2 * d * kv + q * d + 2 * d * f)


def output_ranges(decodes, step_first, step_retire, tokens, lo: int,
                  hi: int) -> tuple:
    """``(before, upto)`` by request: the output tokens ``before .. upto - 1``
    that engine steps ``lo .. hi`` produced for requests admitted in step
    ``step_first``, retired in ``step_retire`` with ``tokens`` output
    tokens each: a live request gains ``decodes[j]`` tokens in step j, up
    to its ``tokens`` (a burst's overshoot past them is not counted)."""
    c = np.concatenate([[0], np.cumsum(np.asarray(decodes, dtype=np.int64))])
    a = np.asarray(step_first, dtype=np.int64)
    n = np.asarray(tokens, dtype=np.int64)
    live = (a <= hi) & (np.asarray(step_retire) >= lo)
    upto = np.where(live, np.minimum(n, c[hi + 1] - c[np.minimum(a, hi)]), 0)
    before = np.where(live, np.minimum(n, c[np.clip(a, lo, hi)] - c[np.minimum(a, hi)]), 0)
    return before, upto


def tokens_in_steps(decodes, step_first, step_retire, tokens, lo: int,
                    hi: int) -> int:
    """Output tokens that engine steps ``lo .. hi`` produced (see
    :func:`output_ranges`)."""
    before, upto = output_ranges(decodes, step_first, step_retire, tokens,
                                 lo, hi)
    return int((upto - before).sum())


def prompt_tokens_in_steps(step_first, prompt_len, lo: int, hi: int) -> int:
    """Prompt tokens of the requests whose fill ran in steps ``lo .. hi``:
    the fill prefills all but a prompt's last token, which the same step's
    decode burst feeds first."""
    a = np.asarray(step_first, dtype=np.int64)
    return int(np.asarray(prompt_len, dtype=np.int64)[(a >= lo) & (a <= hi)]
               .sum())


def window_flops(c: dict, decodes, step_first, step_retire, prompt_len,
                 tokens, lo: int, hi: int) -> float:
    """FLOPs of the model work that engine steps ``lo .. hi`` did: the
    prefill of the prompts admitted in them (positions ``0 .. P - 2``) and
    the positions ``P - 1 + t`` that produced their output tokens ``t``
    (:func:`output_ranges`).  A position ``p`` costs 2 a matrix weight
    (:func:`matrix_params`), causal attention over its ``p + 1`` keys
    (``q . K`` and ``p . V``: 4 heads x head_dim a key and layer), and the
    output head where it samples a token."""
    M = 2.0 * matrix_params(c)
    A = 4.0 * c["n_layers"] * c["n_heads"] * c["head_dim"]
    head = 2.0 * c["d_model"] * c["vocab"]
    a = np.asarray(step_first, dtype=np.int64)
    P = np.asarray(prompt_len, dtype=np.float64)
    fill = ((a >= lo) & (a <= hi)) * (P - 1)
    before, upto = output_ranges(decodes, step_first, step_retire, tokens,
                                 lo, hi)
    m = (upto - before).astype(np.float64)
    prefill = fill * M + A * fill * (fill + 1) / 2
    out = m * (M + head) + A * m * (P + (before + upto - 1) / 2)
    return float((prefill + out).sum())
