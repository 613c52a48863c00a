"""Plain PyTorch versions of paged decode attention.

Shared layout contract (plain versions and kernel):

  * q:        [B, G, rep, dh] fp32, PRE-scaled by dh**-0.5 by the caller;
  * k/v pool: [NBP, bs, G, dh] bf16 or int8 — NBP physical blocks of bs
    token positions (the last is conventionally the trash block);
  * table:    [B, W] int32 — per-row logical->physical block ids, padded
    with any in-range id past the row's live window;
  * kv_lens:  [B] int32 — number of VALID kv positions per row (a decode
    step that just wrote position ``len`` passes ``len + 1``);
  * k_scale/v_scale: [NBP, bs, G, 1] fp32 when the pool is int8.

Returns [B, G, rep, dh] fp32 (the un-projected per-head context).

Two functions, which differ only on a row with ``kv_lens == 0``:

  * :func:`flash_decode_plain` is what the CUDA kernel computes (the Pallas
    kernel's function): such a row is exact zeros.  :mod:`.ops` runs it for
    CPU tensors, and ``chip_smoke.py`` holds the kernel against it;
  * :func:`flash_decode_ref` is the reference's dense gathered-window
    attention (``use_flash=False``): one softmax over the masked window,
    which over all -1e30 scores is uniform, so such a row is the mean of V
    over the window.
"""
from __future__ import annotations

import torch

_NEG = -1e30


def tf32_split(x: torch.Tensor) -> tuple:
    """``(hi, lo)`` of fp32 ``x``: hi = x rounded to the nearest TF32 (10
    stored mantissa bits, ties away from zero, as ``cvt.rna.tf32.f32``), lo =
    the rest rounded the same way.  The tensor-core kernel (rep 9-16)
    multiplies q and the probabilities as these two terms; the tests
    restate its arithmetic with it."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    x = x.to(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def check_scales(k_pool, k_scale, v_scale) -> None:
    if k_pool.dtype == torch.int8 and (k_scale is None or v_scale is None):
        raise ValueError("int8 KV pool requires k_scale/v_scale pools")


def flash_decode_ref(q, k_pool, v_pool, table, kv_lens, k_scale=None,
                     v_scale=None) -> torch.Tensor:
    check_scales(k_pool, k_scale, v_scale)
    B, G, rep, dh = q.shape
    W = table.shape[1]
    bs = k_pool.shape[1]
    tab = table.long()
    k = k_pool[tab].float()  # [B, W, bs, G, dh]
    v = v_pool[tab].float()
    if k_scale is not None:
        k = k * k_scale[tab]
        v = v * v_scale[tab]
    k = k.reshape(B, W * bs, G, dh)
    v = v.reshape(B, W * bs, G, dh)
    s = torch.einsum("bgrd,bkgd->bgrk", q.float(), k)
    pos = torch.arange(W * bs, device=q.device)
    s = torch.where(pos[None, None, None, :] < kv_lens[:, None, None, None],
                    s, torch.full((), _NEG, dtype=s.dtype, device=s.device))
    return torch.einsum("bgrk,bkgd->bgrd", torch.softmax(s, dim=-1), v)


def flash_decode_plain(q, k_pool, v_pool, table, kv_lens, k_scale=None,
                       v_scale=None) -> torch.Tensor:
    out = flash_decode_ref(q, k_pool, v_pool, table, kv_lens, k_scale,
                           v_scale)
    live = (kv_lens > 0)[:, None, None, None]
    return torch.where(live, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))
