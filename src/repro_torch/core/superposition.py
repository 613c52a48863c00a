"""Generic computation-in-superposition wrapper (MIMONet for any backbone).

The port of ``repro/core/superposition.py``.  S streams are embedded, bound
to per-stream VSA keys, bundled into ONE sequence, pushed through a single
backbone pass, and the per-stream hidden states recovered by unbinding
before the head.  `superpose_embeddings` / `unbind_hidden` slot around any
[N, S, T, d]-shaped backbone; they bind through the default ``impl`` of
their ``VSAConfig``, as the reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import vsa
from repro_torch.device import DEFAULT_DEVICE


def make_stream_keys(generator, n_streams: int, d_model: int, blocks: int = 8,
                     device=DEFAULT_DEVICE) -> torch.Tensor:
    """Unitary per-stream binding keys [S, d] (exact unbinding), from a CPU
    ``torch.Generator`` or an int seed, on ``device``."""
    cfg = vsa.VSAConfig(dim=d_model, blocks=blocks)
    return vsa.random_unitary(generator, (n_streams,), cfg, device=device)


def superpose_embeddings(embs: torch.Tensor, keys: torch.Tensor,
                         blocks: int = 8,
                         carrier_rms: float | None = None) -> torch.Tensor:
    """embs [N, S_streams, T, d] -> one bundled sequence [N, T, d].

    ``carrier_rms`` rescales every bundled token to that per-component RMS,
    so that a residual backbone's O(1)-RMS sublayer additions do not bury
    the bound carrier (see the reference's docstring); ``None`` keeps the
    raw mean.
    """
    cfg = vsa.VSAConfig(dim=embs.shape[-1], blocks=blocks)
    bound = vsa.bind(embs, keys[None, :, None, :], cfg)
    s = torch.mean(bound, dim=1)
    if carrier_rms is not None:
        rms = torch.sqrt(torch.mean(s * s, dim=-1, keepdim=True)) + 1e-6
        s = s * (carrier_rms / rms)
    return s


def unbind_hidden(hidden: torch.Tensor, keys: torch.Tensor,
                  blocks: int = 8) -> torch.Tensor:
    """hidden [N, T, d] -> per-stream hidden [N, S_streams, T, d]."""
    cfg = vsa.VSAConfig(dim=hidden.shape[-1], blocks=blocks)
    return vsa.unbind(hidden[:, None], keys[None, :, None, :], cfg)


def mimo_lm_logits(model, cfg, tokens: torch.Tensor, keys: torch.Tensor,
                   blocks: int = 8, carrier_rms: float | None = None):
    """Serve S_streams token batches through ONE backbone pass.

    ``model`` is the port's :class:`repro_torch.nn.transformer.LM` of
    ``cfg``.  tokens: [N, S_streams, T] -> logits [N, S_streams, T, vocab]
    in ``cfg.activ_dtype``.  ``carrier_rms`` defaults to ``2 * n_layers``:
    the bundle is amplified past the ~2 sublayer additions of O(1) RMS that
    every layer of the pre-norm residual stack contributes, which keeps the
    streams separable through an untrained backbone (the reference's
    choice).
    """
    from repro_torch.nn import transformer as T

    if carrier_rms is None:
        carrier_rms = 2.0 * cfg.n_layers
    N, S_str, Tlen = tokens.shape
    emb = F.embedding(tokens.reshape(N * S_str, Tlen).long(),
                      model.embed.to(cfg.activ_dtype))
    emb = emb.reshape(N, S_str, Tlen, cfg.d_model)
    x = superpose_embeddings(emb, keys, blocks,
                             carrier_rms=carrier_rms).to(cfg.activ_dtype)
    positions = torch.arange(Tlen, device=x.device)[None].expand(N, Tlen)
    with torch.no_grad():
        for i, blk in enumerate(model.blocks):
            x, _ = T._apply_block(blk, cfg.kind(i), cfg, x, positions,
                                  None, i)
        x = T._norm(cfg, model.final_ln, x)
    per_stream = unbind_hidden(x, keys, blocks)  # [N, S_str, T, d]
    head = model.head.to(cfg.activ_dtype)
    return per_stream.to(cfg.activ_dtype) @ head
