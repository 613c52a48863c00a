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


def mimo_lm_logits(params, cfg, tokens, keys, blocks: int = 8,
                   carrier_rms: float | None = None):
    """S token streams through ONE transformer pass: needs the full-sequence
    forward, which the port does not have yet."""
    raise NotImplementedError(
        "mimo_lm_logits runs the full-sequence transformer forward, which "
        "the port lacks (ROADMAP Queue A item 1b)")
