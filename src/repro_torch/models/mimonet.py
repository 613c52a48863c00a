"""MIMONet: computation in superposition (paper Sec. II-D, workload 2).

The port of ``repro/models/mimonet.py``.  S panel images are embedded, each
bound to its per-stream VSA key, bundled into ONE vector and pushed through a
single shared MLP backbone; the per-stream outputs are recovered by unbinding
before the attribute heads: S-fold throughput from one forward pass at a
graceful accuracy cost.  With ``VSAConfig(impl="pallas")`` every bind and
unbind is one launch of the hand-written circular convolution kernel on the
card (``kernels/circconv``).

Forward only: training (the reference's ``train/optimizer.py`` and the
example's step) is not ported yet (ROADMAP Queue A).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import vsa
from repro_torch.device import DEFAULT_DEVICE, generator as as_generator, resolve

ATTRS = ("type", "size", "color")


@dataclasses.dataclass(frozen=True)
class MIMONetConfig:
    vsa: vsa.VSAConfig = vsa.VSAConfig(dim=2048, blocks=8)
    num_streams: int = 2  # S simultaneous inputs
    img: int = 32
    hidden: tuple = (2048, 2048)
    attr_sizes: tuple = (5, 6, 10)


class MIMONet(nn.Module):
    """Frozen parameters under the reference's names: ``stream_keys`` [S, D],
    ``embed_w`` [img^2, D] / ``embed_b``, ``mlp{i}_w`` / ``mlp{i}_b``,
    ``out_w`` [h, D] / ``out_b``, ``head{a}_w`` [D, n_a] / ``head{a}_b``."""

    def __init__(self, params: dict):
        super().__init__()
        for name, value in params.items():
            self.register_parameter(
                name, nn.Parameter(value, requires_grad=False))


def init(cfg: MIMONetConfig, generator=0,
         device=DEFAULT_DEVICE) -> MIMONet:
    """Random weights as the reference draws them (unitary stream keys;
    normal weights times ``sqrt(1 / d_in)``, ``sqrt(2 / d_in)`` in the MLP;
    zero biases), drawn from a CPU ``torch.Generator`` (or an int seed) and
    moved to ``device``."""
    dev = resolve(device)
    gen = as_generator(generator)

    def normal(shape, scale):
        return torch.randn(shape, generator=gen) * math.sqrt(scale)

    D = cfg.vsa.dim
    d_in = cfg.img * cfg.img
    params = {"stream_keys": vsa.random_unitary(gen, (cfg.num_streams,),
                                                cfg.vsa, device="cpu"),
              "embed_w": normal((d_in, D), 1.0 / d_in),
              "embed_b": torch.zeros(D)}
    d = D
    for i, h in enumerate(cfg.hidden):
        params[f"mlp{i}_w"] = normal((d, h), 2.0 / d)
        params[f"mlp{i}_b"] = torch.zeros(h)
        d = h
    params["out_w"] = normal((d, D), 1.0 / d)
    params["out_b"] = torch.zeros(D)
    for a, n in enumerate(cfg.attr_sizes):
        params[f"head{a}_w"] = normal((D, n), 1.0 / D)
        params[f"head{a}_b"] = torch.zeros(n)
    return MIMONet({k: v.to(dev) for k, v in params.items()})


def _backbone(model: MIMONet, x: torch.Tensor, cfg: MIMONetConfig):
    for i in range(len(cfg.hidden)):
        x = F.gelu(x @ getattr(model, f"mlp{i}_w") + getattr(model, f"mlp{i}_b"),
                   approximate="tanh")  # jax.nn.gelu's default form
    return x @ model.out_w + model.out_b


def apply(model: MIMONet, images: torch.Tensor, cfg: MIMONetConfig) -> tuple:
    """images [N, S, H, W] -> per-stream attribute logits.

    The S stream inputs of each item share ONE backbone pass.
    Returns a tuple over attributes of [N, S, n_a] logits.
    """
    N, S = images.shape[:2]
    flat = images.reshape(N, S, -1)
    emb = flat @ model.embed_w + model.embed_b  # [N, S, D]
    keys = model.stream_keys  # [S, D]
    bound = vsa.bind(emb, keys[None, :, :], cfg.vsa)  # [N, S, D]
    sup = torch.mean(bound, dim=1)  # superposition [N, D]
    out = _backbone(model, sup, cfg)  # ONE pass for S inputs
    unbound = vsa.unbind(out[:, None, :], keys[None, :, :], cfg.vsa)
    return tuple(unbound @ getattr(model, f"head{a}_w")
                 + getattr(model, f"head{a}_b")
                 for a in range(len(cfg.attr_sizes)))


def loss_fn(model: MIMONet, batch: dict, cfg: MIMONetConfig) -> tuple:
    """batch: images [N, S, H, W]; labels ``type`` / ``size`` / ``color``
    [N, S] integer.  Returns ``(loss, {attr: accuracy})`` as 0-d tensors."""
    logits = apply(model, batch["images"], cfg)
    loss = 0.0
    accs = {}
    for a, name in enumerate(ATTRS):
        logp = torch.log_softmax(logits[a], dim=-1)
        lbl = batch[name].long()
        loss = loss - torch.mean(torch.gather(logp, -1, lbl[..., None]))
        accs[name] = torch.mean((torch.argmax(logits[a], -1) == lbl).float())
    return loss, accs
