"""Small CNN perception frontend (the 'neuro' module of NVSA/PrAE/LVRF).

The port of ``repro/models/cnn.py``.  Three stride-2 3x3 convolutions with
ReLU, a global average pool, an MLP head that regresses a D-dimensional VSA
query vector, and one linear classification head per attribute.

Layout: the reference is NHWC with HWIO weights; the port is NCHW with OIHW
weights (``convert.cnn_params_from_reference`` transposes).  The reference's
``padding="SAME"`` at stride 2 pads 0 before and 1 after on an even map, so
:func:`_conv` pads explicitly, computed from the shape, before an unpadded
``conv2d``; ``jax.nn.gelu`` is the tanh form.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import DEFAULT_DEVICE, generator as as_generator, resolve


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    channels: tuple = (32, 64, 128)
    kernel: int = 3
    head_hidden: int = 512  # MLP head: the query targets are ~300 arbitrary
    # directions in D-dim space, which a linear map from a narrow GAP feature
    # cannot span — the hidden layer provides the needed rank.
    vsa_dim: int = 1024
    attr_sizes: tuple = (5, 6, 10)  # type, size, color
    img: int = 32


class CNN(nn.Module):
    """Parameters under the reference's names, frozen as built (a trainer
    calls ``requires_grad_(True)``, then freezes it again): ``conv{i}_w``
    [c_out, c_in, k, k] (OIHW) / ``conv{i}_b``, ``head_h_w`` [C, hidden] /
    ``head_h_b``, ``head_vsa_w`` [hidden, D] / ``head_vsa_b``,
    ``head_attr{a}_w`` [C, n_a] / ``head_attr{a}_b``."""

    def __init__(self, params: dict):
        super().__init__()
        for name, value in params.items():
            self.register_parameter(
                name, nn.Parameter(value, requires_grad=False))


def _same_pad(size: int, k: int, stride: int) -> tuple:
    """(before, after) padding of XLA's ``SAME`` along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          stride: int) -> torch.Tensor:
    k = w.shape[-1]
    top, bottom = _same_pad(x.shape[-2], k, stride)
    left, right = _same_pad(x.shape[-1], k, stride)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w, b, stride=stride)


def init(cfg: CNNConfig, generator=0, device=DEFAULT_DEVICE) -> CNN:
    """Random weights as the reference scales them (He-normal convs and
    hidden layer, ``sqrt(1 / fan_in)`` heads, zero biases), drawn from a CPU
    ``torch.Generator`` (or an int seed) in parameter order and moved to
    ``device``."""
    dev = resolve(device)
    gen = as_generator(generator)

    def normal(shape, scale):
        return torch.randn(shape, generator=gen) * math.sqrt(scale)

    params = {}
    c_in = 1
    for i, c in enumerate(cfg.channels):
        fan_in = cfg.kernel * cfg.kernel * c_in
        params[f"conv{i}_w"] = normal((c, c_in, cfg.kernel, cfg.kernel),
                                      2.0 / fan_in)
        params[f"conv{i}_b"] = torch.zeros(c)
        c_in = c
    params["head_h_w"] = normal((c_in, cfg.head_hidden), 2.0 / c_in)
    params["head_h_b"] = torch.zeros(cfg.head_hidden)
    params["head_vsa_w"] = normal((cfg.head_hidden, cfg.vsa_dim),
                                  1.0 / cfg.head_hidden)
    params["head_vsa_b"] = torch.zeros(cfg.vsa_dim)
    for a, n in enumerate(cfg.attr_sizes):
        params[f"head_attr{a}_w"] = normal((c_in, n), 1.0 / c_in)
        params[f"head_attr{a}_b"] = torch.zeros(n)
    return CNN({k: v.to(dev) for k, v in params.items()})


def apply(model: CNN, images: torch.Tensor, cfg: CNNConfig) -> dict:
    """images [N, H, W] -> {'query': [N, D], 'attr_logits': tuple of [N, n_a],
    'features': [N, C]}."""
    x = images[:, None]  # NCHW
    for i in range(len(cfg.channels)):
        x = torch.relu(_conv(x, getattr(model, f"conv{i}_w"),
                             getattr(model, f"conv{i}_b"), stride=2))
    feat = torch.mean(x, dim=(2, 3))  # global average pool [N, C]
    hid = F.gelu(feat @ model.head_h_w + model.head_h_b, approximate="tanh")
    query = hid @ model.head_vsa_w + model.head_vsa_b
    attr_logits = tuple(
        feat @ getattr(model, f"head_attr{a}_w")
        + getattr(model, f"head_attr{a}_b")
        for a in range(len(cfg.attr_sizes)))
    return {"query": query, "attr_logits": attr_logits, "features": feat}


def num_params(model: CNN) -> int:
    return sum(p.numel() for p in model.parameters())
