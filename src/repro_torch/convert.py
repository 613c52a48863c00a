"""Carry the reference package's arrays across to the port.

The reference's parameters and codebooks, brought to the host with
``np.asarray``, become tensors on ``device``; the tests use this to drive
both packages with the same codebooks.  The ``*_to_reference`` functions go
the other way, so that gradients can be compared leaf by leaf and a
frontend the port trained can be scored by the reference.  Nothing here
imports the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quantization import QTensor
from repro_torch.device import DEFAULT_DEVICE, resolve

# fp8 dtypes by their numpy (ml_dtypes) name: torch.from_numpy refuses those
# arrays, so they cross as raw bytes and are viewed back on this side.
_FP8 = {"float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2}


def from_numpy(tree, device=DEFAULT_DEVICE):
    """A nested dict / tuple / list of numpy arrays (or array-likes) as the
    same structure of tensors on ``device``, dtypes kept."""
    dev = resolve(device)
    if isinstance(tree, dict):
        return {k: from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(from_numpy(v, dev) for v in tree)
    return torch.from_numpy(np.array(tree)).to(dev)  # a writable copy


def lvrf_atoms_from_reference(np_atoms: dict, device=DEFAULT_DEVICE) -> dict:
    """LVRF's ``{"values": [n_values, D], "positions": [3, D]}`` atoms as
    float32 tensors on ``device``."""
    return {k: from_numpy(np.asarray(np_atoms[k], np.float32), device)
            for k in ("values", "positions")}


def spec_arrays_from_reference(codebooks, valid_mask=None,
                               device=DEFAULT_DEVICE) -> tuple:
    """A factorizer spec's ``(codebooks [F, M, D] float32, valid_mask [F, M]
    bool or None)`` as tensors on ``device``."""
    cbs = from_numpy(np.asarray(codebooks, np.float32), device)
    mask = None if valid_mask is None else from_numpy(
        np.asarray(valid_mask, bool), device)
    return cbs, mask


def qtensor_from_reference(qt, device=DEFAULT_DEVICE) -> QTensor:
    """A reference ``QTensor`` (anything with ``.values`` and ``.scale``) as
    a port :class:`QTensor` on ``device``: int8 values as they are, fp8
    values bit for bit (through ``uint8``), scales as float32."""
    dev = resolve(device)
    values = np.asarray(qt.values)
    if values.dtype.name in _FP8:
        v = torch.from_numpy(values.view(np.uint8).copy()).view(
            _FP8[values.dtype.name])
    elif values.dtype == np.int8:
        v = torch.from_numpy(values.copy())
    else:
        raise ValueError(f"QTensor values of dtype {values.dtype} are not "
                         "int8, float8_e4m3fn or float8_e5m2")
    scale = torch.from_numpy(np.asarray(qt.scale, np.float32).copy())
    return QTensor(v, scale).to(dev)


def lm_params_from_reference(np_params: dict, cfg, device=DEFAULT_DEVICE,
                             trainable: bool = False):
    """The reference's ``transformer.init`` tree (numpy leaves; ``blocks`` a
    list over pattern positions whose leaves are stacked ``[P, ...]`` over
    periods; ``enc_blocks`` likewise over the encoder's layers) as the
    port's :class:`repro_torch.nn.transformer.LM` on ``device``.  Layer
    ``p * period + bi`` takes ``blocks[bi][...][p]``.  Each leaf is stored
    in :func:`~repro_torch.nn.transformer.stored_dtype`: in the serving
    layout (the default) fp32 for norms and Mamba's ``A_log`` (which the
    reference reads without a cast), ``cfg.activ_dtype`` for every other
    leaf (which it casts on each use); with ``trainable=True``, the
    training layout, every leaf in ``cfg.param_dtype`` and trainable."""
    from repro_torch.nn import transformer as T

    dev = resolve(device)

    def leaf(a, path, index=None):
        a = np.array(a if index is None else np.asarray(a)[index], np.float32)
        return torch.from_numpy(a).to(
            T.stored_dtype(cfg, path, trainable)).to(dev)

    def tree(t, path, index=None):
        return {k: tree(v, path + (k,), index) if isinstance(v, dict)
                else leaf(v, path + (k,), index) for k, v in t.items()}

    def stack(src, n, period):
        return [tree(src[i % period], (), i // period) for i in range(n)]

    encoder = None
    if cfg.encoder is not None:
        encoder = {"blocks": stack(np_params["enc_blocks"],
                                   cfg.encoder.n_layers, 1),
                   "ln": tree(np_params["enc_ln"], ("enc_ln",)),
                   "pos": leaf(np_params["enc_pos"], ("enc_pos",))}
    head = np_params.get("lm_head")
    return T.LM(cfg, leaf(np_params["embed"], ("embed",)),
                stack(np_params["blocks"], cfg.n_layers, cfg.period),
                tree(np_params["final_ln"], ("final_ln",)),
                None if head is None else leaf(head, ("lm_head",)), encoder,
                trainable)


def lm_params_to_reference(model, grads: bool = False) -> dict:
    """The port's :class:`~repro_torch.nn.transformer.LM` as the reference's
    ``transformer.init`` tree of float32 numpy arrays (``blocks`` a list
    over pattern positions, each leaf stacked ``[P, ...]`` over periods;
    ``enc_blocks`` over the encoder's layers); with ``grads=True``, the
    parameters' ``.grad`` in that tree (zeros where a parameter has none),
    so that gradients compare leaf by leaf with ``jax.grad``'s.  The
    inverse of :func:`lm_params_from_reference`."""
    cfg = model.cfg

    def host(t):
        if grads:
            t = t.grad if t.grad is not None else torch.zeros_like(t)
        return _host(t)

    def tree(t):
        return ({k: tree(v) for k, v in t.items()} if isinstance(t, dict)
                else host(t))

    def stack(layers: list, period: int) -> list:
        out = []
        for bi in range(period):
            per = [tree(b) for b in layers[bi::period]]
            out.append(_stack(per))
        return out

    t = model.tree()
    params = {"embed": host(t["embed"]),
              "final_ln": tree(t["final_ln"]),
              "blocks": stack(t["blocks"], cfg.period)}
    if t["lm_head"] is not None:
        params["lm_head"] = host(t["lm_head"])
    if t["encoder"] is not None:
        params["enc_blocks"] = stack(t["encoder"]["blocks"], 1)
        params["enc_ln"] = tree(t["encoder"]["ln"])
        params["enc_pos"] = host(t["encoder"]["pos"])
    return params


def _stack(trees: list):
    """Nested dicts of arrays, one a layer -> one dict of arrays stacked on
    a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def mimonet_params_from_reference(np_params: dict, device=DEFAULT_DEVICE):
    """The reference's ``mimonet.init`` dict (numpy leaves) as the port's
    :class:`repro_torch.models.mimonet.MIMONet` on ``device``, every leaf
    float32 under its own name."""
    from repro_torch.models.mimonet import MIMONet

    return MIMONet({k: from_numpy(np.asarray(v, np.float32), device)
                    for k, v in np_params.items()})


def cnn_params_from_reference(np_params: dict, device=DEFAULT_DEVICE):
    """The reference's ``cnn.init`` dict (numpy leaves) as the port's
    :class:`repro_torch.models.cnn.CNN` on ``device``, float32: HWIO
    convolution weights transposed to OIHW, every other leaf (the heads'
    ``[d_in, d_out]`` weights, the biases) as it is.  NVSA's padded
    codebooks and validity mask cross with :func:`spec_arrays_from_reference`."""
    from repro_torch.models.cnn import CNN

    out = {}
    for k, v in np_params.items():
        a = np.asarray(v, np.float32)
        if k.startswith("conv") and k.endswith("_w"):
            a = a.transpose(3, 2, 0, 1)  # [kh, kw, in, out] -> [out, in, kh, kw]
        out[k] = from_numpy(np.ascontiguousarray(a), device)
    return CNN(out)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def cnn_params_to_reference(model_or_params) -> dict:
    """The port's CNN (a :class:`repro_torch.models.cnn.CNN`, or a dict of
    tensors under its names, such as its gradients) as the reference's
    ``cnn.init`` dict of float32 numpy arrays: OIHW convolution weights
    transposed back to HWIO, every other leaf as it is.  The inverse of
    :func:`cnn_params_from_reference`."""
    items = (model_or_params.items() if isinstance(model_or_params, dict)
             else model_or_params.named_parameters())
    out = {}
    for k, v in items:
        a = _host(v)
        if k.startswith("conv") and k.endswith("_w"):
            a = a.transpose(2, 3, 1, 0)  # [out, in, kh, kw] -> [kh, kw, in, out]
        out[k] = np.ascontiguousarray(a)
    return out


def mimonet_params_to_reference(model_or_params) -> dict:
    """The port's MIMONet (or a dict of tensors under its names) as the
    reference's ``mimonet.init`` dict of float32 numpy arrays; the layouts
    are the same.  The inverse of :func:`mimonet_params_from_reference`."""
    items = (model_or_params.items() if isinstance(model_or_params, dict)
             else model_or_params.named_parameters())
    return {k: _host(v) for k, v in items}
