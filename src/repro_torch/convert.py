"""Carry the reference package's arrays across to the port.

The reference's parameters and codebooks, brought to the host with
``np.asarray``, become tensors on ``device``; the tests use this to drive
both packages with the same codebooks.  Nothing here imports the reference.
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


def lm_params_from_reference(np_params: dict, cfg, device=DEFAULT_DEVICE):
    """The reference's ``transformer.init`` tree (numpy leaves; ``blocks`` a
    list over pattern positions whose leaves are stacked ``[P, ...]`` over
    periods) as the port's :class:`repro_torch.nn.transformer.LM` on
    ``device``.  Layer ``p * period + bi`` takes ``blocks[bi][...][p]``.
    Matmul weights (embedding and head included) are stored in
    ``cfg.activ_dtype``, as the reference casts them on every call; norm
    scales and biases stay float32."""
    from repro_torch.nn import transformer as T

    dev = resolve(device)

    def leaf(a, dtype):
        return torch.from_numpy(np.array(a, np.float32)).to(dtype).to(dev)

    def tree(t, dtype, index=None):
        return {k: tree(v, dtype, index) if isinstance(v, dict)
                else leaf(v if index is None else np.asarray(v)[index], dtype)
                for k, v in t.items()}

    wd = cfg.activ_dtype
    blocks = []
    for layer in range(cfg.n_layers):
        period, bi = divmod(layer, cfg.period)
        src = np_params["blocks"][bi]
        blocks.append({k: tree(v, torch.float32 if k.startswith("ln") else wd,
                               period) for k, v in src.items()})
    head = np_params.get("lm_head")
    return T.LM(cfg, leaf(np_params["embed"], wd), blocks,
                tree(np_params["final_ln"], torch.float32),
                None if head is None else leaf(head, wd))


def mimonet_params_from_reference(np_params: dict, device=DEFAULT_DEVICE):
    """The reference's ``mimonet.init`` dict (numpy leaves) as the port's
    :class:`repro_torch.models.mimonet.MIMONet` on ``device``, every leaf
    float32 under its own name."""
    from repro_torch.models.mimonet import MIMONet

    return MIMONet({k: from_numpy(np.asarray(v, np.float32), device)
                    for k, v in np_params.items()})
