"""Carry the reference package's arrays across to the port.

The reference's parameters and codebooks, brought to the host with
``np.asarray``, become tensors on ``device``; the tests use this to drive
both packages with the same codebooks.  Nothing here imports the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve


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
