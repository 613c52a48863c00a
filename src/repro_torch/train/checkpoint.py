"""Fault-tolerant checkpointing: atomic, async, restore onto any device.

The port of ``repro/train/checkpoint.py``, writing the reference's layout,
so that a checkpoint written by either package restores in the other::

    <dir>/step_000000123/
        manifest.json     # {"treedef": null here, "step": ..., "extra": {...}}
        arrays.npz        # leaves keyed leaf_00000, leaf_00001, ...
    <dir>/LATEST          # atomically replaced pointer file

  * atomic commit: a step is staged under ``.tmp_step_*`` and renamed only
    when fully written, so a crash mid-write never corrupts a restore;
  * async save: :meth:`CheckpointManager.save` copies every tensor to host
    memory before it returns and hands the writing to a background thread;
  * retention: the last ``keep`` checkpoints stay;
  * restore onto any device: leaves are read on the host and placed on each
    template leaf's device (or ``device=``), cast to its dtype;
  * distributed leaves: a DTensor leaf is saved whole (``full_tensor()``,
    a collective every rank of its mesh joins), and in a process group of
    several ranks only rank 0 writes; ``restore(..., placements=...)``
    puts each leaf onto a ``DeviceMesh`` with the placements given, which
    may be another mesh than the one it was saved from (elastic restore).

Leaves are numbered in JAX's flattening order (dict keys sorted, lists and
tuples in order, ``None`` holds no leaf), which is what makes the two
packages' files interchangeable.  bf16 tensors are written as float32
(numpy has no bf16), which is exact; a reference bf16 array (ml_dtypes,
stored by ``np.savez`` as raw 2-byte records) is read back bit for bit.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch


def flatten(tree) -> list:
    """The leaves of ``tree`` in JAX's order (dict keys sorted)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flatten(v)]
    return [tree]


def unflatten(like, leaves: list):
    """``leaves`` in the structure of ``like`` (the inverse of
    :func:`flatten`)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, tuple) and hasattr(t, "_fields"):  # a NamedTuple
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def _leaves_like(like, tree) -> list:
    """One entry of ``tree`` per leaf of ``like``, in :func:`flatten`'s
    order: ``tree`` mirrors ``like``'s dicts and lists down to the leaves
    (an entry there may be any object), and a None where ``like`` has a
    subtree stands for every leaf below it."""
    if like is None:
        return []
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in _leaves_like(
            like[k], None if tree is None else tree[k])]
    if isinstance(like, (list, tuple)):
        return [x for i, v in enumerate(like) for x in _leaves_like(
            v, None if tree is None else tree[i])]
    return [tree]


def _path_keys(n: int):
    return [f"leaf_{i:05d}" for i in range(n)]


def _to_host(x) -> np.ndarray:
    """A host copy of ``x``: never a view of a CPU tensor, which the next
    training step updates in place while the writer thread reads it.  A
    DTensor is gathered whole first."""
    if isinstance(x, torch.Tensor):
        from torch.distributed.tensor import DTensor

        x = x.detach()
        if isinstance(x, DTensor):
            x = x.full_tensor()
        if x.dtype == torch.bfloat16:
            return x.float().cpu().numpy()  # .float() copies
        return x.to("cpu", copy=True).numpy()
    return np.array(x)


def _from_host(a: np.ndarray, like, device) -> torch.Tensor:
    """A host array as a tensor shaped and typed like ``like`` on
    ``device`` (default: ``like``'s device)."""
    if a.dtype.name == "bfloat16" or a.dtype.str == "|V2":
        # the reference's bf16 (ml_dtypes), which np.savez stores as raw
        # 2-byte records
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if isinstance(like, torch.Tensor):
        dev = like.device if device is None else torch.device(device)
        return t.to(device=dev, dtype=like.dtype)
    return t if device is None else t.to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, extra: dict | None = None) -> None:
        """Snapshot ``tree`` at ``step``. Returns once the leaves are on the
        host; the files are written on a background thread if async.  With
        DTensor leaves every rank of their meshes calls this; in a process
        group only rank 0 writes."""
        # Copy to host memory NOW: the training step updates the tensors in
        # place next.
        host_leaves = [_to_host(x) for x in flatten(tree)]
        import torch.distributed as dist

        if dist.is_initialized() and dist.get_rank() != 0:
            return
        payload = {"treedef": None, "step": step, "extra": extra or {}}
        self.wait()  # one in-flight save at a time
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host_leaves, payload),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host_leaves, payload)

    def _write(self, step: int, host_leaves, payload) -> None:
        name = f"step_{step:09d}"
        tmp = os.path.join(self.directory, f".tmp_{name}")
        final = os.path.join(self.directory, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **dict(zip(_path_keys(len(host_leaves)), host_leaves)))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(payload, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        latest_tmp = os.path.join(self.directory, ".LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(name)
        os.replace(latest_tmp, os.path.join(self.directory, "LATEST"))
        self._gc()

    def _gc(self) -> None:
        steps = sorted(d for d in os.listdir(self.directory)
                       if d.startswith("step_"))
        for d in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- restore ------------------------------------------------------------

    def latest_step(self) -> int | None:
        p = os.path.join(self.directory, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            name = f.read().strip()
        if not os.path.isdir(os.path.join(self.directory, name)):
            return None
        return int(name.split("_")[1])

    def restore(self, step: int, like: Any, device=None,
                placements=None) -> tuple:
        """Restore into the structure of ``like``: returns ``(tree, extra)``
        with new tensors, each on its template leaf's device (or on
        ``device``) in its dtype.  The checkpoint does not care where it was
        written from.

        ``placements`` mirrors ``like`` with, per leaf, None or ``(mesh,
        [placement per mesh dim])``: such a leaf becomes a DTensor on that
        ``DeviceMesh`` (``distribute_tensor``; every rank calls this), on
        the mesh's device type."""
        d = os.path.join(self.directory, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            payload = json.load(f)
        leaves = flatten(like)
        keys = _path_keys(len(leaves))
        with np.load(os.path.join(d, "arrays.npz")) as data:
            if len(keys) != len(data.files):
                raise ValueError(f"checkpoint has {len(data.files)} leaves, "
                                 f"template has {len(keys)}")
            new = [_from_host(data[k], leaf, device)
                   for k, leaf in zip(keys, leaves)]
        if placements is not None:
            from torch.distributed.tensor import distribute_tensor

            new = [t if pl is None else distribute_tensor(
                t.to(pl[0].device_type), pl[0], list(pl[1]))
                for t, pl in zip(new, _leaves_like(like, placements))]
        return unflatten(like, new), payload["extra"]
