"""GPipe-style pipeline parallelism over a ``pipe`` mesh axis.

The port of ``repro/distributed/pipeline.py``.  Stages hold disjoint layer
groups; microbatches stream through them in the standard fill-run-drain
schedule: with M microbatches and P stages it takes M + P - 1 steps, and
the bubble fraction is (P - 1) / (M + P - 1).

The reference runs the schedule as one SPMD program (``shard_map`` over
``pipe``, a ``scan`` of the steps, ``ppermute`` between stages).  The port
is single-controller: the host walks the steps, issues each stage's layer
group on that stage's device (``mesh.devices[i]``) and moves activations
with :meth:`repro_torch.launch.mesh.Mesh.ppermute`.  Launches are
asynchronous, so with stages on distinct cards their work overlaps; with
every stage on one card it runs in turn.

Two departures, neither of which moves a number of the outputs:

  * a stage with no microbatch in a bubble step skips its compute (the
    reference computes on junk there and discards it), so a step costs the
    layer groups of its live stages only;
  * the outputs land on the last stage's device, not replicated over the
    axis (the reference ``all_gather``s them: a single controller already
    holds them).
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree


def _stage(stage_params, i: int, device):
    """Stage ``i``'s parameters on ``device``: item ``i`` of a sequence of
    per-stage parameters, or the ``i``-th slice of a pytree of tensors
    stacked over stages ``[P, ...]`` (left where it lies when ``device``
    is None)."""
    if isinstance(stage_params, (list, tuple)):
        return stage_params[i]
    return pytree.tree_map(
        lambda t: t[i] if device is None else t[i].to(device), stage_params)


def pipeline_apply(layer_fn, stage_params, x_microbatches, *, mesh,
                   axis: str = "pipe") -> torch.Tensor:
    """Run microbatches through the P stages of ``mesh``'s ``axis``.

    ``layer_fn(params, x) -> x`` applies ONE stage's layer group.
    ``stage_params``: P per-stage parameters (a list, each already on its
    stage's device), or a pytree with a leading stage axis ``[P, ...]``
    (each stage's slice moved to its device).  ``x_microbatches``:
    ``[M, mb, ...]``.  Returns ``[M, mb, ...]``, the last stage's outputs
    on its device.  ``mesh`` is a one-axis
    :class:`repro_torch.launch.mesh.Mesh` over ``axis``; each step hands
    the activations on with one ``ppermute`` (M + P - 2 in all: the last
    step has nothing to hand on; none for P = 1).
    """
    if mesh.axes != (axis,):
        raise ValueError(f"the pipeline runs on a mesh of the one axis "
                         f"{axis!r}, not {mesh.axes}")
    devs = mesh.devices
    n_stages, M = len(devs), x_microbatches.shape[0]
    params = [_stage(stage_params, i, devs[i]) for i in range(n_stages)]
    # the activation each stage holds: what it received, or its last output
    held = [torch.zeros_like(x_microbatches[0], device=d) for d in devs]
    outs = [None] * M
    perm = [(i, i + 1) for i in range(n_stages - 1)]
    steps = M + n_stages - 1
    for t in range(steps):
        for i in range(n_stages):
            mb = t - i  # the microbatch stage i works on at step t
            if not 0 <= mb < M:
                continue  # a bubble: nothing to compute
            inp = x_microbatches[mb].to(devs[0]) if i == 0 else held[i]
            held[i] = layer_fn(params[i], inp)
            if i == n_stages - 1:
                outs[mb] = held[i]
        if t < steps - 1 and perm:
            held = mesh.ppermute(axis, held, perm)
    return torch.stack(outs)


def sequential_apply(layer_fn, stage_params, x_microbatches) -> torch.Tensor:
    """The same computation without pipelining, on one device: each
    microbatch through every stage in turn, on the stages' parameters
    where they lie."""
    n_stages = (len(stage_params) if isinstance(stage_params, (list, tuple))
                else pytree.tree_leaves(stage_params)[0].shape[0])
    params = [_stage(stage_params, i, None) for i in range(n_stages)]
    outs = []
    for x in x_microbatches:
        for p in params:
            x = layer_fn(p, x)
        outs.append(x)
    return torch.stack(outs)


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
