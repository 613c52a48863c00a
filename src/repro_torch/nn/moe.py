"""Mixture-of-Experts layer: top-k router with sort-based capacity dispatch.

The port of ``repro/nn/moe.py`` (granite-moe 40 experts top-8, dbrx 16
top-4 and jamba 16 top-2 run through it).  A dropping MoE: the token ->
expert assignments are sorted by expert, each expert takes a fixed capacity
of them, and overflow assignments fall back to the residual path.

Routing is per batch row; at decode (S == 1, B > 1) the rows of each data
shard are folded into ONE routing group (all B rows with no mesh), so
capacity is sized for B * K assignments and the rows compete for it
(inactive slots' tokens too: the reference's behaviour, kept).  Under a
sharding context the routing and the combine run on each batch shard's
local rows (``rows_local``, the reference's ``shard_map`` over the batch
axes), and only the expert products stay under DTensor's propagation.

Where the numbers come from, step by step as the reference's:

  * top-k: a stable descending sort over the experts, so a tie keeps the
    lower expert first, as ``jax.lax.top_k`` does (``torch.topk`` promises
    no order);
  * dispatch: a stable sort of the assignments by expert and a cumulative
    count; ``round`` in the capacity is Python's (half to even);
  * combine: the reference scatter-adds a token's K contributions one by
    one in sorted (expert id) order, rounding to the working type after
    each add.  Here each token gathers its own K contributions and sums them
    in ascending expert order: the same additions in the same order, and
    deterministic on the card (no atomics).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.nn import layers as L
from repro_torch.nn.common import (current_mesh, local_map, mesh_axes,
                                   rows_local, sanitize, shard, spec_for)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int  # per-expert hidden
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3


def init_moe(draw, cfg: MoEConfig) -> dict:
    """``router`` [d, E], ``gate``/``up`` [E, d, f], ``down`` [E, f, d],
    normal times ``d ** -0.5`` (``f ** -0.5`` for ``down``); ``draw(shape,
    scale)`` makes one leaf (see :mod:`repro_torch.nn.transformer`)."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    s_in, s_out = (1.0 / d) ** 0.5, (1.0 / f) ** 0.5
    return {"router": draw((d, E), s_in), "gate": draw((E, d, f), s_in),
            "up": draw((E, d, f), s_in), "down": draw((E, f, d), s_out)}


def moe_logical() -> dict:
    """The reference's logical axes of :func:`init_moe`'s leaves."""
    return {"router": ("embed", "experts"), "gate": ("experts", "embed", "mlp"),
            "up": ("experts", "embed", "mlp"),
            "down": ("experts", "mlp", "embed")}


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.softmax``'s formula: ``exp(x - max) / sum``."""
    e = torch.exp(x - x.amax(dim, keepdim=True))
    return e / e.sum(dim, keepdim=True)


def top_k(probs: torch.Tensor, k: int) -> tuple:
    """``jax.lax.top_k`` over the last axis: values descending, a tie keeps
    the lower index first.  Returns (values, indices)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``idx[..., None] == arange(n)`` as int64: a one-hot that reads nothing
    back to the host (capturable in a CUDA graph)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def _route_local(x, top_e, top_p, *, E: int, K: int, cap: int,
                 fold: int = 1) -> tuple:
    """Token -> slot permutation.  x: [B, S, d]; top_e/top_p: [B, S, K].
    Returns disp [B/fold, E, cap, d] and what the combine needs, per
    sorted assignment: ``slot`` (E * cap when dropped), weight ``sw``,
    ``keep``, and ``order``, the sort itself."""
    if fold > 1:
        B0, S0, d0 = x.shape
        x = x.reshape(B0 // fold, fold * S0, d0)
        top_e = top_e.reshape(B0 // fold, fold * S0, K)
        top_p = top_p.reshape(B0 // fold, fold * S0, K)
    B, S, d = x.shape
    Tk = S * K
    dev = x.device
    flat_e = top_e.reshape(B, Tk)
    flat_w = top_p.reshape(B, Tk).to(x.dtype)
    tok_of = (torch.arange(Tk, device=dev) // K)[None].expand(B, Tk)
    order = torch.sort(flat_e, dim=-1, stable=True).indices
    se = torch.gather(flat_e, 1, order)
    sw = torch.gather(flat_w, 1, order)
    st = torch.gather(tok_of, 1, order)
    counts = _one_hot(se, E).sum(1)  # [B, E]
    starts = torch.cumsum(counts, -1) - counts
    rank = torch.arange(Tk, device=dev)[None] - torch.gather(starts, 1, se)
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, torch.full_like(se, E * cap))
    vals = torch.where(keep[..., None],
                       torch.gather(x, 1, st[..., None].expand(B, Tk, d)),
                       torch.zeros((), dtype=x.dtype, device=dev))
    brow = torch.arange(B, device=dev)[:, None].expand(B, Tk)
    disp = torch.zeros((B, E * cap + 1, d), dtype=x.dtype, device=dev)
    disp.index_put_((brow, slot), vals)  # dropped ones (zeros) -> scratch row
    return disp[:, :E * cap].reshape(B, E, cap, d), slot, sw, keep, order


def _combine_local(out, slot, sw, keep, order, *, S: int, K: int,
                   fold: int = 1) -> torch.Tensor:
    """Expert outputs back to token positions.  out: [B/fold, E * cap, d].
    Each token sums its K contributions (zero where dropped) in sorted
    order, i.e. ascending expert id, one add at a time in out's dtype."""
    B, EC, d = out.shape
    contrib = torch.gather(out, 1, torch.clamp(slot, 0, EC - 1)[..., None]
                           .expand(B, slot.shape[1], d)) * sw[..., None]
    contrib = torch.where(keep[..., None], contrib,
                          torch.zeros((), dtype=out.dtype, device=out.device))
    # sorted position of each assignment, token-major; a token's K of them
    # ascending (its experts are distinct, so this is expert order)
    where_sorted = torch.argsort(order, dim=-1).reshape(B, S * fold, K)
    where_sorted = torch.sort(where_sorted, dim=-1).values
    brow = torch.arange(B, device=out.device)[:, None, None]
    parts = contrib[brow, where_sorted]  # [B, S*fold, K, d]
    y = parts[:, :, 0]
    for k in range(1, K):
        y = y + parts[:, :, k]
    return y.reshape(B * fold, S, d) if fold > 1 else y


def _batch_axes(mesh, rules) -> tuple:
    b_rule = rules.get("batch")
    return tuple(a for a in ((b_rule,) if isinstance(b_rule, str)
                             else (b_rule or ())) if a in mesh_axes(mesh))


def _expert_hidden(disp, gate, up):
    return L._silu(torch.einsum("becd,edf->becf", disp, gate)) \
        * torch.einsum("becd,edf->becf", disp, up)


def _expert_map(fn, x, *ws):
    """``fn(x, *ws)``, the experts' products, on each rank's rows and
    experts under a mesh: ``x [B, E, cap, .]`` split by rows over the batch
    axes and by experts over the experts axes, the weights ``[E, ...]`` by
    experts (expert parallelism as the reference's rules place it; the
    weights' FSDP split gathered).  Plainly otherwise.  DTensor's own
    propagation through the batched products cannot view its local
    gradients once rows and experts are both split."""
    v = current_mesh()
    if v is None:
        return fn(x, *ws)
    mesh, rules = v
    rows, ex = sanitize(spec_for(("batch", "experts"), mesh, rules),
                        x.shape[:2], mesh)
    return local_map(fn, (x, *ws), [(rows, ex)] + [(ex,)] * len(ws),
                     [(rows, ex)])


def moe(p, x: torch.Tensor, cfg: MoEConfig) -> tuple:
    """x: [B, S, d] -> (y [B, S, d], aux dict: ``load_balance``,
    ``router_z``, ``dropped_frac``, fp32 scalars).  Capacity per routing
    group: ``round(S * fold * K * capacity_factor / E)``, at least 1."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    logits = (x @ p["router"].to(x.dtype)).float()  # [B, S, E]

    def route_probs(logits):
        probs = softmax(logits)
        top_p, top_e = top_k(probs, K)
        return probs, top_p / (top_p.sum(-1, keepdim=True) + 1e-9), top_e

    # Routing, dispatch and combine run on each data shard's rows under a
    # mesh (the reference's shard_map over the batch axes): DTensor cannot
    # partition the sorts, gathers and scatters of token routing and would
    # replicate them.  Expert weights never enter these functions.
    probs, top_p, top_e = rows_local(route_probs, (logits,), n_out=3)
    # Decode (S == 1): pool each data shard's rows into ONE routing group
    # so capacity is sized for B_loc * K assignments, not E slots a row.
    fold = 1
    if S == 1 and B > 1:
        v = current_mesh()
        dp = 1
        if v is not None:
            sizes = mesh_axes(v[0])
            for a in _batch_axes(*v):
                dp *= sizes[a]
        if B % dp == 0:
            fold = B // dp
    cap = int(max(1, round(S * fold * K * cfg.capacity_factor / E)))
    disp, slot, sw, keep, order = rows_local(
        functools.partial(_route_local, E=E, K=K, cap=cap, fold=fold),
        (x, top_e, top_p), n_out=5)
    disp = shard(disp, "batch", "experts", None, None)
    h = _expert_map(_expert_hidden, disp, p["gate"].to(x.dtype),
                    p["up"].to(x.dtype))
    h = shard(h, "batch", "experts", None, "mlp")
    out = _expert_map(functools.partial(torch.einsum, "becf,efd->becd"), h,
                      p["down"].to(x.dtype))
    out = shard(out, "batch", "experts", None, None).reshape(
        B // fold, E * cap, d)
    y = rows_local(functools.partial(_combine_local, S=S, K=K, fold=fold),
                   (out, slot, sw, keep, order))
    me = _one_hot(top_e[..., 0], E).float().mean((0, 1))
    ce = probs.mean((0, 1))
    aux = {
        "load_balance": E * torch.sum(me * ce),
        "router_z": cfg.router_z_loss * torch.mean(
            torch.square(torch.logsumexp(logits, -1))),
        "dropped_frac": 1.0 - torch.mean(keep.float()),
    }
    return shard(y, "batch", "seq", "embed_act"), aux
