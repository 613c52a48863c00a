"""Pod-scale dry-run: run every (arch x shape x mesh) cell on fake devices.

The port of ``repro/launch/dryrun.py``.  It proves the distribution config
is coherent without hardware, on the host, and needs no card.  Where the
reference lowers and compiles each step for 512 placeholder CPU devices,
the port:

  * initialises ``torch.distributed``'s ``fake`` process group (256 or 512
    ranks, this process being rank 0) and the production ``DeviceMesh``
    over it (:func:`repro_torch.launch.mesh.make_production_mesh`);
  * builds the model on ``meta`` and distributes every leaf as a DTensor
    of fake tensors, placed by ``leaf_logical`` + ``spec_for`` +
    :func:`_sanitize`, and the optimizer state, the decode cache and the
    inputs the same way: nothing is allocated;
  * runs the step once (train: forward, backward, clip, the spec's
    optimizer; prefill: forward; decode: one token against the cache)
    under ``FakeTensorMode``, inside ``sharding_ctx`` and the collective
    counter (:class:`repro_torch.launch.roofline.CollectiveCounter`).

Recurrences are folded as the reference's scans are lowered once: on fake
tensors xLSTM's steps, Mamba's chunks and the microbatches of a train step
run three bodies (two for the microbatches), the rest allocated and their
collectives counted (:func:`repro_torch.nn.common.scan`); memory and
collectives equal the stepped run's (``nn.common.FOLD = False``).

Memory: ``argument_bytes`` are the local shard bytes of params, optimizer
state, cache and inputs; ``temp_bytes`` the peak of the live fake-tensor
bytes the step makes above them.  FLOPs and HBM bytes are the analytic
model's (:mod:`repro_torch.launch.costmodel`); collective bytes are rank
0's, counted as issued.  An op DTensor has no sharding rule for fails the
cell, reported ``FAIL`` with the op.

The fake process group comes from ``torch.testing._internal.distributed.
fake_pg``, a private module of PyTorch: only this host-only tool imports
it, no path that runs on the card.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.common import SHAPES
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import costmodel as CM
from repro_torch.launch import mesh as M
from repro_torch.launch import roofline as R
from repro_torch.nn import common
from repro_torch.nn import transformer as T
from repro_torch.nn.common import (DEFAULT_RULES, mesh_axes, placements,
                                   repeating, sanitize, sharding_ctx, spec_for)
from repro_torch.train import optimizer as optim

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                         "artifacts", "dryrun_torch")


_sanitize = sanitize  # the reference's name


def local_shape(shape, spec: tuple, mesh) -> tuple:
    """One rank's shard shape of a tensor of ``shape`` placed by a
    sanitized ``spec`` (every named axis divides its dim)."""
    sizes = mesh_axes(mesh)
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                dim //= sizes[a]
        out.append(dim)
    return tuple(out)


def _fake(shape, dtype, logical, mesh, rules, requires_grad=False):
    """A DTensor of a fake local shard (under the active ``FakeTensorMode``),
    placed by ``logical`` through ``spec_for`` and :func:`_sanitize`."""
    from torch.distributed.tensor import DTensor

    shape = tuple(shape)
    spec = _sanitize(spec_for(logical, mesh, rules), shape, mesh)
    local = torch.empty(local_shape(shape, spec, mesh), dtype=dtype)
    stride = tuple(torch.empty(shape, device="meta").stride())
    dt = DTensor.from_local(local, mesh, placements(spec, mesh),
                            run_check=False, shape=torch.Size(shape),
                            stride=stride)
    return dt.requires_grad_(requires_grad) if requires_grad else dt


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    return sum((t.to_local() if isinstance(t, DTensor) else t).untyped_storage()
               .nbytes() for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# Inputs, params, cache, optimizer state (fake DTensors; no allocation)
# ---------------------------------------------------------------------------

def input_specs(cfg, shape: dict, mesh, rules) -> dict:
    """The step's inputs as fake DTensors: ``tokens`` (+ M-RoPE
    ``positions`` and ``vision_embeds``, or the encoder's frames / output)."""
    B, S, kind = shape["batch"], shape["seq"], shape["kind"]
    tok_len = 1 if kind == "decode" else S
    row = ("batch", None, None)
    out = {"tokens": _fake((B, tok_len), torch.int32,
                           ("batch",) if kind == "decode" else ("batch", "seq"),
                           mesh, rules)}
    if cfg.mrope_sections is not None:
        out["positions"] = _fake((B, 3, tok_len), torch.int32, row, mesh, rules)
        if kind != "decode":
            out["vision_embeds"] = _fake((B, cfg.vision_patches, cfg.d_model),
                                         torch.bfloat16, row, mesh, rules)
    if cfg.encoder is not None:
        e = cfg.encoder
        name = "enc_out" if kind == "decode" else "encoder_frames"
        out[name] = _fake((B, e.n_frames, e.d_model), torch.bfloat16, row,
                          mesh, rules)
    return out


def param_specs(model: T.LM, mesh, rules, trainable: bool) -> T.LM:
    """``model`` (from ``abstract_init``) with every parameter a fake
    DTensor placed by its logical axes: the training layout (fp32,
    requiring grad) or the serving one."""
    return T.replace_params(
        model, lambda name, p, lg: _fake(p.shape, p.dtype, lg, mesh, rules),
        requires_grad=trainable)


def cache_specs(cfg, B: int, S: int, mesh, rules) -> list:
    """The decode cache as fake DTensors placed by ``cache_logical``."""
    shapes = T.init_cache(cfg, B, S, device="meta")
    return pytree.tree_map(
        lambda t, lg: _fake(t.shape, t.dtype, lg, mesh, rules), shapes,
        T.cache_logical(cfg), is_leaf=lambda x: isinstance(x, tuple))


def make_opt(spec, params: list):
    """The spec's optimizer over ``params``, as the reference's dry-run
    makes it: Adafactor at 1e-2, or AdamW at 3e-4 with moments in
    ``spec.opt_state_dtype``."""
    if spec.optimizer == "adafactor":
        return optim.adafactor(params, 1e-2)
    dt = torch.bfloat16 if spec.opt_state_dtype == "bf16" else torch.float32
    return optim.adamw(params, 3e-4, state_dtype=dt)


def opt_state_specs(spec, model: T.LM, cfg, mesh, rules):
    """(optimizer, its state tensors): every moment a fake DTensor placed
    by its parameter's logical axes (Adafactor's factored rows and columns
    by the axes they keep), the step counters real CPU tensors."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    logical = T.leaf_logical(cfg)
    names = [n for n, _ in model.named_parameters()]
    with unset_fake_temporarily():  # real CPU step counters
        opt = make_opt(spec, [p for _, p in model.named_parameters()])
    for name, p in zip(names, opt.state_tree()):
        lg = logical[name]
        for k, t in list(p.items()):
            if k == "step":
                continue
            lgk = {"vr": lg[:-1], "vc": lg[:-2] + lg[-1:]}.get(k, lg)
            p[k] = _fake(t.shape, t.dtype, lgk, mesh, rules)
    return opt, [t for st in opt.state_tree() for k, t in st.items()
                 if k != "step"]


# ---------------------------------------------------------------------------
# Live bytes
# ---------------------------------------------------------------------------

class _LiveBytes(TorchDispatchMode):
    """The peak of the bytes of local (fake) storages the step makes and
    holds at once, outside the argument storages ``skip``.

    A DTensor op is run here, and its outputs' local tensors are counted:
    the global-shape placeholders DTensor makes to propagate shapes then
    stay out of the count.  A plain op (on local tensors: a collective's
    buffer, a ``local_map`` body) counts its outputs."""

    def __init__(self, skip: set):
        super().__init__()
        self.skip, self.live, self.cur, self.peak = skip, {}, 0, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            if isinstance(t, DTensor):
                self._track(t._local_tensor)
            elif isinstance(t, torch.Tensor):
                self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.skip:
            return
        if key in self.live:
            self.live[key][0] += 1
        else:
            self.live[key] = [1, st.nbytes()]
            self.cur += st.nbytes()
            self.peak = max(self.peak, self.cur)
        weakref.finalize(t, self._drop, key)

    def _drop(self, key) -> None:
        e = self.live.get(key)
        if e is None:
            return
        e[0] -= 1
        if e[0] == 0:
            del self.live[key]
            self.cur -= e[1]


def _storage_keys(tree) -> set:
    from torch.distributed.tensor import DTensor

    return {(t.to_local() if isinstance(t, DTensor) else t)
            .untyped_storage()._cdata for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)}


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def fake_world(n: int) -> None:
    """Make this process rank 0 of a ``fake`` process group of ``n`` ranks
    (replacing one of another size)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())


def cell_rules(kind: str, B: int, no_fsdp: bool = False) -> dict:
    """The reference's rules for a cell: FSDP off with ``no_fsdp``, the
    Megatron-SP residual off under ``REPRO_NO_SP``; decode shards the KV
    cache's sequence over ``model`` (batch >= 16) or runs context-parallel
    over the whole mesh (a batch of 1)."""
    rules = dict(DEFAULT_RULES)
    if no_fsdp:
        rules["embed"] = None
    if os.environ.get("REPRO_NO_SP"):
        rules["seq_res"] = None
    if kind == "decode":
        if B >= 16:
            rules["seq"] = "model"
        else:
            rules["batch"] = None
            rules["seq"] = ("data", "model")
            rules["seq_res"] = None
    return rules


def lower_cell(arch_id: str, shape_name: str, multi_pod: bool,
               kv_int8: bool = False, serve_bf16: bool = False,
               no_fsdp: bool = False, *, cfg=None, shape: dict | None = None,
               mesh_shape: tuple | None = None) -> dict:
    """Run one cell's step on the fake mesh and report its memory, cost,
    collectives and roofline terms.  ``cfg``, ``shape`` and ``mesh_shape``
    (with its axis names taken from the production mesh of that rank)
    replace the full config, ``SHAPES[shape_name]`` and the production
    mesh, for reduced cells."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.device_mesh import init_device_mesh

    spec = ARCHS[arch_id]
    cfg = cfg or spec.full()
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if serve_bf16:  # bf16 serving params: halves param-read traffic at decode
        cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    s = shape or SHAPES[shape_name]
    B, S, kind = s["batch"], s["seq"], s["kind"]
    if mesh_shape is None:
        mesh_name = "2x16x16" if multi_pod else "16x16"
        fake_world(math.prod(M.production_shape(multi_pod)))
        mesh = M.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    else:
        mesh_name = "x".join(map(str, mesh_shape))
        fake_world(math.prod(mesh_shape))
        names = ("pod", "data", "model")[-len(mesh_shape):]
        mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=names)
    rules = cell_rules(kind, B, no_fsdp)
    result = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
              "kind": kind}
    t0 = time.time()
    train = kind == "train"
    model = T.abstract_init(cfg, trainable=train)
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = param_specs(model, mesh, rules, trainable=train)
        params = list(model.parameters())
        batch = input_specs(cfg, s, mesh, rules)
        args = {"params": params, "batch": batch}
        if train:
            opt, state = opt_state_specs(spec, model, cfg, mesh, rules)
            args["opt_state"] = state
            # microbatched gradient accumulation, as the reference's step:
            # the microbatch must stay divisible by the batch axes
            sizes = mesh_axes(mesh)
            b_rule = rules.get("batch") or ()
            dp = math.prod(sizes[a] for a in (
                (b_rule,) if isinstance(b_rule, str) else b_rule)
                if a in sizes)
            accum = max(1, min(spec.grad_accum, B // dp))
            micro = (batch if accum == 1 else input_specs(
                cfg, {**s, "batch": B // accum}, mesh, rules))
            result["grad_accum"] = accum
        elif kind == "decode":
            args["cache"] = cache = cache_specs(cfg, B, S, mesh, rules)
        arg_bytes = _local_bytes(args)
        live = _LiveBytes(_storage_keys(args))
        with sharding_ctx(mesh, rules), R.CollectiveCounter() as coll, live:
            if train:
                # fake: one microbatch's shapes.  Folded as the reference's
                # scan over microbatches: microbatch 0 makes the gradients,
                # microbatch 1 adds to them and stands for the rest, which
                # would repeat its memory and collectives exactly
                runs = min(accum, 2) if common.FOLD else accum
                for i in range(runs):
                    k = accum - 1 if runs < accum and i == 1 else 1
                    with repeating(k):
                        loss, _ = T.loss_fn(model, cfg, micro)
                        (loss / accum).backward()
                optim.clip_by_global_norm([p.grad for p in params], 1.0)
                with unset_fake_temporarily():  # the counters stay real
                    opt.step()
                tokens = B * S
            elif kind == "prefill":
                with torch.no_grad():
                    T.forward(model, cfg, batch["tokens"],
                              positions=batch.get("positions"),
                              vision_embeds=batch.get("vision_embeds"),
                              encoder_frames=batch.get("encoder_frames"))
                tokens = B * S
            else:
                T.decode_step(model, cfg, cache, batch["tokens"],
                              positions=batch.get("positions"),
                              enc_out=batch.get("enc_out"))
                tokens = B  # one new token per row
    result["lower_s"] = round(time.time() - t0, 1)
    result["memory"] = {"argument_bytes": int(arg_bytes),
                        "temp_bytes": int(live.peak)}
    coll_sum = coll.summary()
    chips = mesh.size()
    n_params, n_active = T.count_params_cfg(cfg)
    cost = CM.step_cost(cfg, n_params, kind, B, S,
                        param_bytes=2 if serve_bf16 else 4)
    result["cost"] = {
        "flops_analytic": cost.flops, "hbm_bytes_analytic": cost.hbm_bytes,
        "collective_bytes": coll_sum["total"],
        "collective_counts": coll_sum["counts"],
    }
    result["terms"] = R.roofline_terms(cost.flops, cost.hbm_bytes,
                                       coll_sum["total"], chips)
    mf = R.model_flops(n_params, n_active, tokens, kind)
    result["model_flops"] = mf
    result["useful_frac"] = (min(1.0, mf["model_flops_active"] / cost.flops)
                             if cost.flops else 0.0)
    result["n_params"] = n_params
    result["n_active"] = n_active
    return result


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             kv_int8: bool = False, serve_bf16: bool = False,
             no_fsdp: bool = False) -> dict:
    skip = ARCHS[arch_id].shapes()[shape_name]["skip"]
    mesh = "2x16x16" if multi_pod else "16x16"
    if skip:
        return {"arch": arch_id, "shape": shape_name, "mesh": mesh,
                "skipped": skip}
    try:
        return lower_cell(arch_id, shape_name, multi_pod, kv_int8=kv_int8,
                          serve_bf16=serve_bf16, no_fsdp=no_fsdp)
    except Exception as e:  # a failing cell is a bug — surface it loudly
        return {"arch": arch_id, "shape": shape_name, "mesh": mesh,
                "error": f"{type(e).__name__}: {e}"[:2000],
                "traceback": traceback.format_exc()[-2000:]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache variant for decode cells (hillclimb)")
    ap.add_argument("--serve-bf16", action="store_true",
                    help="bf16 serving params (halves param traffic at decode)")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="TP-only weight sharding (drops per-layer FSDP gathers)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    os.makedirs(ARTIFACTS, exist_ok=True)
    cells = []
    if args.all:
        for aid in ARCHS:
            for shp in SHAPES:
                cells.append((aid, shp, False))
                cells.append((aid, shp, True))
    else:
        cells.append((args.arch, args.shape, args.multipod))
    results = []
    for aid, shp, mp in cells:
        r = run_cell(aid, shp, mp, kv_int8=args.kv_int8,
                     serve_bf16=args.serve_bf16, no_fsdp=args.no_fsdp)
        results.append(r)
        tag = "SKIP" if "skipped" in r else ("FAIL" if "error" in r else "OK")
        extra = r.get("error", "") if tag == "FAIL" else \
            (R.summarize(r) if tag == "OK" else r.get("skipped", ""))
        print(f"[{tag}] {aid} {shp} {'2x16x16' if mp else '16x16'} {extra}",
              flush=True)
        if "memory" in r:
            print(f"       mem/dev: args={r['memory']['argument_bytes']/2**30:.2f}GiB "
                  f"temp={r['memory']['temp_bytes']/2**30:.2f}GiB "
                  f"lower={r['lower_s']}s", flush=True)
        out_path = args.out or os.path.join(ARTIFACTS, "results.json")
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1, default=str)
    print(f"wrote {len(results)} cells")
    return results


if __name__ == "__main__":
    main()
