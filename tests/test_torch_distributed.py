"""``tests/test_distributed.py``'s two cases that need a process group,
ported: a ``gloo`` world of 8 CPU processes (one thread each, a
``FileStore`` under the test's temporary directory, the reference test's
420 s limit).

  * The sharded train step: llama3.2-3b's smoke parameters placed on a
    (2, 4) ``data x model`` ``DeviceMesh`` by their logical axes
    (``transformer.distribute``), the batch over ``data``, loss and
    gradients under ``sharding_ctx``; against the same step in one
    process, and against the reference's single-device loss and gradients
    on the same numpy-made parameters, within the reference test's bounds
    (loss 2e-3, gradients 2e-2).  The reference side skips where JAX is
    absent.
  * Elastic restore: a tree saved from a (4, 2) mesh restored onto a
    (2, 2) submesh with swapped placements, bitwise, with ``extra`` carried
    over and 4 devices in the result.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORLD = 8

_WORKER = textwrap.dedent("""
    import os, pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, case, tmp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), %(world)d),
        rank=rank, world_size=%(world)d)
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    out = {}
    if case == "train":
        from repro_torch import convert
        from repro_torch.configs.registry import ARCHS
        from repro_torch.nn import transformer as T
        from repro_torch.nn.common import sharding_ctx
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            params, tokens = pickle.load(f)
        cfg = ARCHS["llama3.2-3b"].smoke()
        model = convert.lm_params_from_reference(params, cfg, device="cpu",
                                                 trainable=True)
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        T.distribute(model, mesh)
        sharded = {n: list(p.placements) != [Replicate()] * 2
                   for n, p in model.named_parameters()}
        batch = {"tokens": distribute_tensor(torch.from_numpy(tokens), mesh,
                                             [Shard(0), Replicate()])}
        with sharding_ctx(mesh):
            loss, _ = T.loss_fn(model, cfg, batch)
            loss.backward()
        out = {"loss": float(loss.full_tensor()), "sharded": sharded,
               "grads": {n: p.grad.full_tensor().numpy()
                         for n, p in model.named_parameters()}}
    else:
        from repro_torch.train.checkpoint import CheckpointManager
        mesh1 = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
        w = torch.arange(64.0).reshape(8, 8)
        tree = {"w": distribute_tensor(w, mesh1, [Shard(0), Shard(1)]),
                "step": torch.tensor(7, dtype=torch.int32)}
        m = CheckpointManager(os.path.join(tmp, "ckpt"), async_save=False)
        m.save(7, tree, extra={"data_state": {"step": 3}})
        dist.barrier()
        assert m.latest_step() == 7
        mesh2 = DeviceMesh("cpu", [[0, 1], [2, 3]],
                           mesh_dim_names=("data", "model"))
        restored, extra = m.restore(
            7, tree, placements={"w": (mesh2, [Shard(1), Shard(0)]),
                                 "step": None})
        if rank < 4:
            rw = restored["w"]
            out = {"ok": bool(torch.equal(rw.full_tensor(), w)),
                   "placements": [(type(p).__name__, p.dim)
                                  for p in rw.placements],
                   "local": list(rw.to_local().shape),
                   "extra": extra, "ndev": rw.device_mesh.size(),
                   "step": int(restored["step"])}
    if rank == 0:
        with open(os.path.join(tmp, "out.pkl"), "wb") as f:
            pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
""") % {"world": WORLD}


def _world(case: str, tmp) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), case,
                               str(tmp)], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(WORLD)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=420)
            errs.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, err in errs:
        assert rc == 0, err[-3000:]
    with open(tmp / "out.pkl", "rb") as f:
        return pickle.load(f)


def _inputs():
    """llama3.2-3b smoke parameters in the reference's layout (numpy),
    made by the port's init in the training layout, and a batch of 8 rows
    of 32 tokens."""
    from repro_torch import convert
    from repro_torch.configs.registry import ARCHS
    from repro_torch.nn import transformer as T

    cfg = ARCHS["llama3.2-3b"].smoke()
    model = T.init(cfg, 0, device="cpu", trainable=True)
    params = convert.lm_params_to_reference(model)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (8, 32)).astype(
        np.int32)
    return cfg, params, tokens


def _single(cfg, params, tokens):
    from repro_torch import convert
    from repro_torch.nn import transformer as T

    model = convert.lm_params_from_reference(params, cfg, device="cpu",
                                             trainable=True)
    loss, _ = T.loss_fn(model, cfg, {"tokens": torch.from_numpy(tokens)})
    loss.backward()
    return float(loss.detach()), {n: p.grad.numpy()
                                  for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def sharded_step(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    cfg, params, tokens = _inputs()
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump((params, tokens), f)
    return cfg, params, tokens, _world("train", tmp)


def test_sharded_train_matches_one_process(sharded_step):
    cfg, params, tokens, r = sharded_step
    loss, grads = _single(cfg, params, tokens)
    assert abs(r["loss"] - loss) < 2e-3
    assert set(r["grads"]) == set(grads)
    gdiff = max(float(np.abs(r["grads"][n] - g).max()) for n, g in grads.items())
    assert gdiff < 2e-2
    # the weights really were split: every block's matmul weights and the
    # embedding and head
    assert r["sharded"]["embed"] and r["sharded"]["lm_head"]
    assert r["sharded"]["blocks.0.attn.q.w"] and r["sharded"]["blocks.1.mlp.down.w"]


def test_sharded_train_matches_the_reference_single_device(sharded_step):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs.registry import ARCHS as RARCHS
    from repro.nn import transformer as RT
    from repro_torch import convert

    cfg, params, tokens, r = sharded_step
    rcfg = RARCHS["llama3.2-3b"].smoke()
    jp = jax.tree.map(jnp.asarray, params)
    (l0, _), g0 = jax.value_and_grad(RT.loss_fn, has_aux=True)(
        jp, rcfg, {"tokens": jnp.asarray(tokens)})
    assert abs(float(l0) - r["loss"]) < 2e-3
    want = dict(convert.lm_params_from_reference(
        jax.tree.map(np.asarray, g0), cfg, device="cpu",
        trainable=True).named_parameters())
    assert set(want) == set(r["grads"])
    gdiff = max(float(np.abs(r["grads"][n] - want[n].detach().numpy()).max())
                for n in want)
    assert gdiff < 2e-2


def test_elastic_checkpoint_restore_across_meshes(tmp_path):
    r = _world("restore", tmp_path)
    assert r["ok"] and r["extra"] == {"data_state": {"step": 3}}
    assert r["ndev"] == 4  # restored onto the smaller mesh
    assert r["placements"] == [("Shard", 1), ("Shard", 0)]
    assert r["local"] == [4, 4] and r["step"] == 7
