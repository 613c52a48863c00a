"""The port's pod-scale dry-run (``repro_torch.launch.dryrun``) on fake
process groups.  This file imports no JAX at its top, so it also runs where
there is none; the cases held against the reference skip there.

  * ``_sanitize`` against the reference's, on its test's cases and on every
    leaf of llama3.2-3b's full config;
  * ``lower_cell`` for every architecture's smoke config on fake meshes of
    2 x 4 and 2 x 2 x 2, at a reduced shape of each kind: ``OK``, finite
    terms, ``argument_bytes`` equal to the local shard bytes computed here
    from the shapes and the rules, and collectives issued (every weight's
    ``embed`` dim is split over ``data``);
  * the counterpart of the reference's
    ``test_collective_parser_trip_count_multiplication``: a sharded layer
    run 24 times counts 24x its collective bytes;
  * the folded recurrences of xlstm-125m and jamba (train and prefill on a
    2 x 4 mesh at 6-8 chunks): memory and collectives exactly the stepped
    run's, and as many bodies dispatched at twice the sequence;
  * llama3.2-3b's ``decode_32k`` cell at full size from the command line.

The fake process group is global state of a process, so every lowering
runs in a subprocess of its own; the ten architectures' subprocesses run
three at a time.
"""
import concurrent.futures
import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARCH_IDS = ["dbrx-132b", "granite-moe-3b-a800m", "jamba-1.5-large-398b",
            "llama3.2-3b", "minicpm-2b", "qwen2-vl-72b", "qwen2.5-32b",
            "starcoder2-3b", "whisper-small", "xlstm-125m"]
SHAPES = {"train": {"seq": 16, "batch": 8, "kind": "train"},
          "prefill": {"seq": 16, "batch": 8, "kind": "prefill"},
          "decode": {"seq": 32, "batch": 8, "kind": "decode"}}


def _run(code: str, *args, timeout=600) -> list:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code, *args], env=env,
                         capture_output=True, text=True, timeout=timeout,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


_CELLS = textwrap.dedent("""
    import json, math, sys
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch import dryrun as D
    from repro_torch.nn import transformer as T
    from repro_torch.nn.common import spec_for

    arch, shapes = sys.argv[1], json.loads(sys.argv[2])
    spec = ARCHS[arch]
    cfg = spec.smoke()

    def local_bytes(shape, dtype, logical, mesh, rules):
        s = D._sanitize(spec_for(logical, mesh, rules), shape, mesh)
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        div = math.prod(sizes[a] for e in s if e is not None
                        for a in (e if isinstance(e, tuple) else (e,)))
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        assert n % div == 0
        return n // div

    def analytic(kind, shape, mesh):
        B, S = shape["batch"], shape["seq"]
        rules = D.cell_rules(kind, B)
        lg = T.leaf_logical(cfg)
        total = 0
        model = T.abstract_init(cfg, trainable=kind == "train")
        for name, p in model.named_parameters():
            total += local_bytes(p.shape, p.dtype, lg[name], mesh, rules)
            if kind == "train":
                if spec.optimizer == "adafactor":
                    f32, g = torch.float32, lg[name]
                    if p.dim() >= 2 and min(p.shape[-2:]) >= 128:  # factored
                        total += local_bytes(p.shape[:-1], f32, g[:-1], mesh,
                                             rules)
                        total += local_bytes(p.shape[:-2] + p.shape[-1:],
                                             f32, g[:-2] + g[-1:], mesh, rules)
                    else:
                        total += local_bytes(p.shape, f32, g, mesh, rules)
                else:
                    dt = (torch.bfloat16 if spec.opt_state_dtype == "bf16"
                          else torch.float32)
                    total += 2 * local_bytes(p.shape, dt, lg[name], mesh,
                                             rules)
        if kind == "decode":
            cache = T.init_cache(cfg, B, S, device="meta")
            for per, per_lg in zip(cache, T.cache_logical(cfg)):
                for name, leaves in per.items():
                    for k, t in leaves.items():
                        total += local_bytes(t.shape, t.dtype,
                                             per_lg[name][k], mesh, rules)
        n = 1 if kind == "decode" else S
        total += local_bytes((B, n), torch.int32, ("batch",) if
                             kind == "decode" else ("batch", "seq"), mesh,
                             rules)
        row = ("batch", None, None)
        if cfg.mrope_sections is not None:
            total += local_bytes((B, 3, n), torch.int32, row, mesh, rules)
            if kind != "decode":
                total += local_bytes((B, cfg.vision_patches, cfg.d_model),
                                     torch.bfloat16, row, mesh, rules)
        if cfg.encoder is not None:
            e = cfg.encoder
            total += local_bytes((B, e.n_frames, e.d_model), torch.bfloat16,
                                 row, mesh, rules)
        return total

    out = []
    for kind, shape in shapes.items():
        for ms in ((2, 4), (2, 2, 2)):
            r = D.lower_cell(arch, kind, False, cfg=cfg, shape=shape,
                             mesh_shape=ms)
            from torch.distributed.device_mesh import init_device_mesh
            names = ("pod", "data", "model")[-len(ms):]
            mesh = init_device_mesh("cpu", ms, mesh_dim_names=names)
            r["analytic_argument_bytes"] = analytic(kind, shape, mesh)
            out.append(r)
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def cells():
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=3)
    futures = {a: pool.submit(_run, _CELLS, a, json.dumps(SHAPES),
                              timeout=900) for a in ARCH_IDS}
    yield futures
    pool.shutdown(wait=True)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_lower_cell_runs_every_smoke_config_on_fake_meshes(cells, arch_id):
    import math

    results = cells[arch_id].result()
    assert len(results) == 6
    for r in results:
        where = (arch_id, r["kind"], r["mesh"])
        assert "error" not in r, where
        assert r["mesh"] in ("2x4", "2x2x2")
        for k in ("compute_s", "memory_s", "collective_s"):
            assert math.isfinite(r["terms"][k]) and r["terms"][k] >= 0, where
        assert r["terms"]["compute_s"] > 0 and r["terms"]["memory_s"] > 0
        assert r["memory"]["argument_bytes"] == \
            r["analytic_argument_bytes"], where
        assert r["memory"]["temp_bytes"] > 0, where
        assert r["cost"]["collective_bytes"] > 0, where
        assert sum(r["cost"]["collective_counts"].values()) > 0, where
        assert 0 < r["useful_frac"] <= 1.0


def test_collective_count_multiplies_with_the_layers_run():
    code = textwrap.dedent("""
        import json
        import torch
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.launch import dryrun as D
        from repro_torch.launch import roofline as R
        D.fake_world(4)
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
        with FakeTensorMode():
            w = DTensor.from_local(torch.empty(4, 128), mesh, [Shard(0)],
                                   run_check=False)
            x = DTensor.from_local(torch.empty(8, 16), mesh, [Replicate()],
                                   run_check=False)

            def layers(n):
                y = x
                for _ in range(n):
                    y = (y @ w)[:, :16].redistribute(mesh, [Replicate()])
                return y

            one = R.collective_bytes(layers, 1)
            many = R.collective_bytes(layers, 24)
        print(json.dumps({"one": one, "many": many}))
    """)
    r = _run(code)
    one, many = r["one"], r["many"]
    assert one["total"] > 0
    assert many["total"] == 24 * one["total"]
    for kind, n in one["counts"].items():
        assert many["counts"][kind] == 24 * n
        assert many[kind] == 24 * one[kind]


_FOLD = textwrap.dedent("""
    import dataclasses, json, sys
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch import dryrun as D
    from repro_torch.nn import common as C

    arch, kind, seq = sys.argv[1], sys.argv[2], int(sys.argv[3])
    cfg = ARCHS[arch].smoke()
    for sub in ("xlstm", "mamba"):
        if getattr(cfg, sub) is not None:
            cfg = dataclasses.replace(cfg, **{sub: dataclasses.replace(
                getattr(cfg, sub), chunk=8)})
    cfg = dataclasses.replace(cfg, remat=True)  # as the full configs

    def run(fold, s):
        C.FOLD, C.bodies = fold, 0
        r = D.lower_cell(arch, kind, False, cfg=cfg, mesh_shape=(2, 4),
                         shape={"seq": s, "batch": 8, "kind": kind})
        return {"memory": r["memory"], "bytes": r["cost"]["collective_bytes"],
                "counts": r["cost"]["collective_counts"],
                "bodies": C.bodies, "accum": r.get("grad_accum")}

    print(json.dumps({"stepped": run(False, seq), "folded": run(True, seq),
                      "folded_2x": run(True, 2 * seq)}))
""")
# (arch, kind, seq): seq / 8 chunks of 8 tokens; 6 for jamba's train cell,
# whose stepped run is the slowest (4 microbatches, 8 layers)
FOLD_CELLS = [("xlstm-125m", "train", 64), ("xlstm-125m", "prefill", 64),
              ("jamba-1.5-large-398b", "train", 48),
              ("jamba-1.5-large-398b", "prefill", 64)]


@pytest.fixture(scope="module")
def folds():
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=4)
    futures = {c: pool.submit(_run, _FOLD, c[0], c[1], str(c[2]),
                              timeout=900) for c in FOLD_CELLS}
    yield futures
    pool.shutdown(wait=True)


@pytest.mark.parametrize("cell", FOLD_CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_folded_recurrence_equals_the_stepped_run(folds, cell):
    """On fake tensors xLSTM's steps, Mamba's chunks and the microbatches
    are folded (``nn/common.py::scan``): three bodies run and the rest are
    allocated and counted.  Memory and collectives must equal the stepped
    run's exactly, and the bodies dispatched must not grow with the
    sequence (the stepped run's do)."""
    r = folds[cell].result()
    stepped, folded, longer = r["stepped"], r["folded"], r["folded_2x"]
    assert folded["memory"] == stepped["memory"]
    assert folded["counts"] == stepped["counts"]
    assert folded["bytes"] == stepped["bytes"]
    assert sum(stepped["counts"].values()) > 0
    assert folded["bodies"] < stepped["bodies"]
    assert longer["bodies"] == folded["bodies"]
    if cell[1] == "train" and cell[0].startswith("jamba"):
        assert stepped["accum"] == 4  # the microbatch fold is exercised


def test_llama_decode_cell_at_full_size_from_the_command_line(tmp_path):
    out = tmp_path / "cell.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3.2-3b", "--shape", "decode_32k", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[OK] llama3.2-3b decode_32k 16x16" in proc.stdout
    r = json.loads(out.read_text())[0]
    assert r["terms"]["bottleneck"] == "memory"
    # the fp32 parameters split over 16 x 16, and the 32k KV cache's 128
    # rows over data and its sequence over model
    assert r["n_params"] == 3_606_752_256
    assert 1.5 * 2 ** 30 < r["memory"]["argument_bytes"] < 2.0 * 2 ** 30


def test_production_mesh_needs_its_process_group():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        make_production_mesh()


def test_sanitize_matches_the_reference():
    pytest.importorskip("jax")
    saved = os.environ.get("XLA_FLAGS")
    try:  # the reference's dry-run module sets XLA_FLAGS when imported
        from repro.launch.dryrun import _sanitize as ref_sanitize
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    from jax.sharding import PartitionSpec as P

    from repro.configs.registry import ARCHS as RARCHS
    from repro.nn import common as RC
    from repro.nn import transformer as RT
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch.dryrun import _sanitize, cell_rules
    from repro_torch.nn import transformer as T
    from repro_torch.nn.common import spec_for

    def fake_mesh(names, shape):
        class FakeMesh:
            axis_names = names

            class devices:
                pass
        FakeMesh.devices.shape = shape
        return FakeMesh

    m = fake_mesh(("data", "model"), (16, 16))
    assert _sanitize(("model",), (8,), m) == tuple(ref_sanitize(P("model"),
                                                                (8,), m))
    assert _sanitize(("model",), (8,), m) == (None,)
    assert _sanitize(("model", "model"), (32, 32), m) == ("model", None)
    assert _sanitize(("model", "model"), (32, 32), m) == tuple(
        ref_sanitize(P("model", "model"), (32, 32), m))
    cfg, rcfg = ARCHS["llama3.2-3b"].full(), RARCHS["llama3.2-3b"].full()
    rshapes, rlogical = RT.abstract_init(rcfg)
    import jax
    leaf = lambda x: isinstance(x, tuple)  # noqa: E731
    pairs = list(zip(jax.tree_util.tree_leaves(rshapes),
                     jax.tree_util.tree_leaves(rlogical, is_leaf=leaf)))
    params = dict(T.abstract_init(cfg).named_parameters())
    llg = T.leaf_logical(cfg)
    pairs += [(p, llg[n]) for n, p in params.items()]
    n = 0
    for mesh in (m, fake_mesh(("pod", "data", "model"), (2, 16, 16))):
        for kind, B in (("train", 256), ("decode", 128), ("decode", 1)):
            rules = cell_rules(kind, B)
            for arr, lg in pairs:
                shape = tuple(arr.shape)
                want = ref_sanitize(RC.spec_for(lg, mesh, rules), shape, mesh)
                assert _sanitize(spec_for(lg, mesh, rules), shape, mesh) == \
                    tuple(want), (lg, shape)
                n += 1
    assert n == 2 * 3 * len(pairs) and len(pairs) > 250
