"""The port's GPipe pipeline (``repro_torch.distributed.pipeline``) against
the reference's, on the reference test's case (P = 4 stages, M = 6
microbatches of 2 rows, d = 16, ``tanh(x @ w) + x``): within the reference
test's bound 1e-5 of the reference's ``pipeline_apply`` (run on 4 host
devices in a subprocess, as ``tests/test_distributed.py`` runs it), and
bitwise equal to the port's own ``sequential_apply``.  The bubble fraction
and the ``ppermute`` count the schedule implies.  JAX is imported only by
the reference's subprocess, and that case skips where it is absent."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.distributed import pipeline as pp
from repro_torch.launch.mesh import Mesh

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
P, M, MB, D = 4, 6, 2, 16


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((P, D, D)) * 0.3).astype(np.float32)
    xs = rng.standard_normal((M, MB, D)).astype(np.float32)
    return w, xs


def _layer(p, x):
    return torch.tanh(x @ p["w"]) + x


def _run_port(w, xs, n_stages=P):
    mesh = Mesh(["cpu"] * n_stages, axes=("pipe",))
    params = {"w": torch.from_numpy(w)}
    out = pp.pipeline_apply(_layer, params, torch.from_numpy(xs), mesh=mesh)
    return out, mesh


def test_pipeline_matches_the_reference_pipeline(tmp_path):
    pytest.importorskip("jax")
    w, xs = _inputs()
    code = textwrap.dedent(f"""
        import json, sys
        import numpy as np, jax, jax.numpy as jnp
        from repro.compat import make_mesh
        from repro.distributed import pipeline as pp
        w, xs = np.load(sys.argv[1]), np.load(sys.argv[2])
        mesh = make_mesh(({P},), ("pipe",))
        out = pp.pipeline_apply(lambda p, x: jnp.tanh(x @ p["w"]) + x,
                                {{"w": jnp.asarray(w)}}, jnp.asarray(xs),
                                mesh=mesh)
        np.save(sys.argv[3], np.asarray(out))
        print(json.dumps({{"ok": True}}))
    """)
    paths = [str(tmp_path / f"{n}.npy") for n in "wxo"]
    np.save(paths[0], w)
    np.save(paths[1], xs)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code, *paths], env=env,
                         capture_output=True, text=True, timeout=420)
    assert out.returncode == 0, out.stderr[-3000:]
    want = np.load(paths[2])
    got, _ = _run_port(w, xs)
    assert got.shape == (M, MB, D)
    assert float(np.abs(got.numpy() - want).max()) < 1e-5


@pytest.mark.parametrize("seed", [0, 1])
def test_pipeline_equals_sequential_bitwise(seed):
    w, xs = _inputs(seed)
    got, _ = _run_port(w, xs)
    seq = pp.sequential_apply(_layer, {"w": torch.from_numpy(w)},
                              torch.from_numpy(xs))
    assert torch.equal(got, seq)


def test_pipeline_takes_per_stage_params_as_a_list():
    w, xs = _inputs()
    mesh = Mesh(["cpu"] * P, axes=("pipe",))
    stages = [{"w": torch.from_numpy(w[i])} for i in range(P)]
    got = pp.pipeline_apply(_layer, stages, torch.from_numpy(xs), mesh=mesh)
    assert torch.equal(got, pp.sequential_apply(_layer, stages,
                                                torch.from_numpy(xs)))


def test_bubble_fraction():
    assert pp.bubble_fraction(P, M) == pytest.approx(3 / 9, abs=1e-12)
    assert pp.bubble_fraction(4, 8) == pytest.approx(3 / 11, abs=1e-12)
    assert pp.bubble_fraction(1, 8) == 0.0


@pytest.mark.parametrize("n_stages", [1, 2, 4])
def test_ppermute_count_is_the_schedules(n_stages):
    """One ``ppermute`` a step that has an activation to hand on: M + P - 2
    over the M + P - 1 steps (none with one stage), each counted in the
    mesh's ``transfers`` and nowhere else."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((n_stages, D, D)) * 0.3).astype(np.float32)
    xs = rng.standard_normal((M, MB, D)).astype(np.float32)
    out, mesh = _run_port(w, xs, n_stages)
    want = M + n_stages - 2 if n_stages > 1 else 0
    assert mesh.transfers == {"pipe": want}
    assert mesh.reductions == {"pipe": 0} and mesh.gathers == {"pipe": 0}
    assert torch.equal(out, pp.sequential_apply(
        _layer, {"w": torch.from_numpy(w)}, torch.from_numpy(xs)))


def test_pipeline_needs_a_pipe_mesh():
    w, xs = _inputs()
    with pytest.raises(ValueError):
        pp.pipeline_apply(_layer, {"w": torch.from_numpy(w)},
                          torch.from_numpy(xs),
                          mesh=Mesh([["cpu"] * 2] * 2))


def test_mesh_collectives_over_named_axes():
    """The generalised mesh: a 2 x 3 x 2 grid over (pod, data, model),
    ``ppermute`` (zeros where nothing is sent), ``all_gather`` (stacked in
    axis order) and ``reduce`` along the middle axis, each counted on its
    axis only."""
    mesh = Mesh([[["cpu"] * 2] * 3] * 2, axes=("pod", "data", "model"))
    assert mesh.shape == {"pod": 2, "data": 3, "model": 2}
    parts = [[[torch.full((2,), float(100 * p + 10 * d + m)) for m in range(2)]
              for d in range(3)] for p in range(2)]
    moved = mesh.ppermute("data", parts, [(0, 1), (1, 2)])
    for p in range(2):
        for m in range(2):
            assert torch.equal(moved[p][0][m], torch.zeros(2))
            assert torch.equal(moved[p][1][m], parts[p][0][m])
            assert torch.equal(moved[p][2][m], parts[p][1][m])
    gathered = mesh.all_gather("data", parts)
    assert torch.equal(gathered[1][2][0], torch.stack(
        [parts[1][d][0] for d in range(3)]))
    summed = mesh.reduce("data", parts)
    assert torch.equal(summed[0][1][1], parts[0][0][1] + parts[0][1][1]
                       + parts[0][2][1])
    assert mesh.transfers == {"pod": 0, "data": 1, "model": 0}
    assert mesh.gathers == {"pod": 0, "data": 1, "model": 0}
    assert mesh.reductions == {"pod": 0, "data": 1, "model": 0}
    with pytest.raises(ValueError):
        mesh.ppermute("data", parts, [(0, 1), (2, 1)])  # one destination twice
    with pytest.raises(ValueError):
        mesh.all_gather("pipe", parts)
    with pytest.raises(ValueError):
        Mesh([["cpu"] * 2] * 2, axes=("data", "rows"))


def test_the_collective_counter_sees_the_pipelines_transfers():
    """``roofline.collective_bytes`` counts each ``Mesh`` collective once a
    call with one shard's operand bytes: the pipeline's M + P - 2
    ``ppermute``s of one microbatch's activations."""
    from repro_torch.launch import roofline as R

    w, xs = _inputs()
    got = R.collective_bytes(_run_port, w, xs)
    assert got["counts"]["collective-permute"] == M + P - 2
    assert got["collective-permute"] == (M + P - 2) * MB * D * 4
    assert got["total"] == got["collective-permute"]
    assert sum(got["counts"].values()) == M + P - 2
