"""The port's int8 gradient compression (``repro_torch.distributed.
compression``) against the reference's: payloads, scales and error-feedback
state bit-equal on the same gradients; the all-reduce over a logical
``data`` mesh bit-equal to the reference's ``psum``/``pmax`` (run under
``jax.vmap`` with a named axis); and the reference test's least-squares
problem on 8 data shards converging within its bounds (exact < 1e-2, int8
< 5e-2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as RC
from repro_torch.distributed import compression as C
from repro_torch.launch.mesh import make_host_mesh


def _grads(seed, shards=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(shards):
        out.append({"w": (rng.standard_normal((16, 4)) * 0.3).astype(
            np.float32),
            "layer": {"b": rng.standard_normal((7,)).astype(np.float32),
                      "k": (rng.standard_normal((3, 5)) * 1e-4).astype(
                          np.float32)}})
    return out


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _n(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_bit_equals_the_reference_over_steps(seed):
    """Three rounds of error feedback on fresh gradients each: the int8
    payloads, the fp32 scales and the carried error state bit-equal."""
    err_r = RC.init_error_state(_grads(seed)[0])
    err_t = C.init_error_state(_t(_grads(seed)[0]))
    for step in range(3):
        g = _grads(seed * 10 + step)[0]
        qr, sr, err_r = RC.compress_gradients(jax.tree.map(jnp.asarray, g),
                                              err_r)
        qt, st, err_t = C.compress_gradients(_t(g), err_t)
        for a, b in zip(jax.tree.leaves(qr), jax.tree.leaves(_n(qt))):
            assert b.dtype == np.int8
            np.testing.assert_array_equal(np.asarray(a), b)
        for a, b in zip(jax.tree.leaves(sr), jax.tree.leaves(_n(st))):
            np.testing.assert_array_equal(np.asarray(a), b)
        for a, b in zip(jax.tree.leaves(err_r), jax.tree.leaves(_n(err_t))):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_allreduce_bit_equals_the_references_psum_and_pmax():
    D = 8
    gs = _grads(4, D)
    qs, ss = [], []
    for g in gs:
        q, s, _ = C.compress_gradients(_t(g), C.init_error_state(_t(g)))
        qs.append(q)
        ss.append(s)
    mesh = make_host_mesh(D, 1, device="cpu")
    got = C.allreduce_compressed(qs, ss, mesh.axis("data"))
    assert mesh.reductions == {"data": 2 * 3, "model": 0}  # a sum, a max
    stack = lambda trees: jax.tree.map(lambda *xs: jnp.stack(xs),
                                       *[_n(t) for t in trees])
    want = jax.vmap(lambda q, s: RC.allreduce_compressed(q, s, "data"),
                    axis_name="data")(stack(qs), stack(ss))
    for d in range(D):
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(_n(got[d]))):
            np.testing.assert_array_equal(np.asarray(a)[d], b)


def test_allreduce_needs_the_data_axis_and_a_tree_a_shard():
    mesh = make_host_mesh(2, 2, device="cpu")
    g = _t(_grads(0)[0])
    q, s, _ = C.compress_gradients(g, C.init_error_state(g))
    with pytest.raises(ValueError, match="'data'"):
        C.allreduce_compressed([q, q], [s, s], mesh.axis("model"))
    with pytest.raises(ValueError, match="2 data shards"):
        C.allreduce_compressed([q], [s], mesh.axis("data"))
    out = C.allreduce_compressed([q, q], [s, s], mesh.axis("data"))
    assert len(out) == 2 and out[0].keys() == g.keys()


def test_mesh_reduce_max_and_its_count():
    mesh = make_host_mesh(3, 2, device="cpu")
    parts = [[torch.tensor([float(d), float(-m)]) for m in range(2)]
             for d in range(3)]
    out = mesh.reduce("data", parts, op="max")
    assert torch.equal(out[1][1], torch.tensor([2.0, -1.0]))
    out = mesh.axis("model").reduce(parts, op="max")
    assert torch.equal(out[2][0], torch.tensor([2.0, 0.0]))
    assert mesh.reductions == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="'sum' and 'max'"):
        mesh.reduce("data", parts, op="min")


def test_wire_bytes():
    g = _t(_grads(0)[0])
    n = 16 * 4 + 7 + 15
    assert C.wire_bytes(g, True) == n
    assert C.wire_bytes(g, False) == 4 * n


def least_squares(device, compressed: bool, steps: int = 400,
                  shards: int = 8):
    """The reference test's problem: W* [16, 4], X [64, 16], Y = X W*;
    plain SGD at lr 0.05 on the mean of the shards' gradients of
    mean((x w - y)^2) over each shard's 8 rows, exact (fp32 mean) or int8
    with error feedback (each shard its own error state).  Returns the
    final full-batch loss."""
    rng = np.random.default_rng(0)
    wt = torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32))
    X = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    X, Y = X.to(device), (X @ wt).to(device)
    mesh = make_host_mesh(shards, 1, device=device)
    w = torch.zeros((16, 4), device=device)
    errs = [C.init_error_state({"w": w}) for _ in range(shards)]
    rows = X.shape[0] // shards
    for _ in range(steps):
        grads = []
        for d in range(shards):
            wd = w.clone().requires_grad_(True)
            x, y = X[d * rows:(d + 1) * rows], Y[d * rows:(d + 1) * rows]
            torch.mean((x @ wd - y) ** 2).backward()
            grads.append({"w": wd.grad})
        if compressed:
            qs, ss = [], []
            for d in range(shards):
                q, s, errs[d] = C.compress_gradients(grads[d], errs[d])
                qs.append(q)
                ss.append(s)
            gm = C.allreduce_compressed(qs, ss, mesh.axis("data"))[0]["w"]
        else:
            gm = mesh.reduce("data", [[g["w"]] for g in grads])[0][0] / shards
        w = w - 0.05 * gm
    return float(torch.mean((X @ w - Y) ** 2)), mesh.reductions["data"]


def test_gradient_compression_convergence():
    exact, n_exact = least_squares("cpu", False)
    int8, n_int8 = least_squares("cpu", True)
    assert exact < 1e-2
    assert int8 < 5e-2  # converges despite a quarter of fp32's bytes
    assert (n_exact, n_int8) == (400, 800)
