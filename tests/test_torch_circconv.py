"""The port's circular convolution (``repro_torch.kernels.circconv``) against
the reference's Pallas kernels (interpret mode) and their oracle.

Inputs are made with numpy (bf16 by round to nearest on both sides, so both
packages see the same values).  Tolerances are the reference test's
(``tests/test_kernels.py``): rows atol ``tol * sqrt(L)``, rtol ``tol`` with
tol 1e-4 in fp32 and 0.15 in bf16; the single-row kernel atol 1e-3, rtol 1e-4.
On the CPU the ops send every tensor to the plain versions, so the kernels'
launch counters stay at 0; the kernels are held against the plain versions on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.circconv import kernel as rk
from repro.kernels.circconv import ops as rops
from repro.kernels.circconv import ref as rref
from repro_torch.core import vsa as tv
from repro_torch.kernels.circconv import kernel as k
from repro_torch.kernels.circconv import ops
from repro_torch.kernels.circconv import ref

ROWS_CASES = [(1, 64), (4, 128), (32, 256), (7, 100), (130, 64), (16, 1024)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.15)}


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _pair(shape, seed, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    x, y = _normal(shape, seed), _normal(shape, seed + 1)
    return ((jnp.asarray(x, jdt), jnp.asarray(y, jdt)),
            (torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt)))


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


@pytest.mark.parametrize("n,L", ROWS_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_rows_match_the_reference_kernel(n, L, dtype):
    (jx, jy), (tx, ty) = _pair((n, L), n * 1000 + L, dtype)
    tol = DTYPES[dtype][2]
    want_kernel = _f32(rk.circconv_rows(jx, jy, interpret=True))
    want_ref = _f32(rref.circconv_rows_ref(jx, jy))
    plain = ref.circconv_rows_ref(tx, ty)
    assert plain.dtype == torch.float32
    np.testing.assert_allclose(_f32(plain), want_ref, atol=1e-4 * np.sqrt(L),
                               rtol=1e-4)  # both fp32 sums of equal inputs
    got = ops.block_circconv(tx, ty)  # the CPU path: x's dtype, as the kernel
    assert got.dtype == tx.dtype and got.shape == (n, L)
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(_f32(got), want, atol=tol * np.sqrt(L),
                                   rtol=tol)


@pytest.mark.parametrize("L,tile", [(512, 128), (1024, 256), (777, 256)])
def test_plain_single_matches_the_reference_kernel(L, tile):
    (jx, jy), (tx, ty) = _pair((L,), L, "float32")
    want = _f32(rk.circconv_single_mxu(jx, jy, tile=tile, interpret=True))
    np.testing.assert_allclose(_f32(ref.circconv_single_ref(tx, ty)), want,
                               atol=1e-3, rtol=1e-4)
    got = ops.block_circconv(tx[None], ty[None])[0]  # the single-row route
    np.testing.assert_allclose(_f32(got), want, atol=1e-3, rtol=1e-4)


def test_block_circcorr_is_unbind():
    x, y = _normal((4, 2, 128), 0), _normal((4, 2, 128), 1)
    b = ops.block_circconv(torch.from_numpy(x), torch.from_numpy(y))
    out = ops.block_circcorr(b, torch.from_numpy(y))
    cfg = tv.VSAConfig(256, 2)
    unb = tv.unbind(cfg.flatten(b), cfg.flatten(torch.from_numpy(y)), cfg)
    np.testing.assert_allclose(out.numpy(), cfg.blockify(unb).numpy(),
                               atol=1e-3, rtol=1e-5)  # values up to ~300
    want = rref.circcorr_rows_ref(jnp.asarray(b.numpy()).reshape(-1, 128),
                                  jnp.asarray(y).reshape(-1, 128))
    np.testing.assert_allclose(out.reshape(-1, 128).numpy(), want, atol=1e-3,
                               rtol=1e-3)  # the reference test's tolerance
    np.testing.assert_allclose(
        out.numpy(), np.asarray(rops.block_circcorr(jnp.asarray(b.numpy()),
                                                    jnp.asarray(y))),
        atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("shape,scheme", [
    ((1, 512), "single"), ((1, 2048), "single"), ((1, 1, 1, 1024), "single"),
    ((1, 511), "rows"), ((2, 512), "rows"), ((4096, 256), "rows"),
    ((3, 2, 8, 64), "rows"),
])
def test_block_circconv_routes_by_the_st_mapping_rule(monkeypatch, shape,
                                                      scheme):
    """One row with L >= 512 takes the single-row scheme, anything else the
    rows scheme (reference ``ops.py:32``); the CPU's plain versions stand in
    for the kernels of the same route."""
    calls = []
    monkeypatch.setattr(ref, "circconv_rows_ref",
                        lambda x, y: calls.append(("rows", x.shape)) or x)
    monkeypatch.setattr(ref, "circconv_single_ref",
                        lambda x, y: calls.append(("single", x.shape)) or x)
    L = shape[-1]
    out = ops.block_circconv(torch.zeros(shape), torch.zeros(shape))
    assert out.shape == shape
    rows = int(np.prod(shape[:-1]))
    assert calls == [(scheme, (L,) if scheme == "single" else (rows, L))]
    assert ops.uses_single(rows, L) == (scheme == "single")


def test_cpu_tensors_launch_no_kernel():
    before = (ops.rows_launches, ops.single_launches)
    x = torch.from_numpy(_normal((3, 2, 8, 64), 5))
    ops.block_circconv(x, x)
    ops.block_circcorr(x, x)
    row = torch.from_numpy(_normal((1, 1024), 9))  # the single-row route
    ops.block_circconv(row, row)
    cfg = tv.VSAConfig(2048, 1, impl="pallas")
    v = torch.from_numpy(_normal((2048,), 6))
    tv.unbind(tv.bind(v, v, cfg), v, cfg)
    assert (ops.rows_launches, ops.single_launches) == before == (0, 0)


def test_both_operands_broadcast_and_mixed_dtypes_sum_in_fp32():
    x = torch.from_numpy(_normal((3, 1, 2, 64), 7))
    y = torch.from_numpy(_normal((1, 4, 2, 64), 8))
    got = ops.block_circconv(x, y)
    assert got.shape == (3, 4, 2, 64)
    want = ref.block_circconv_ref(x.expand(3, 4, 2, 64).contiguous(),
                                  y.expand(3, 4, 2, 64).contiguous())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="broadcast"):
        rops.block_circconv(jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))
    mixed = ops.block_circconv(x.to(torch.bfloat16), y)
    assert mixed.dtype == torch.bfloat16
    want = ref.block_circconv_ref(
        x.to(torch.bfloat16).float().expand(3, 4, 2, 64).contiguous(),
        y.expand(3, 4, 2, 64).contiguous())
    np.testing.assert_array_equal(mixed.float().numpy(),
                                  want.to(torch.bfloat16).float().numpy())


def test_launch_geometry_and_limits():
    assert k.rows_geometry(4096, 256) == (256, 8, 32, 8 * (3 * 256 + 8) * 4)
    assert k.rows_geometry(7, 100) == (104, 7, 13, 7 * (3 * 104 + 8) * 4)
    assert k.rows_geometry(1, 1) == (8, 1, 1, (3 * 8 + 8) * 4)
    Lp, R, tpr, smem = k.rows_geometry(3, k.MAX_L)
    assert (Lp, R, tpr) == (k.MAX_L, 1, 256) and smem <= 227 * 1024
    assert k.single_geometry(777) == (784, 13, (2 * 784 + 64 + 8 + 32 * 64) * 4)
    assert k.single_geometry(k.MAX_L)[2] <= 227 * 1024
    for bad in (lambda: k.rows_geometry(1, k.MAX_L + 1),
                lambda: k.rows_geometry(0, 64),
                lambda: k.single_geometry(k.MAX_L + 1)):
        with pytest.raises(ValueError):
            bad()


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        k.circconv_rows(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        k.circconv_single(x[0], x[0])
