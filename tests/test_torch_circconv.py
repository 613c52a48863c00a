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
import math

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
    # single: tiles of 64 outputs, each a cluster of C blocks splitting k
    assert k.single_geometry(777) == (784, 13, 8, 104,
                                      (2 * 104 + 64 + 8 + 8 * 64) * 4)
    Lp, tiles, csize, ks, _ = k.single_geometry(2048)  # the HRR corner
    assert (tiles, csize, ks) == (32, 4, 512) and tiles * csize >= 128
    assert k.single_geometry(k.MAX_L)[4] <= 227 * 1024
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


# ---- the broadcast plan, the mode rule and the tensor-core arithmetic ----

N_ITEMS, BLOCKS, L_MIMO = 256, 8, 256  # MIMONet's batch: D = 2048, B = 8
# (x shape, y shape, mode): x, y broadcast to one shape as block_circconv
# does; MIMONet's bind is emb [N, S, B, L] with keys [1, S, B, L], its
# unbind out [N, 1, B, L] with the involuted keys.
PLAN_CASES = {
    "bind S=2": ((N_ITEMS, 2, BLOCKS, L_MIMO), (1, 2, BLOCKS, L_MIMO), "mma"),
    "unbind S=2": ((N_ITEMS, 1, BLOCKS, L_MIMO), (1, 2, BLOCKS, L_MIMO),
                   "mma"),
    "bind S=4": ((N_ITEMS, 4, BLOCKS, L_MIMO), (1, 4, BLOCKS, L_MIMO), "mma"),
    "unbind S=4": ((N_ITEMS, 1, BLOCKS, L_MIMO), (1, 4, BLOCKS, L_MIMO),
                   "mma"),
    "x stationary": ((1, 3, 128), (40, 3, 128), "mma"),
    "both broadcast": ((3, 1, 2, 64), (1, 4, 2, 64), "direct"),
    "neither": ((5, 2, 64), (5, 2, 64), "direct"),
    "group below the rule": ((k.MMA_MIN_ROWS - 1, 2, 128), (1, 2, 128),
                             "direct"),
    "group at the rule": ((k.MMA_MIN_ROWS, 2, 128), (1, 2, 128), "mma"),
    "one row": ((1, 1, 64), (1, 1, 64), "direct"),
}


def _launch_rows(plan):
    """(x, y, out) offsets of every row of a launch, as the kernel's
    ``offsets`` computes them: row r's digits over the plan's sizes."""
    sizes = [d[0] for d in plan.dims]
    for r in range(math.prod(sizes)):
        digits = np.unravel_index(r, sizes) if sizes else ()
        yield tuple(sum(int(i) * d[c] for i, d in zip(digits, plan.dims))
                    for c in (1, 2, 3))


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_rows_plan_reads_the_expanded_rows(case):
    xshape, yshape, mode = PLAN_CASES[case]
    shape = torch.broadcast_shapes(xshape, yshape)
    L = shape[-1]
    xb = torch.from_numpy(_normal(xshape, 1))
    yb = torch.from_numpy(_normal(yshape, 2))
    if case == "neither":  # a strided view: every other row of a larger x
        xb = torch.from_numpy(_normal((5, 4, L), 1))[:, ::2]
    x, y = xb.expand(shape), yb.expand(shape)
    plan = k.rows_plan(shape, x.stride(), y.stride())
    assert plan.mode == mode and len(plan.dims) <= k.MAX_DIMS
    assert plan.groups * plan.group_rows == math.prod(shape[:-1])
    a, b = (y, x) if plan.swap else (x, y)
    want_a = (x if not plan.swap else y).contiguous().reshape(-1, L)
    want_b = (y if not plan.swap else x).contiguous().reshape(-1, L)
    seen, stationary = [], set()
    for r, (oa, ob, oo) in enumerate(_launch_rows(plan)):
        row = oo // L
        assert oo % L == 0
        got_a = torch.as_strided(a, (L,), (1,), a.storage_offset() + oa)
        got_b = torch.as_strided(b, (L,), (1,), b.storage_offset() + ob)
        assert torch.equal(got_a, want_a[row]) and torch.equal(got_b,
                                                               want_b[row])
        seen.append(row)
        if plan.mode == "mma":  # a group's rows share one row of y
            stationary.add((r // plan.group_rows, ob))
    assert sorted(seen) == list(range(math.prod(shape[:-1])))
    if plan.mode == "mma":
        assert len(stationary) == plan.groups
        assert plan.swap == (case == "x stationary")
    if case.startswith("unbind"):  # out rows read once a stream, not copied
        assert plan.dims[-1][:3] == (N_ITEMS, BLOCKS * L_MIMO, 0)


def test_rows_plan_gives_up_only_where_views_cannot_be_read():
    shape = (2, 2, 2, 2, 2, 64)  # broadcast alternating over five dims
    x = torch.zeros((2, 1, 2, 1, 2, 64)).expand(shape)
    y = torch.zeros((1, 2, 1, 2, 1, 64)).expand(shape)
    assert k.rows_plan(shape, x.stride(), y.stride()) is None
    t = torch.zeros((64, 4)).t()  # L not unit-stride
    assert k.rows_plan(t.shape, t.stride(), t.stride()) is None
    one = torch.zeros((3, 1))  # L = 1 has no stride to honour
    assert k.rows_plan(one.shape, (1, 5), (1, 5)).mode == "direct"


@pytest.mark.parametrize("group_rows,L,aligned,mode", [
    (k.MMA_MIN_ROWS - 1, 256, True, "direct"), (k.MMA_MIN_ROWS, 256, True,
                                                "mma"),
    (256, 256, True, "mma"), (256, 100, True, "direct"),
    (256, 64, True, "direct"), (256, k.MMA_MAX_L, True, "mma"),
    (256, 2 * k.MMA_MAX_L, True, "direct"),
    (256, 256, False, "direct"), (1, 256, True, "direct"),
])
def test_rows_mode_rule(group_rows, L, aligned, mode):
    assert k.rows_mode(group_rows, L, aligned) == mode
    if mode == "mma":
        blocks, smem = k.mma_geometry(4, group_rows, L, 4)
        assert blocks == 4 * -(-group_rows // 64) * (L // 128)
        assert smem <= 227 * 1024


def test_mma_tiles_fill_the_card_at_mimonets_shapes():
    for S, blocks in ((2, 128), (4, 256)):
        assert k.mma_geometry(S * BLOCKS, N_ITEMS, L_MIMO, 4)[0] == blocks


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """Round fp32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32``: add half of the 13 dropped bits, mask."""
    bits = (v.view(torch.int32) + (1 << 12)) & ~((1 << 13) - 1)
    return bits.view(torch.float32)


def test_3xtf32_split_meets_the_fp32_tolerance_and_one_product_does_not():
    """The tensor-core mode's arithmetic in plain torch at the MIMONet
    unbind shape (256 items x 8 blocks, each against 2 x 8 keys, L = 256):
    3 TF32 products (small.big + big.small + big.big, fp32 sums) stay
    within phase 19's fp32 tolerance (atol 1e-4 sqrt(L), rtol 1e-4) of an
    fp64 circular convolution; one TF32 product does not."""
    L = L_MIMO
    x = torch.from_numpy(_normal((N_ITEMS, BLOCKS, L), 11))  # out rows
    y = torch.from_numpy(_normal((2, BLOCKS, L), 12))  # involuted keys
    n = torch.arange(L)
    circ = y[..., (n[None, :] - n[:, None]) % L]  # [S, B, k, n]
    want = torch.einsum("ibk,sbkn->isbn", x.double(), circ.double())
    xb, cb = _tf32(x), _tf32(circ)
    xs, cs = _tf32(x - xb), _tf32(circ - cb)

    def prod(a, c):  # each group's [items x k] @ [k x n] in fp32
        return torch.einsum("ibk,sbkn->isbn", a, c)

    three = prod(xs, cb) + prod(xb, cs) + prod(xb, cb)
    one = prod(xb, cb)
    atol, rtol = 1e-4 * L ** 0.5, 1e-4
    np.testing.assert_allclose(three.double().numpy(), want.numpy(),
                               atol=atol, rtol=rtol)
    assert not np.allclose(one.double().numpy(), want.numpy(), atol=atol,
                           rtol=rtol)
