"""The port's paged decode attention (``repro_torch.kernels.flash_decode``)
against the reference's, run as the reference's own tests run it on the
CPU (the Pallas kernel in interpret mode, and its dense ``flash_decode_ref``).

On the CPU ``ops.flash_decode`` takes the plain version (``ref.py``) and
launches nothing; the CUDA kernel is held against that plain version on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: the flash path within atol = rtol = 2e-5 of the reference's
kernel, the reference's own tolerance for its kernel (an online softmax
against one dense softmax, fp32 sums in another order); the dense path
within 1e-6 of the reference's dense path (the same function, fp32 einsums
in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import kernel as rk
from repro.kernels.flash_decode import ops as rfd
from repro_torch.kernels.flash_decode import kernel as rk_torch
from repro_torch.kernels.flash_decode import ops as fd
from repro_torch.kernels.flash_decode import ref as fd_ref

B, G, REP, DH = 3, 2, 2, 16
# every boundary case for bs=8, W=3 (tests/test_flash_decode.py): single
# position, one short block, exactly one block, off-boundary, at-boundary
# with an empty tail block, and the completely full table
BOUNDARY_LENS = [(1, 1, 1), (3, 8, 9), (8, 16, 24), (9, 17, 23),
                 (16, 24, 8), (24, 24, 24)]


def _quant(t):
    amax = jnp.max(jnp.abs(t), axis=-1, keepdims=True)
    scale = amax.astype(jnp.float32) / 127.0 + 1e-9
    q = jnp.clip(jnp.round(t / scale), -127, 127).astype(jnp.int8)
    return q, scale


def _torch(a) -> torch.Tensor:
    """A reference array as a tensor of the same dtype (bf16 through fp32,
    which holds it exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _setup(bs, width, kv_dtype, seed=0):
    """Random pool + a table mapping each row to `width` distinct blocks, for
    both packages."""
    nbp = B * width + 1  # + trash block
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    q = jax.random.normal(ks[0], (B, G, REP, DH), jnp.float32)
    kf = jax.random.normal(ks[1], (nbp, bs, G, DH), jnp.float32)
    vf = jax.random.normal(ks[2], (nbp, bs, G, DH), jnp.float32)
    if kv_dtype == "int8":
        kq, ksc = _quant(kf)
        vq, vsc = _quant(vf)
        pool = {"k": kq, "v": vq, "k_scale": ksc, "v_scale": vsc}
    else:
        pool = {"k": kf.astype(jnp.bfloat16), "v": vf.astype(jnp.bfloat16)}
    table = jnp.arange(B * width, dtype=jnp.int32).reshape(B, width)
    tpool = {k: _torch(v) for k, v in pool.items()}
    return (q, pool, table), (_torch(q), tpool, _torch(table))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("lens", BOUNDARY_LENS)
def test_flash_path_matches_the_reference_kernel(kv_dtype, lens):
    (q, pool, table), (tq, tpool, ttable) = _setup(8, 3, kv_dtype)
    kv_lens = jnp.asarray(lens, jnp.int32)
    want = np.asarray(rfd.flash_decode(q, pool, table, kv_lens,
                                       use_flash=True, interpret=True))
    launches, calls = fd.launches, fd.plain_calls
    got = fd.flash_decode(tq, tpool, ttable, _torch(kv_lens))
    assert fd.launches == launches  # a CPU tensor launches nothing
    assert fd.plain_calls == calls + 1
    assert got.dtype == torch.float32 and got.shape == (B, G, REP, DH)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_dense_path_matches_the_reference_dense_path(kv_dtype):
    (q, pool, table), (tq, tpool, ttable) = _setup(8, 3, kv_dtype)
    kv_lens = jnp.asarray([5, 16, 23], jnp.int32)
    want = np.asarray(rfd.flash_decode(q, pool, table, kv_lens,
                                       use_flash=False))
    calls = fd.plain_calls
    got = fd.flash_decode(tq, tpool, ttable, _torch(kv_lens), use_flash=False)
    assert fd.plain_calls == calls  # the dense path is not the flash path
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_single_block_table():
    """W=1: the whole KV window is one (possibly partial) block."""
    (q, pool, table), (tq, tpool, ttable) = _setup(4, 1, "bf16")
    kv_lens = jnp.asarray([1, 3, 4], jnp.int32)
    want = np.asarray(rfd.flash_decode(q, pool, table, kv_lens,
                                       interpret=True))
    got = fd.flash_decode(tq, tpool, ttable, _torch(kv_lens))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_cross_block_size_stability():
    """The same logical KV content served at block sizes 4, 8 and 24 agrees
    within the kernel tolerance, and each matches the reference's kernel at
    that block size."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, G, REP, DH)).astype(np.float32)
    S = 24  # logical positions per row
    kf = rng.standard_normal((B, S, G, DH)).astype(np.float32)
    vf = rng.standard_normal((B, S, G, DH)).astype(np.float32)
    kv_lens = np.asarray([5, 17, 24], np.int32)
    outs = []
    for bs in (4, 8, 24):
        width = S // bs
        trash = np.zeros((1, bs, G, DH), np.float32)
        kp = np.concatenate([kf.reshape(B * width, bs, G, DH), trash])
        vp = np.concatenate([vf.reshape(B * width, bs, G, DH), trash])
        table = np.arange(B * width, dtype=np.int32).reshape(B, width)
        pool = {"k": jnp.asarray(kp).astype(jnp.bfloat16),
                "v": jnp.asarray(vp).astype(jnp.bfloat16)}
        got = fd.flash_decode(torch.from_numpy(q),
                              {k: _torch(v) for k, v in pool.items()},
                              torch.from_numpy(table),
                              torch.from_numpy(kv_lens)).numpy()
        want = np.asarray(rfd.flash_decode(jnp.asarray(q), pool,
                                           jnp.asarray(table),
                                           jnp.asarray(kv_lens),
                                           interpret=True))
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        outs.append(got)
    np.testing.assert_allclose(outs[0], outs[1], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(outs[0], outs[2], rtol=2e-5, atol=2e-5)


def test_int8_requires_scales():
    (q, pool, table), (tq, tpool, ttable) = _setup(8, 2, "int8")
    lens = torch.tensor([1, 1, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="requires k_scale/v_scale"):
        rk.flash_decode(q, pool["k"], pool["v"], table,
                        jnp.asarray([1, 1, 1], jnp.int32))
    with pytest.raises(ValueError, match="requires k_scale/v_scale"):
        fd.flash_decode(tq, {"k": tpool["k"], "v": tpool["v"]}, ttable, lens)
    with pytest.raises(ValueError, match="requires k_scale/v_scale"):
        fd_ref.flash_decode_ref(tq, tpool["k"], tpool["v"], ttable, lens)


def test_zero_length_rows():
    """kv_lens = 0: the flash path gives exact zeros, as the reference's
    Pallas kernel does; the dense path gives the reference dense path's
    mean of V over the table window (a softmax over all -1e30 is
    uniform)."""
    (q, pool, table), (tq, tpool, ttable) = _setup(8, 2, "bf16")
    kv_lens = jnp.asarray([0, 5, 0], jnp.int32)
    tl = _torch(kv_lens)
    flash = fd.flash_decode(tq, tpool, ttable, tl)
    assert bool(torch.isfinite(flash).all())
    assert torch.equal(flash[0], torch.zeros_like(flash[0]))
    assert torch.equal(flash[2], torch.zeros_like(flash[2]))
    np.testing.assert_array_equal(
        np.asarray(rfd.flash_decode(q, pool, table, kv_lens,
                                    interpret=True))[[0, 2]], 0.0)
    dense = fd.flash_decode(tq, tpool, ttable, tl, use_flash=False)
    want = np.asarray(rfd.flash_decode_ref(q, pool["k"], pool["v"], table,
                                           kv_lens))
    np.testing.assert_allclose(dense.numpy(), want, rtol=1e-6, atol=1e-6)
    # row 0's window [W * bs, G, dh]
    v = tpool["v"][ttable[0].long()].float().reshape(-1, G, DH)
    mean_v = v.mean(0)[:, None, :].expand(G, REP, DH)
    torch.testing.assert_close(dense[0], mean_v, rtol=1e-6, atol=1e-6)


# -- the CUDA kernel's split-KV arithmetic, checked on the CPU ---------------
#
# On the card a cluster of S blocks serves each (row, KV head): block `rank`
# takes the positions kernel.split_range gives it, leaves (m, l, acc) of
# that range, and rank 0 merges the S states in rank order.  The emulation
# below does the same in fp32 torch; it must give the plain version's result
# within 2e-6 (fp32 sums in another order), with exact zeros for rows of
# length 0 and empty ranges merged away.

SERVE_SMS = 132  # an H100 SXM's SMs


@pytest.mark.parametrize("batch,kv_heads,window,sms", [
    (32, 8, 560, SERVE_SMS), (1, 8, 560, SERVE_SMS), (3, 2, 24, SERVE_SMS),
    (64, 8, 4096, SERVE_SMS), (1, 1, 1 << 20, SERVE_SMS), (7, 3, 200, 16),
    (1024, 8, 560, SERVE_SMS), (1, 1, 1, 1)])
def test_split_count_is_a_power_of_two_up_to_the_cluster_size(
        batch, kv_heads, window, sms):
    s = rk_torch.split_count(batch, kv_heads, window, sms)
    assert s in (1, 2, 4, 8)
    assert s == 1 or window // s >= rk_torch.MIN_SPLIT  # the floor
    # the smallest such count: half of it would not fill the card or keep
    # the floor
    if s > 1:
        assert (s // 2) * batch * kv_heads < rk_torch.BLOCKS_PER_SM * sms


def test_split_count_fills_the_card_at_the_serving_shape():
    """Llama 3.2 3B at 32 slots: 8 KV heads, a 560-position window."""
    s = rk_torch.split_count(32, 8, 560, SERVE_SMS)
    assert s * 32 * 8 >= rk_torch.BLOCKS_PER_SM * SERVE_SMS
    assert (s // 2) * 32 * 8 < rk_torch.BLOCKS_PER_SM * SERVE_SMS
    assert s == 2


@pytest.mark.parametrize("window,want", [
    (1, 1), (64, 1), (127, 1), (128, 2), (255, 2), (256, 4), (511, 4),
    (512, 8), (560, 8)])
def test_split_count_keeps_its_floor_at_small_windows(window, want):
    """One row of one head would take 8 blocks; the window caps it."""
    assert rk_torch.split_count(1, 1, window, SERVE_SMS) == want


@pytest.mark.parametrize("splits", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("span", [1, 32, 64, 256])
def test_split_ranges_partition_every_row(splits, span):
    for length in list(range(0, 130)) + [255, 256, 257, 560, 4097]:
        ranges = [rk_torch.split_range(length, splits, r, span)
                  for r in range(splits)]
        assert ranges[0][0] == 0 and ranges[-1][1] == length
        for (a, b), (c, d) in zip(ranges, ranges[1:]):
            assert a <= b == c <= d  # in rank order, no gap, no overlap
        for a, b in ranges[:-1]:
            assert b == length or (b - a) % span == 0  # whole spans


def _split_merge(q, kp, vp, table, lens, splits, span, ks=None, vs=None):
    """(m, l, acc) of each rank's positions, merged in rank order."""
    B, G, rep, dh = q.shape
    bs = kp.shape[1]
    out = torch.full_like(q, float("nan"))
    for b in range(B):
        n = int(lens[b])
        pos = torch.arange(n)
        ids, off = table[b, pos // bs].long(), pos % bs
        k, v = kp[ids, off].float(), vp[ids, off].float()  # [n, G, dh]
        if ks is not None:
            k, v = k * ks[ids, off], v * vs[ids, off]
        parts = []
        for rank in range(splits):
            lo, hi = rk_torch.split_range(n, splits, rank, span)
            if lo == hi:
                parts.append((torch.full((G, rep), -1e30),
                              torch.zeros(G, rep), torch.zeros(G, rep, dh)))
                continue
            s = torch.einsum("grd,tgd->grt", q[b], k[lo:hi])
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(-1),
                          torch.einsum("grt,tgd->grd", p, v[lo:hi])))
        mx = parts[0][0]
        for m, _, _ in parts[1:]:
            mx = torch.maximum(mx, m)
        l_sum, acc = torch.zeros(G, rep), torch.zeros(G, rep, dh)
        for m, l_part, a_part in parts:
            e = torch.exp(m - mx)
            l_sum = l_sum + l_part * e
            acc = acc + a_part * e[..., None]
        out[b] = acc / l_sum.clamp_min(1e-30)[..., None]
    return out


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_split_and_merge_gives_the_plain_result(kv_dtype, splits):
    from repro_torch.nn.layers import _quant_kv

    b, g, rep, dh, bs, width = 9, 2, 3, 128, 16, 12
    rng = np.random.default_rng(splits)
    q = torch.from_numpy(rng.standard_normal((b, g, rep, dh), np.float32)
                         * np.float32(dh ** -0.5))
    k = torch.from_numpy(rng.standard_normal((b * width + 1, bs, g, dh),
                                             np.float32))
    v = torch.from_numpy(rng.standard_normal((b * width + 1, bs, g, dh),
                                             np.float32))
    if kv_dtype == "int8":
        (kp, ks), (vp, vs) = _quant_kv(k), _quant_kv(v)
    else:
        kp, vp, ks, vs = k.to(torch.bfloat16), v.to(torch.bfloat16), None, None
    table = torch.from_numpy(rng.permutation(b * width).astype(np.int32)
                             .reshape(b, width))
    span = rk_torch.tile(dh, rep)
    # lengths of 0, on and next to the span's multiples, the full window
    lens = torch.tensor([0, 1, span - 1, span, span + 1, 2 * span + 1, 100,
                         0, bs * width], dtype=torch.int32)
    got = _split_merge(q, kp, vp, table, lens, splits, span, ks, vs)
    want = fd_ref.flash_decode_plain(q, kp, vp, table, lens, ks, vs)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=2e-6)
    for row in (0, 7):
        assert torch.equal(got[row], torch.zeros_like(got[row]))
