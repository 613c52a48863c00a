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


# -- the tensor-core kernel's arithmetic (rep 9-16), restated on the CPU -----
#
# From 9 query heads per KV head on, the card's kernel multiplies on the
# tensor cores in TF32: K and V enter exactly (bf16 widened, int8 before its
# scale), q and the probabilities P as two TF32 terms each (ref.tf32_split):
# S = q_hi.K + q_lo.K, times the k scale; O = P_hi.V + P_lo.V, P's columns
# times the v scale first.  The emulation below takes the products exactly
# and sums in fp64; it must meet the plain version and the reference's kernel
# within the kernel's contract, 2e-5, and one TF32 term must not.

STARCODER2 = dict(g=2, rep=12, dh=128, bs=16, width=35)  # starcoder2-3b


def _wide_inputs(b, g, rep, dh, bs, width, kv_dtype, seed):
    from repro_torch.nn.layers import _quant_kv

    rng = np.random.default_rng(seed)
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
    cap = bs * width
    lens = torch.from_numpy(rng.integers(1, cap + 1, b).astype(np.int32))
    lens[:2] = torch.tensor([0, cap])
    return q, kp, vp, table, lens, ks, vs


def _tf32_attention(q, kp, vp, table, lens, ks=None, vs=None, terms=2):
    """The tensor-core kernel's arithmetic: q and P as `terms` TF32 terms,
    exact products, fp64 sums, the softmax in fp32."""
    B, G, rep, dh = q.shape
    bs = kp.shape[1]

    def parts(x):
        hi, lo = fd_ref.tf32_split(x)
        return (hi, lo) if terms == 2 else (hi,)

    out = torch.zeros_like(q)
    for b in range(B):
        n = int(lens[b])
        if n == 0:
            continue
        pos = torch.arange(n)
        ids, off = table[b, pos // bs].long(), pos % bs
        k = kp[ids, off].float().double()  # [n, G, dh], exact
        v = vp[ids, off].float().double()
        s = sum(torch.einsum("grd,ngd->grn", t.double(), k)
                for t in parts(q[b])).float()
        if ks is not None:
            s = s * ks[ids, off, :, 0].T[:, None, :]
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        pv = p if vs is None else p * vs[ids, off, :, 0].T[:, None, :]
        o = sum(torch.einsum("grn,ngd->grd", t.double(), v)
                for t in parts(pv)).float()
        out[b] = o / p.sum(-1, keepdim=True)
    return out


def test_tf32_split_rounds_to_nearest_ties_away():
    one = 1.0
    x = torch.tensor([one, one + 2 ** -11, one + 3 * 2 ** -11,
                      -(one + 2 ** -11), 2 ** -130, 3.0e38])
    hi, lo = fd_ref.tf32_split(x)
    assert hi.tolist() == [one, one + 2 ** -10, one + 2 ** -9,
                           -(one + 2 ** -10), 2 ** -130, hi[5].item()]
    bits = hi.view(torch.int32) & 0x1FFF
    assert bool((bits == 0).all())  # 10 stored mantissa bits
    assert bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())
    g = torch.Generator().manual_seed(0)
    y = torch.randn(10000, generator=g) * 10
    hi, lo = fd_ref.tf32_split(y)
    assert bool(((hi - y).abs() <= y.abs() * 2 ** -11).all())
    assert bool(((hi + lo - y).abs() <= y.abs() * 2 ** -21).all())


def test_every_bf16_and_int8_value_is_exact_in_tf32():
    """K and V enter the tensor cores as they are: every finite bf16 value,
    and every int8 value, is a TF32 value."""
    bf = (torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
          .view(torch.bfloat16).float())
    bf = bf[torch.isfinite(bf)]
    assert bf.numel() == 2 ** 16 - 2 * 2 ** 7  # infinities and NaNs out
    i8 = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8).float()
    for x in (bf, i8):
        hi, lo = fd_ref.tf32_split(x)
        assert torch.equal(hi, x)
        assert bool((lo == 0).all())


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("rep", range(9, 17))
def test_two_tf32_terms_meet_the_plain_version_at_every_wide_rep(kv_dtype,
                                                                 rep):
    f = dict(STARCODER2, rep=rep)
    args = _wide_inputs(8, **f, kv_dtype=kv_dtype, seed=rep)
    got = _tf32_attention(*args)
    want = fd_ref.flash_decode_plain(*args)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("rep", [9, 12, 16])
def test_two_tf32_terms_meet_the_reference_kernel(kv_dtype, rep):
    """Against the reference's Pallas kernel in interpret mode, at
    starcoder2-3b's head shape (rep 12) and the ends of the wide reps."""
    f = dict(STARCODER2, rep=rep)
    q, kp, vp, table, lens, ks, vs = _wide_inputs(3, **f, kv_dtype=kv_dtype,
                                                  seed=40 + rep)
    got = _tf32_attention(q, kp, vp, table, lens, ks, vs)

    def jnp_(t):
        if t is None:
            return None
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(t.numpy())

    want = np.asarray(rk.flash_decode(
        jnp_(q), jnp_(kp), jnp_(vp), jnp_(table), jnp_(lens),
        k_scale=jnp_(ks), v_scale=jnp_(vs), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_one_tf32_term_breaks_the_contract(kv_dtype):
    """The negative control: q and P rounded to one TF32 term each miss the
    2e-5 contract at starcoder2-3b's shape, which two terms meet."""
    args = _wide_inputs(8, **STARCODER2, kv_dtype=kv_dtype, seed=12)
    want = fd_ref.flash_decode_plain(*args)
    one = _tf32_attention(*args, terms=1)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(one, want, atol=2e-5, rtol=2e-5)
    two = _tf32_attention(*args)
    assert (two - want).abs().max() * 100 < (one - want).abs().max()


def test_every_rep_is_one_launch_at_itself():
    """No rep is padded with zero query heads: each of 1..16 runs at itself
    (a template of its own up to 8, the tensor-core kernel from 9), and a
    split is rounded to the batch of the kernel that runs it."""
    assert rk_torch.REPS == tuple(range(1, 17))
    for rep in rk_torch.REPS:
        assert rk_torch.launch_rep(rep) == rep
        span = rk_torch.tile(128, rep)
        assert span == (rk_torch.WIDE_TILE if rep >= rk_torch.WIDE_MIN_REP
                        else (4 if rep <= 4 else 2) * 2)
    for rep in (0, 17, 24):
        with pytest.raises(ValueError, match="query heads"):
            rk_torch.launch_rep(rep)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("splits", [1, 2, 8])
def test_wide_split_and_merge_gives_the_plain_result(kv_dtype, splits):
    """The split algebra at the tensor-core kernel's batch (8 positions a
    warp) and starcoder2-3b's head shape."""
    q, kp, vp, table, _, ks, vs = _wide_inputs(9, **STARCODER2,
                                               kv_dtype=kv_dtype, seed=splits)
    span = rk_torch.tile(128, 12)
    lens = torch.tensor([0, 1, span - 1, span, span + 1, 2 * span + 1, 100,
                         0, 16 * 35], dtype=torch.int32)
    got = _split_merge(q, kp, vp, table, lens, splits, span, ks, vs)
    want = fd_ref.flash_decode_plain(q, kp, vp, table, lens, ks, vs)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=2e-6)
    for row in (0, 7):
        assert torch.equal(got[row], torch.zeros_like(got[row]))


# Clusters of S tensor-core blocks an H100 SXM runs at once, as the card
# reported them (cudaOccupancyMaxActiveClusters, dh 128, both pools).
H100_WIDE_CLUSTERS = {1: 264, 2: 132, 4: 62, 8: 30}


@pytest.mark.parametrize("batch,kv_heads,window,want", [
    (32, 2, 560, 2),  # starcoder2-3b at 32 slots: 64 clusters, 62 fit at S=4
    (1, 2, 560, 8), (16, 2, 560, 4), (31, 2, 560, 4), (33, 2, 560, 2),
    (200, 2, 560, 1), (1, 1, 100, 1), (1, 1, 200, 2)])
def test_wide_split_count_keeps_every_cluster_in_one_wave(batch, kv_heads,
                                                          window, want):
    s = rk_torch.split_count(batch, kv_heads, window, SERVE_SMS,
                             H100_WIDE_CLUSTERS)
    assert s == want
    rows = batch * kv_heads
    assert s == 1 or rows <= H100_WIDE_CLUSTERS[s]
    assert s == 1 or window // s >= rk_torch.MIN_SPLIT
    if s < rk_torch.MAX_SPLITS and window >= 4 * s * rk_torch.MIN_SPLIT:
        assert rows > H100_WIDE_CLUSTERS[2 * s]  # the next would not fit


def test_wide_split_count_follows_the_cards_reading():
    """The same shape on a card that holds more clusters splits further,
    and without a reading (the CUDA-core kernel) the block rule holds."""
    more = {s: 2 * n for s, n in H100_WIDE_CLUSTERS.items()}
    assert rk_torch.split_count(32, 2, 560, SERVE_SMS, more) == 4
    assert rk_torch.split_count(32, 2, 560, SERVE_SMS) == 8  # 3 an SM
    assert rk_torch.split_count(32, 8, 560, SERVE_SMS) == 2


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z1aILi128ELb0EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z1aILi128ELb0EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 2176 bytes smem
ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'
ptxas info    : Function properties for _Z1bv
    104 bytes stack frame, 268 bytes spill stores, 264 bytes spill loads
ptxas info    : Used 255 registers, 400 bytes cmem[0]
"""


def test_ptxas_report_gives_each_kernels_registers_and_spills():
    from repro_torch.kernels import _build

    assert _build.resource_usage(PTXAS_LOG) == [
        {"function": "_Z1aILi128ELb0EEvv", "stack": 0, "spill_stores": 0,
         "spill_loads": 0, "registers": 128},
        {"function": "_Z1bv", "stack": 104, "spill_stores": 268,
         "spill_loads": 264, "registers": 255}]
    assert _build.resource_usage("") == []
    assert ("-Xptxas", "-v") == _build.NVCC_FLAGS[-2:]
