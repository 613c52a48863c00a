"""CUDA kernels of the port against their plain versions, on the card.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips elsewhere.
This file imports nothing of the JAX package, so it also runs where JAX is
not installed:  ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import factorizer as fz
from repro_torch.core import rng
from repro_torch.core import vsa
from repro_torch.core.quantization import quantize
from repro_torch.device import disable_tf32
from repro_torch.kernels.resonator_step import ops
from repro_torch.kernels.resonator_step import ref
from repro_torch.kernels.similarity import kernel as sim_kernel
from repro_torch.kernels.similarity import ops as sim_ops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    disable_tf32()
    return torch.device("cuda")


def _bipolar(gen, shape, dev):
    return (torch.randint(0, 2, shape, generator=gen) * 2.0 - 1.0).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,m,d", [
    (1, 3, 10, 2048), (130, 3, 12, 256), (257, 3, 10, 2048),
    (9, 2, 700, 4096),  # codebook chunked along D
    (3, 2, 1024, 2048),  # the largest M the design supports
    (5, 4, 33, 37),  # D not a multiple of the warp
])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("act", ["identity", "abs"])
def test_kernel_bit_equals_plain_version(cuda, n, f, m, d, masked, act):
    gen = torch.Generator().manual_seed(n * 7 + m)
    cbs = _bipolar(gen, (f, m, d), cuda)
    qs = _bipolar(gen, (n, d), cuda)
    est = _bipolar(gen, (n, f, d), cuda)
    if masked:
        sizes = [(m * (i + 1)) // f for i in range(f - 1)] + [0]
        mask = torch.stack([torch.arange(m) < s for s in sizes]).to(cuda)
        before = ops.masked_launches
        got = ops.fused_resonator_step_batch_masked(qs, est, cbs, mask, act)
        want = ref.resonator_step_batch_masked_ref(qs, est, cbs, mask, act)
        assert ops.masked_launches == before + 1
    else:
        before = ops.launches
        got = ops.fused_resonator_step_batch(qs, est, cbs, act)
        want = ref.resonator_step_batch_ref(qs, est, cbs, act)
        assert ops.launches == before + 1
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_factorize_batch_on_the_card_bit_equals_the_cpu(cuda):
    cfg = fz.FactorizerConfig(vsa=vsa.VSAConfig(1024, 1024), num_factors=3,
                              codebook_size=10, synchronous=True,
                              fused_step=True, max_iters=30,
                              conv_threshold=0.8)
    cbs = fz.make_codebooks(torch.Generator().manual_seed(0), cfg, device="cpu")
    idx = np.random.default_rng(0).integers(0, 10, (64, 3))
    qs = fz.bind_combo(cbs, torch.from_numpy(idx), cfg.vsa)
    before = ops.launches
    got = fz.factorize_batch(qs, cbs, 0, cfg, device=cuda)
    want = fz.factorize_batch(qs, cbs, 0, cfg, device="cpu")
    assert ops.launches - before == int(got.iterations.max())
    for name in ("indices", "iterations", "converged", "scores"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,m,d,shards", [
    (1, 3, 12, 256, 2), (7, 3, 12, 256, 2), (130, 3, 12, 256, 2),
    (64, 3, 10, 2048, 2),  # the sharded serving shape: M_loc = 5
    (64, 3, 2, 2048, 2),  # M_loc = 1
    (5, 4, 99, 37, 3),  # D not a multiple of the warp
])
@pytest.mark.parametrize("act", ["identity", "abs"])
def test_local_kernel_bit_equals_plain_version_and_gathers_to_masked(
        cuda, n, f, m, d, shards, act):
    """The LOCAL mode against its plain version on every shard's row block
    and mask slice, bitwise; the shards' padded scores and partial
    projections, summed, masked and saturated, equal the masked kernel."""
    gen = torch.Generator().manual_seed(n * 5 + m)
    cbs = _bipolar(gen, (f, m, d), cuda)
    qs = _bipolar(gen, (n, d), cuda)
    est = _bipolar(gen, (n, f, d), cuda)
    sizes = [m, m // 2] + [m // 3 + 1] * (f - 2)
    mask = torch.stack([torch.arange(m) < s for s in sizes]).to(cuda)
    m_loc = m // shards
    acc_a = torch.zeros((n, f, m), device=cuda)
    acc_p = torch.zeros((n, f, d), device=cuda)
    for s in range(shards):
        blk = cbs[:, s * m_loc:(s + 1) * m_loc].contiguous()
        mk = mask[:, s * m_loc:(s + 1) * m_loc]
        before = ops.local_launches
        got = ops.fused_resonator_step_batch_local(qs, est, blk, mk, act)
        want = ref.resonator_step_batch_local_ref(qs, est, blk, mk, act)
        assert ops.local_launches == before + 1
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        acc_a[..., s * m_loc:(s + 1) * m_loc] += got[0]
        acc_p += got[1]
    a_full = torch.where(mask[None], acc_a, -1e9)
    e_full = torch.where(acc_p >= 0, 1.0, -1.0)
    a_k, e_k = ops.fused_resonator_step_batch_masked(qs, est, cbs, mask, act)
    assert torch.equal(a_full, a_k) and torch.equal(e_full, e_k)


@pytest.mark.cuda
def test_local_kernel_takes_no_mask_and_refuses_bad_inputs(cuda):
    from repro_torch.kernels.resonator_step import kernel as rsk

    gen = torch.Generator().manual_seed(9)
    cbs = _bipolar(gen, (3, 5, 256), cuda)
    qs, est = _bipolar(gen, (4, 256), cuda), _bipolar(gen, (4, 3, 256), cuda)
    got = rsk.resonator_step_batch_local(qs, est, cbs)
    want = ref.resonator_step_batch_local_ref(qs, est, cbs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="contiguous"):
        rsk.resonator_step_batch_local(qs, est, _bipolar(gen, (3, 10, 256),
                                                         cuda)[:, :5])
    with pytest.raises(ValueError, match="CUDA"):
        rsk.resonator_step_batch_local(qs.cpu(), est, cbs)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("placement", ["rows", "replicated"])
def test_sharded_engine_on_the_card_bit_equals_engine(cuda, fused, placement):
    """A 2 x 2 logical mesh on one card serves LVRF rows (D = 2048) exactly
    as the single-device Engine on the card does; a fused rows spec runs
    the local kernel once per shard per sweep."""
    from repro_torch import engine
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lvrf

    cfg = lvrf.LVRFConfig()
    atoms = lvrf.init_atoms(torch.Generator().manual_seed(0), cfg,
                            device=cuda)
    spec = engine.registry.build("lvrf_rows", 0, fused_step=fused,
                                 atoms=atoms, device=cuda)
    vals = np.random.default_rng(2).integers(0, cfg.n_values, (24, 3))
    qs = lvrf.encode_row(atoms, vals, cfg)
    keys = fz.draw_keys(3, len(vals))

    def serve(eng):
        ids = [eng.submit(qs[i], keys=keys[i][None]) for i in range(len(qs))]
        done = {r.id: r for r in eng.drain()}
        return [done[i] for i in ids], eng

    base, _ = serve(engine.Engine(spec, slots=8, device=cuda))
    mesh = make_host_mesh(2, 2, device=cuda)
    before = ops.local_launches
    got, eng = serve(engine.ShardedEngine(
        spec, mesh=mesh, codebook_placement=placement, slots=8))
    for a, b in zip(base, got):
        for name in a.factorization._fields:
            np.testing.assert_array_equal(getattr(b.factorization, name),
                                          getattr(a.factorization, name))
        assert (b.result["values"] == vals[base.index(a)]).all()
    local = ops.local_launches - before
    assert local == (4 * eng.sweeps_total if fused and placement == "rows"
                     else 0)


SIM_SHAPES = [(1, 10, 64), (7, 100, 512), (128, 257, 1024), (3, 1000, 100),
              (256, 10, 1024), (1, 1, 1), (5, 33, 2050)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,d", SIM_SHAPES)
def test_similarity_kernel_matches_plain_version(cuda, n, m, d):
    """The reference's tolerance (tests/test_kernels.py: atol 2e-2, rtol
    1e-3); the kernel applies the row scale after the sum, the plain version
    before it, so the two differ in the last bits only."""
    gen = torch.Generator().manual_seed(n + m + d)
    q = torch.randn((n, d), generator=gen).to(cuda)
    w = quantize(torch.randn((m, d), generator=gen)).to(cuda)
    before = sim_ops.launches
    got = sim_ops.codebook_scores(q, w)
    want = sim_ops.similarity_int8_ref(q, w.values, w.scale)
    assert sim_ops.launches == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=1e-3)
    assert (got - want).abs().max().item() < 1e-3


@pytest.mark.cuda
def test_similarity_kernel_takes_unaligned_rows_and_refuses_bad_inputs(cuda):
    gen = torch.Generator().manual_seed(3)
    flat = torch.randn(9 * 128 + 1, generator=gen).to(cuda)
    q = flat[1:].view(9, 128)  # contiguous, but 4 bytes past a 16-byte line
    assert q.data_ptr() % 16 != 0
    w = quantize(torch.randn((12, 128), generator=gen)).to(cuda)
    got = sim_kernel.similarity_int8(q, w.values, w.scale)
    torch.testing.assert_close(
        got, sim_ops.similarity_int8_ref(q, w.values, w.scale),
        atol=2e-2, rtol=1e-3)
    with pytest.raises(ValueError, match="contiguous"):
        sim_kernel.similarity_int8(q.T, w.values, w.scale)
    with pytest.raises(ValueError, match="int8"):
        sim_kernel.similarity_int8(q, w.dequantize(), w.scale)
    with pytest.raises(ValueError, match="CUDA"):
        sim_kernel.similarity_int8(q.cpu(), w.values, w.scale)


@pytest.mark.cuda
def test_int8_factorize_batch_on_the_card_matches_the_cpu(cuda):
    cfg = fz.FactorizerConfig(vsa=vsa.VSAConfig(1024, 4), num_factors=3,
                              codebook_size=10, algebra="unitary",
                              activation="abs", max_iters=60,
                              conv_threshold=0.55, codebook_fmt="int8")
    cbs = fz.make_codebooks(torch.Generator().manual_seed(1), cfg,
                            device="cpu")
    idx = np.random.default_rng(1).integers(0, 10, (64, 3))
    qs = fz.bind_combo(cbs, torch.from_numpy(idx), cfg.vsa)
    qt = fz.quantize_codebooks(cbs, "int8")
    before = sim_ops.launches
    got = fz.factorize_batch(qs, qt, 0, cfg, device=cuda)
    want = fz.factorize_batch(qs, qt, 0, cfg, device="cpu")
    assert sim_ops.launches - before == 3 * int(got.iterations.max())
    # Rows converging within 5 sweeps are well conditioned and must agree;
    # a slower row's trajectory can turn on the last bit of a score.
    fast = want.iterations <= 5
    assert fast.float().mean() >= 0.95
    assert torch.equal(got.indices.cpu()[fast], want.indices[fast])
    assert torch.equal(got.converged.cpu()[fast], want.converged[fast])
    assert (got.iterations.cpu() - want.iterations)[fast].abs().max() <= 1
    assert (want.indices.numpy() == idx).all(1).mean() >= 0.95


@pytest.mark.cuda
@pytest.mark.parametrize("tag", [rng.SCORES, rng.PROJECTION, rng.RESTART])
def test_rng_stream_on_the_card_equals_the_cpu(cuda, tag):
    keys = fz.draw_keys(5, 300)
    sweep = torch.arange(300) % 37
    assert torch.equal(rng.bits(keys.to(cuda), sweep.to(cuda), tag, 3,
                                1001).cpu(),
                       rng.bits(keys, sweep, tag, 3, 1001))
    torch.testing.assert_close(
        rng.normal(keys.to(cuda), sweep.to(cuda), tag, 3, 1001).cpu(),
        rng.normal(keys, sweep, tag, 3, 1001), atol=1e-6, rtol=0)


# -- edges of the resonator and similarity designs -------------------------

# (N, F, M, D): M one below, at and one above the score tile's switches (4
# rows a unit up to M = 8, 2 from 9; one tile up to 16, two from 17), D one
# below, at and one above the cluster's switches (one 256-float slice a
# block: D < 512 one block, D >= 2048 eight), D not a multiple of 4, N = 1
# and ragged last row tiles.
RS_EDGES = [(1, 3, 7, 2048), (9, 3, 8, 2048), (17, 2, 9, 1024),
            (33, 3, 15, 513), (5, 2, 16, 2050), (3, 4, 17, 2047),
            (8, 3, 10, 255), (257, 3, 10, 4099), (130, 3, 10, 511),
            (64, 3, 5, 2049)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,m,d", RS_EDGES)
@pytest.mark.parametrize("mode", ["dense", "masked", "local"])
@pytest.mark.parametrize("act", ["identity", "abs"])
def test_resonator_kernel_at_the_designs_edges(cuda, n, f, m, d, mode, act):
    """Every mode and activation, bitwise against the plain version on +-1
    inputs, at the edges of the cluster, slice and tile geometry."""
    gen = torch.Generator().manual_seed(n * 13 + m * 7 + d)
    cbs = _bipolar(gen, (f, m, d), cuda)
    qs = _bipolar(gen, (n, d), cuda)
    est = _bipolar(gen, (n, f, d), cuda)
    mask = torch.stack([torch.arange(m) < max(1, (m * (i + 1)) // f)
                        for i in range(f)]).to(cuda)
    if mode == "dense":
        got = ops.fused_resonator_step_batch(qs, est, cbs, act)
        want = ref.resonator_step_batch_ref(qs, est, cbs, act)
    elif mode == "masked":
        got = ops.fused_resonator_step_batch_masked(qs, est, cbs, mask, act)
        want = ref.resonator_step_batch_masked_ref(qs, est, cbs, mask, act)
    else:
        got = ops.fused_resonator_step_batch_local(qs, est, cbs, mask, act)
        want = ref.resonator_step_batch_local_ref(qs, est, cbs, mask, act)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("tn", [1, 2, 4, 16])
def test_resonator_kernel_at_every_row_ceiling(cuda, tn):
    """The FusedConfig(tn=...) ceiling changes the rows a cluster takes, not
    the bits, at the engine's shape."""
    gen = torch.Generator().manual_seed(tn)
    cbs = _bipolar(gen, (3, 10, 2048), cuda)
    qs, est = _bipolar(gen, (256, 2048), cuda), _bipolar(gen, (256, 3, 2048),
                                                         cuda)
    mask = torch.stack([torch.arange(10) < s for s in (5, 6, 10)]).to(cuda)
    got = ops.fused_resonator_step_batch_masked(
        qs, est, cbs, mask, "abs", fused=ops.FusedConfig(tn=tn))
    want = ref.resonator_step_batch_masked_ref(qs, est, cbs, mask, "abs")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8, torch.float32])
def test_resonator_kernel_takes_masks_of_each_type(cuda, dtype):
    """A mask given as bool, uint8 or float32 reaches the kernel as it is
    (no cast launched) and reads as its cast to bool, as in the plain
    version."""
    gen = torch.Generator().manual_seed(5)
    cbs = _bipolar(gen, (3, 10, 2048), cuda)
    qs, est = _bipolar(gen, (64, 2048), cuda), _bipolar(gen, (64, 3, 2048),
                                                         cuda)
    mask = torch.stack([torch.arange(10) < s for s in (5, 0, 10)]).to(cuda)
    for got, want in (
            (ops.fused_resonator_step_batch_masked(qs, est, cbs,
                                                   mask.to(dtype), "abs"),
             ref.resonator_step_batch_masked_ref(qs, est, cbs, mask, "abs")),
            (ops.fused_resonator_step_batch_local(qs, est, cbs,
                                                  mask.to(dtype), "abs"),
             ref.resonator_step_batch_local_ref(qs, est, cbs, mask, "abs"))):
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dense", "masked", "local"])
def test_resonator_kernel_is_bitwise_repeatable(cuda, mode):
    """Gaussian queries (scores not integers): two launches on the same
    inputs give the same bits; the sums run in a fixed order."""
    gen = torch.Generator().manual_seed(77)
    cbs = _bipolar(gen, (3, 10, 2048), cuda)
    qs = torch.randn((256, 2048), generator=gen).to(cuda)
    est = _bipolar(gen, (256, 3, 2048), cuda)
    mask = torch.stack([torch.arange(10) < s for s in (5, 6, 10)]).to(cuda)
    fn = {"dense": lambda: ops.fused_resonator_step_batch(qs, est, cbs),
          "masked": lambda: ops.fused_resonator_step_batch_masked(
              qs, est, cbs, mask),
          "local": lambda: ops.fused_resonator_step_batch_local(
              qs, est, cbs, mask)}[mode]
    a, b = fn(), fn()
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# (N, M, D): M one below, at and one above the tile's switches (4 query rows
# a block up to 8 codebook rows, 2 up to 16; one tile up to 16 rows, two up
# to 32, three from 33), D not a multiple of 4, N = 1 and ragged row tiles.
SIM_EDGES = [(1, 7, 1024), (129, 8, 1024), (257, 9, 1023), (64, 15, 2050),
             (3, 16, 1024), (130, 17, 1025), (5, 31, 4), (7, 32, 1024),
             (128, 33, 1024), (600, 4, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,d", SIM_EDGES)
def test_similarity_kernel_at_the_designs_edges(cuda, n, m, d):
    gen = torch.Generator().manual_seed(n + 3 * m + d)
    q = torch.randn((n, d), generator=gen).to(cuda)
    w = quantize(torch.randn((m, d), generator=gen)).to(cuda)
    got = sim_kernel.similarity_int8(q, w.values, w.scale)
    want = sim_ops.similarity_int8_ref(q, w.values, w.scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=1e-3)
    assert (got - want).abs().max().item() < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,d", [(256, 10, 1024), (128, 257, 1024)])
def test_similarity_kernel_is_bitwise_repeatable(cuda, n, m, d):
    gen = torch.Generator().manual_seed(n + m)
    q = torch.randn((n, d), generator=gen).to(cuda)
    w = quantize(torch.randn((m, d), generator=gen)).to(cuda)
    a = sim_kernel.similarity_int8(q, w.values, w.scale)
    b = sim_kernel.similarity_int8(q, w.values, w.scale)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# -- flash_decode ------------------------------------------------------------

# every block-boundary case for bs = 8, W = 3 (tests/test_flash_decode.py),
# plus rows of length zero, which give exact zeros
FD_LENS = [(1, 1, 1), (3, 8, 9), (8, 16, 24), (9, 17, 23), (16, 24, 8),
           (24, 24, 24), (0, 5, 0)]


def _fd_inputs(b, g, rep, dh, bs, width, kv_dtype, seed, dev):
    """A random pool, q and a table giving each row `width` distinct blocks
    (the last physical block stays the trash block)."""
    from repro_torch.nn.layers import _quant_kv

    rng = np.random.default_rng(seed)
    nbp = b * width + 1
    q = torch.from_numpy(rng.standard_normal((b, g, rep, dh), np.float32))
    k = torch.from_numpy(rng.standard_normal((nbp, bs, g, dh), np.float32))
    v = torch.from_numpy(rng.standard_normal((nbp, bs, g, dh), np.float32))
    if kv_dtype == "int8":
        (kq, ks), (vq, vs) = _quant_kv(k), _quant_kv(v)
        pool = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        pool = {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
    table = torch.from_numpy(
        rng.permutation(b * width).astype(np.int32).reshape(b, width))
    return (q.to(dev), {n: t.to(dev) for n, t in pool.items()},
            table.to(dev))


def _fd_check(q, pool, table, lens, splits=None):
    from repro_torch.kernels.flash_decode import ops as fd

    before = fd.launches
    got = (fd.flash_decode(q, pool, table, lens) if splits is None
           else _fd_kernel(q, pool, table, lens, splits))
    want = fd.flash_decode_plain(q, pool["k"], pool["v"], table, lens,
                                 pool.get("k_scale"), pool.get("v_scale"))
    assert fd.launches == before + 1
    torch.cuda.synchronize()
    # the reference's kernel tolerance: fp32 online softmax against one
    # dense softmax, summed in another order
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("lens", FD_LENS)
def test_flash_decode_kernel_at_every_block_boundary(cuda, kv_dtype, lens):
    q, pool, table = _fd_inputs(3, 2, 2, 16, 8, 3, kv_dtype, sum(lens), cuda)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got = _fd_check(q, pool, table, kv_lens)
    for b, n in enumerate(lens):
        if n == 0:
            assert torch.equal(got[b], torch.zeros_like(got[b]))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("g,rep,dh,bs,width", [
    (8, 3, 128, 16, 35),  # Llama 3.2 3B: 8 KV heads, 24 query heads
    (2, 4, 64, 5, 7),  # a block size that does not divide the tile
    (1, 8, 32, 64, 2),  # the largest rep, blocks longer than a tile
])
def test_flash_decode_kernel_at_serving_widths(cuda, kv_dtype, g, rep, dh,
                                               bs, width):
    b = 6
    q, pool, table = _fd_inputs(b, g, rep, dh, bs, width, kv_dtype, dh, cuda)
    cap = bs * width
    lens = torch.tensor([1, cap, cap // 2, 17, 0, cap - 1],
                        dtype=torch.int32, device=cuda)
    _fd_check(q, pool, table, lens)


@pytest.mark.cuda
def test_flash_decode_kernel_refuses_bad_inputs(cuda):
    from repro_torch.kernels.flash_decode import kernel as fdk

    q, pool, table = _fd_inputs(2, 2, 2, 16, 8, 2, "int8", 0, cuda)
    lens = torch.tensor([3, 9], dtype=torch.int32, device=cuda)
    k, v = pool["k"], pool["v"]
    with pytest.raises(ValueError, match="requires k_scale/v_scale"):
        fdk.flash_decode(q, k, v, table, lens)
    s = dict(k_scale=pool["k_scale"], v_scale=pool["v_scale"])
    with pytest.raises(ValueError, match="CUDA"):
        fdk.flash_decode(q.cpu(), k, v, table, lens, **s)
    with pytest.raises(ValueError, match="float32"):
        fdk.flash_decode(q.double(), k, v, table, lens, **s)
    with pytest.raises(ValueError, match="int32"):
        fdk.flash_decode(q, k, v, table.long(), lens, **s)
    with pytest.raises(ValueError, match="contiguous"):
        fdk.flash_decode(q.transpose(0, 1).contiguous().transpose(0, 1), k,
                         v, table, lens, **s)
    with pytest.raises(ValueError, match="head_dim"):
        fdk.flash_decode(q[..., :8].contiguous(), k[..., :8].contiguous(),
                         v[..., :8].contiguous(), table, lens,
                         k_scale=pool["k_scale"], v_scale=pool["v_scale"])
    q17 = torch.zeros((2, 2, 17, 16), device=cuda)
    with pytest.raises(ValueError, match="query heads"):
        fdk.flash_decode(q17, k, v, table, lens, **s)


# The head shapes of the reference's other configs: Granite-MoE 3B (8 KV
# heads of 64, rep 3), starcoder2-3b (2 of 128, rep 12); then every rep of
# the tensor-core kernel (9-16, one M = 16 tile of query heads) at every
# head width.
FD_CONFIG_REPS = [
    (8, 3, 64, 16, 35),  # granite-moe-3b-a800m
    (2, 12, 128, 16, 35),  # starcoder2-3b
    (2, 16, 128, 16, 9),
    (2, 10, 128, 16, 9),
    (3, 9, 64, 8, 5),
    (1, 13, 32, 16, 4),
    (2, 16, 16, 8, 3),
]
FD_CONFIG_REPS += [(2, rep, dh, 16, 9) for rep in range(9, 17)
                   for dh in (16, 32, 64, 128)
                   if (2, rep, dh, 16, 9) not in FD_CONFIG_REPS]


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("g,rep,dh,bs,width", FD_CONFIG_REPS)
def test_flash_decode_kernel_at_every_configs_rep(cuda, kv_dtype, g, rep, dh,
                                                  bs, width):
    from repro_torch.kernels.flash_decode import kernel as fdk

    b = 6
    q, pool, table = _fd_inputs(b, g, rep, dh, bs, width, kv_dtype, rep, cuda)
    cap = bs * width
    lens = torch.tensor([1, cap, cap // 2, 17, 0, cap - 1],
                        dtype=torch.int32, device=cuda)
    got = _fd_check(q * dh ** -0.5, pool, table, lens)
    assert got.shape == (b, g, rep, dh) and got.is_contiguous()
    assert torch.equal(got[4], torch.zeros_like(got[4]))
    for splits in (1, 2, 8):  # the split merge at the wide reps too
        torch.testing.assert_close(
            _fd_kernel(q * dh ** -0.5, pool, table, lens, splits), got,
            atol=2e-5, rtol=2e-5)
    assert fdk.launch_rep(rep) == rep  # no rep is padded


# The split-KV design at the serving widths of Llama 3.2 3B: a cluster of
# `splits` blocks per (row, KV head), each taking a run of positions rounded
# up to a warp's batch (kernel.tile).
FD_SERVE = dict(g=8, rep=3, dh=128, bs=16, width=35)


def _fd_serve_inputs(lens, kv_dtype, seed, dev):
    f = FD_SERVE
    q, pool, table = _fd_inputs(len(lens), f["g"], f["rep"], f["dh"], f["bs"],
                                f["width"], kv_dtype, seed, dev)
    return (q * f["dh"] ** -0.5, pool, table,
            torch.tensor(lens, dtype=torch.int32, device=dev))


def _fd_kernel(q, pool, table, lens, splits=None):
    from repro_torch.kernels.flash_decode import kernel as fdk

    return fdk.flash_decode(q, pool["k"], pool["v"], table, lens,
                            k_scale=pool.get("k_scale"),
                            v_scale=pool.get("v_scale"), splits=splits)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("splits", [2, 4, 8])
def test_flash_decode_kernel_at_split_boundaries(cuda, kv_dtype, splits):
    from repro_torch.kernels.flash_decode import kernel as fdk

    f = FD_SERVE
    span = fdk.tile(f["dh"], f["rep"])
    lens = fdk.split_edges(span, splits, f["bs"] * f["width"])
    q, pool, table, kv_lens = _fd_serve_inputs(lens, kv_dtype, splits, cuda)
    got = _fd_check(q, pool, table, kv_lens, splits=splits)
    assert torch.equal(got[0], torch.zeros_like(got[0]))  # lens[0] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_flash_decode_kernel_one_full_row_among_rows_of_one(cuda, kv_dtype):
    f = FD_SERVE
    lens = [1] * 3 + [f["bs"] * f["width"]] + [1] * 4
    _fd_check(*_fd_serve_inputs(lens, kv_dtype, 1, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_flash_decode_kernel_one_row_at_the_full_window(cuda, kv_dtype):
    from repro_torch.kernels.flash_decode import kernel as fdk

    f = FD_SERVE
    window = f["bs"] * f["width"]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert fdk.split_count(1, f["g"], window, sms) > 1  # the row is split
    _fd_check(*_fd_serve_inputs([window], kv_dtype, 2, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("splits", [None, 8])
def test_flash_decode_kernel_zero_rows_in_a_split_batch(cuda, kv_dtype,
                                                        splits):
    f = FD_SERVE
    lens = [0, 300, 0, f["bs"] * f["width"], 0, 17]
    q, pool, table, kv_lens = _fd_serve_inputs(lens, kv_dtype, 3, cuda)
    got = _fd_check(q, pool, table, kv_lens, splits=splits)
    assert bool(torch.isfinite(got).all())
    for b in (0, 2, 4):
        assert torch.equal(got[b], torch.zeros_like(got[b]))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_flash_decode_kernel_is_bitwise_repeatable(cuda, kv_dtype):
    lens = np.random.default_rng(4).integers(0, 561, 32).tolist()
    args = _fd_serve_inputs(lens, kv_dtype, 4, cuda)
    first, second = _fd_kernel(*args), _fd_kernel(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# starcoder2-3b's head shape on the tensor-core kernel (2 KV heads of 128,
# rep 12) at the serving window.
FD_WIDE = dict(g=2, rep=12, dh=128, bs=16, width=35)


def _fd_wide_inputs(lens, kv_dtype, seed, dev):
    f = FD_WIDE
    q, pool, table = _fd_inputs(len(lens), f["g"], f["rep"], f["dh"], f["bs"],
                                f["width"], kv_dtype, seed, dev)
    return (q * f["dh"] ** -0.5, pool, table,
            torch.tensor(lens, dtype=torch.int32, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("splits", [2, 4, 8])
def test_flash_decode_wide_kernel_at_split_boundaries(cuda, kv_dtype, splits):
    from repro_torch.kernels.flash_decode import kernel as fdk

    f = FD_WIDE
    span = fdk.tile(f["dh"], f["rep"])
    assert span == fdk.WIDE_TILE
    lens = fdk.split_edges(span, splits, f["bs"] * f["width"])
    q, pool, table, kv_lens = _fd_wide_inputs(lens, kv_dtype, splits, cuda)
    got = _fd_check(q, pool, table, kv_lens, splits=splits)
    assert torch.equal(got[0], torch.zeros_like(got[0]))  # lens[0] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_flash_decode_wide_kernel_is_bitwise_repeatable(cuda, kv_dtype):
    lens = np.random.default_rng(6).integers(0, 561, 32).tolist()
    args = _fd_wide_inputs(lens, kv_dtype, 6, cuda)
    first, second = _fd_kernel(*args), _fd_kernel(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_flash_decode_rep10_is_one_launch_and_one_allocation(cuda, kv_dtype):
    """No padding of q and no copy of the output: a call at rep 10 launches
    once and allocates only its output."""
    from repro_torch.kernels.flash_decode import ops as fd

    q, pool, table = _fd_inputs(4, 2, 10, 128, 16, 9, kv_dtype, 10, cuda)
    q = q * 128 ** -0.5
    lens = torch.tensor([1, 144, 0, 77], dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    launches = fd.launches
    allocated = torch.cuda.memory_stats(cuda)["allocation.all.allocated"]
    got = fd.flash_decode(q, pool, table, lens)
    assert (torch.cuda.memory_stats(cuda)["allocation.all.allocated"]
            - allocated) == 1
    assert fd.launches == launches + 1
    assert got.shape == (4, 2, 10, 128) and got.is_contiguous()
    want = fd.flash_decode_plain(q, pool["k"], pool["v"], table, lens,
                                 pool.get("k_scale"), pool.get("v_scale"))
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_flash_decode_kernel_graph_replay_equals_eager(cuda, kv_dtype):
    from repro_torch.kernels.flash_decode import ops as fd

    lens = np.random.default_rng(5).integers(0, 561, 32).tolist()
    args = _fd_serve_inputs(lens, kv_dtype, 5, cuda)
    eager = _fd_kernel(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _fd_kernel(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = _fd_kernel(*args)
    before = fd.launches
    graph.replay()
    torch.cuda.synchronize()
    assert fd.launches == before  # a replay calls no wrapper
    assert torch.equal(replayed, eager)


@pytest.mark.cuda
def test_paged_smoke_decode_launches_the_kernel_once_per_layer(cuda):
    from repro_torch.configs import registry
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.lm.paging import PagedConfig
    from repro_torch.nn import transformer as T

    cfg = registry.get("llama3.2-3b").smoke()
    model = T.init(cfg, 0, cuda)
    eng = ServeEngine(cfg, model, 3, 32, device=cuda,
                      paged=PagedConfig(block_size=8, prefill_chunk=4))
    for s, n in enumerate((1, 5, 9)):
        eng.add_request(s, np.arange(n) * 7 % cfg.vocab)
    before = fd.launches
    for _ in range(6):
        assert eng.step() is not None
        assert bool(torch.isfinite(eng.last_logits).all())
    assert fd.launches - before == cfg.n_layers * 6
    assert eng.decode_dispatches == 6


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-moe-3b-a800m",
                                  "qwen2-vl-72b", "xlstm-125m",
                                  "whisper-small", "jamba-1.5-large-398b"])
def test_each_family_on_the_card_matches_the_cpu(cuda, arch):
    """One architecture of each family (dense, moe, vlm, ssm, audio,
    hybrid) at smoke shapes and fp32, the same weights on the card and on
    the CPU: forward logits and 4 decode steps within 1e-5 of each row's
    largest |logit| (fp32 sums in another order; TF32 off)."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.nn import transformer as T

    cfg = dataclasses.replace(registry.get(arch).smoke(),
                              activ_dtype=torch.float32)
    cpu = torch.device("cpu")
    models = {d: T.init(cfg, torch.Generator().manual_seed(5), cpu).to(d)
              for d in (cpu, cuda)}
    rng = np.random.default_rng(6)
    B, S = 2, 12
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))}
    if cfg.mrope_sections is not None:
        batch["positions"] = torch.arange(S)[None, None].expand(B, 3, S) * 1
        batch["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.vision_patches, cfg.d_model)).astype(np.float32))
    if cfg.encoder is not None:
        batch["encoder_frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.encoder.d_model)).astype(np.float32))
    out = {}
    for d, model in models.items():
        b = {k: v.to(d) for k, v in batch.items()}
        logits, _ = T.forward(model, cfg, b["tokens"],
                              positions=b.get("positions"),
                              vision_embeds=b.get("vision_embeds"),
                              encoder_frames=b.get("encoder_frames"))
        cache = T.init_cache(cfg, B, 8, device=d)
        enc = (T._encoder_forward(model, cfg, b["encoder_frames"])
               if cfg.encoder is not None else None)
        steps = [logits.reshape(-1, cfg.vocab).cpu()]
        for t in range(4):
            pos = (torch.full((B, 3, 1), t, device=d)
                   if cfg.mrope_sections is not None else None)
            lg, cache = T.decode_step(model, cfg, cache,
                                      b["tokens"][:, t:t + 1], positions=pos,
                                      enc_out=enc)
            steps.append(lg[:, 0].cpu())
        out[d.type] = steps
    for want, got in zip(out["cpu"], out["cuda"]):
        top = want.abs().amax(-1, keepdim=True)
        assert bool(((got - want).abs() <= 1e-5 * top).all())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "starcoder2-3b"])
def test_paged_moe_and_rep12_decode_launch_the_kernel_once_per_layer(cuda,
                                                                     arch):
    from repro_torch.configs import registry
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.lm.paging import PagedConfig
    from repro_torch.nn import transformer as T

    cfg = registry.get(arch).smoke()
    if arch == "starcoder2-3b":  # the full config's 12 query heads a KV head
        import dataclasses
        cfg = dataclasses.replace(cfg, n_heads=24, n_kv_heads=2, d_model=96,
                                  head_dim=16)
    model = T.init(cfg, 0, cuda)
    eng = ServeEngine(cfg, model, 3, 32, device=cuda,
                      paged=PagedConfig(block_size=8, prefill_chunk=4))
    for s, n in enumerate((1, 5, 9)):
        eng.add_request(s, np.arange(n) * 7 % cfg.vocab)
    before = fd.launches
    for _ in range(4):
        assert eng.step() is not None
        assert bool(torch.isfinite(eng.last_logits).all())
    assert fd.launches - before == cfg.n_layers * 4


# circconv: the reference test's shapes (tests/test_kernels.py), the serving
# shapes of MIMONet (4096 and 8192 rows of L = 256: S = 2 and S = 4) and the
# largest L the design takes;
# the reference's tolerances (rows: tol * sqrt(L), rtol tol; tol 1e-4 fp32,
# 0.15 bf16; single: atol 1e-3, rtol 1e-4).
CC_ROWS = [(1, 64), (4, 128), (32, 256), (7, 100), (130, 64), (16, 1024),
           (4096, 256), (8192, 256), (2, 16384), (3, 1), (5, 13)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,L", CC_ROWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_circconv_rows_kernel_matches_plain_version(cuda, n, L, dtype):
    from repro_torch.kernels.circconv import kernel as cck
    from repro_torch.kernels.circconv import ops as cc
    from repro_torch.kernels.circconv import ref as ccr

    gen = torch.Generator().manual_seed(n * 1000 + L)
    x = torch.randn((n, L), generator=gen).to(cuda, dtype)
    y = torch.randn((n, L), generator=gen).to(cuda, dtype)
    before = cc.rows_launches
    got = cck.circconv_rows(x, y)
    want = ccr.circconv_rows_ref(x, y)
    torch.cuda.synchronize()
    assert cc.rows_launches == before + 1 and got.dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else 0.15
    np.testing.assert_allclose(got.float().cpu().numpy(), want.cpu().numpy(),
                               atol=tol * np.sqrt(L), rtol=tol)


# The single kernel's lengths: the reference test's, edges of L, and one L
# at each cluster size 8..1 (kernel.single_geometry: about 128 blocks).
CC_SINGLE = [512, 1024, 777, 2048, 1, 100, 16384, 7, 13, 1300, 1500, 1800,
             3000, 4096, 8192]


@pytest.mark.cuda
@pytest.mark.parametrize("L", CC_SINGLE)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_circconv_single_kernel_matches_plain_version(cuda, L, dtype):
    from repro_torch.kernels.circconv import kernel as cck
    from repro_torch.kernels.circconv import ops as cc
    from repro_torch.kernels.circconv import ref as ccr

    gen = torch.Generator().manual_seed(L)
    x = torch.randn((L,), generator=gen).to(cuda, dtype)
    y = torch.randn((L,), generator=gen).to(cuda, dtype)
    before = cc.single_launches
    got = cck.circconv_single(x, y)
    want = ccr.circconv_single_ref(x, y)
    torch.cuda.synchronize()
    assert cc.single_launches == before + 1 and got.dtype == dtype
    tol = (1e-3, 1e-4) if dtype == torch.float32 else (0.15 * np.sqrt(L), 0.15)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.cpu().numpy(),
                               atol=tol[0], rtol=tol[1])


# Broadcast operands, read as views (stride 0) by circconv_rows: (x shape,
# y shape, mode).  MIMONet's bind (emb [N, S, B, L] with keys [1, S, B, L])
# and unbind (out [N, 1, B, L] with the involuted keys) at S = 2 and 4, x
# the stationary operand, both and neither broadcast, a group just below
# and at the mode rule's threshold (32 rows), and the reference test's
# shapes against one shared y row.
CC_BCAST = {
    "bind S=2": ((256, 2, 8, 256), (1, 2, 8, 256), "mma"),
    "unbind S=2": ((256, 1, 8, 256), (1, 2, 8, 256), "mma"),
    "bind S=4": ((256, 4, 8, 256), (1, 4, 8, 256), "mma"),
    "unbind S=4": ((256, 1, 8, 256), (1, 4, 8, 256), "mma"),
    "x stationary": ((1, 3, 128), (40, 3, 128), "mma"),
    "both": ((3, 1, 2, 64), (1, 4, 2, 64), "direct"),
    "both at L=256": ((64, 1, 8, 256), (1, 2, 8, 256), "mma"),
    "neither": ((40, 2, 256), (40, 2, 256), "direct"),
    "group of 31": ((31, 2, 128), (1, 2, 128), "direct"),
    "group of 32": ((32, 2, 128), (1, 2, 128), "mma"),
    "group of 33": ((33, 2, 128), (1, 2, 128), "mma"),
    "the longest mma L": ((64, 2048), (1, 2048), "mma"),
    "past the longest mma L": ((64, 4096), (1, 4096), "direct"),
    **{f"y shared, ({n}, {L})": ((n, L), (1, L), mode)
       for (n, L), mode in (((1, 64), "direct"), ((4, 128), "direct"),
                            ((32, 256), "mma"), ((7, 100), "direct"),
                            ((130, 64), "direct"), ((16, 1024), "direct"))},
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CC_BCAST))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_circconv_rows_kernel_on_broadcast_operands(cuda, case, dtype):
    from repro_torch.kernels.circconv import kernel as cck
    from repro_torch.kernels.circconv import ref as ccr

    xshape, yshape, mode = CC_BCAST[case]
    shape = torch.broadcast_shapes(xshape, yshape)
    L = shape[-1]
    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(xshape, generator=gen).to(cuda, dtype).expand(shape)
    y = torch.randn(yshape, generator=gen).to(cuda, dtype).expand(shape)
    assert cck.rows_plan(shape, x.stride(), y.stride()).mode == mode
    got = cck.circconv_rows(x, y)
    want = ccr.circconv_rows_ref(x.reshape(-1, L).contiguous(),
                                 y.reshape(-1, L).contiguous())
    torch.cuda.synchronize()
    assert got.shape == shape and got.dtype == dtype and got.is_contiguous()
    tol = 1e-4 if dtype == torch.float32 else 0.15
    np.testing.assert_allclose(got.float().reshape(-1, L).cpu().numpy(),
                               want.cpu().numpy(), atol=tol * np.sqrt(L),
                               rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bind S=2", "unbind S=2", "neither"])
def test_circconv_kernels_are_bitwise_repeatable(cuda, case):
    from repro_torch.kernels.circconv import kernel as cck

    xshape, yshape, _ = CC_BCAST[case]
    shape = torch.broadcast_shapes(xshape, yshape)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(xshape, generator=gen).to(cuda).expand(shape)
    y = torch.randn(yshape, generator=gen).to(cuda).expand(shape)
    assert torch.equal(cck.circconv_rows(x, y), cck.circconv_rows(x, y))
    v = torch.randn((2048,), generator=gen).to(cuda)
    w = torch.randn((2048,), generator=gen).to(cuda)
    assert torch.equal(cck.circconv_single(v, w), cck.circconv_single(v, w))


@pytest.mark.cuda
def test_mimonet_binds_allocate_no_operand_copies(cuda):
    """The bind of emb (256, 2, 8, 256) with keys (1, 2, 8, 256) and the
    unbind of out (256, 1, 8, 256) allocate their output and little else:
    no broadcast copy of either operand (4.2 MB each)."""
    from repro_torch.kernels.circconv import ops as cc

    gen = torch.Generator().manual_seed(8)
    emb = torch.randn((256, 2, 8, 256), generator=gen).to(cuda)
    keys = torch.randn((1, 2, 8, 256), generator=gen).to(cuda)
    out = torch.randn((256, 1, 8, 256), generator=gen).to(cuda)
    for fn, a in ((cc.block_circconv, emb), (cc.block_circcorr, out)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = fn(a, keys)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        assert got.shape == (256, 2, 8, 256)
        assert extra <= got.numel() * 4 + 2 ** 20, (fn.__name__, extra)


@pytest.mark.cuda
def test_pallas_bind_on_the_card_launches_the_circconv_kernels(cuda):
    from repro_torch.kernels.circconv import ops as cc

    cfg = vsa.VSAConfig(2048, 8, impl="pallas")
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((5, 1, 2048), generator=gen).to(cuda)
    keys = vsa.random_unitary(gen, (3,), cfg, device=cuda)
    before = (cc.rows_launches, cc.single_launches)
    got = vsa.unbind(vsa.bind(x, keys[None], cfg), keys[None], cfg)
    assert (cc.rows_launches, cc.single_launches) == (before[0] + 2,
                                                      before[1])
    want = vsa.unbind(vsa.bind(x, keys[None], cfg, impl="fft"), keys[None],
                      cfg, impl="fft")
    assert got.shape == (5, 3, 2048)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-5)
    hrr = vsa.VSAConfig(2048, 1, impl="pallas")
    v = torch.randn((2048,), generator=gen).to(cuda)
    got = vsa.bind(v, v, hrr)
    assert cc.single_launches == before[1] + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               vsa.bind(v, v, hrr, impl="fft").cpu().numpy(),
                               atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
def test_circconv_kernels_refuse_bad_inputs(cuda):
    from repro_torch.kernels.circconv import kernel as cck

    x = torch.zeros((4, 64), device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cck.circconv_rows(x.half(), x.half())
    with pytest.raises(ValueError, match="differ"):
        cck.circconv_rows(x, x[:2])
    with pytest.raises(ValueError, match="contiguous"):
        cck.circconv_rows(x.t(), x.t())
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros((1, cck.MAX_L + 8), device=cuda)
        cck.circconv_rows(big, big)
    with pytest.raises(ValueError, match="dims"):
        cck.circconv_single(x, x)


@pytest.mark.cuda
def test_mimonet_on_the_card_matches_its_fft_run(cuda):
    import dataclasses

    from repro_torch.data import raven
    from repro_torch.kernels.circconv import ops as cc
    from repro_torch.models import mimonet

    cfg = mimonet.MIMONetConfig(vsa=vsa.VSAConfig(2048, 8, impl="pallas"))
    model = mimonet.init(cfg, 0, device=cuda)
    b = raven.attribute_classification_batch(np.random.default_rng(0), 64)
    imgs = torch.from_numpy(b["images"]).reshape(32, 2, 32, 32).to(cuda)
    before = cc.rows_launches
    got = mimonet.apply(model, imgs, cfg)
    assert cc.rows_launches == before + 2
    want = mimonet.apply(model, imgs, dataclasses.replace(
        cfg, vsa=vsa.VSAConfig(2048, 8, impl="fft")))
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   atol=1e-5, rtol=1e-4)


# NVSA: the masked kernel at NVSA's bipolar width (D = 1024, a cluster of 4
# blocks), the CNN frontend, and a bipolar fused NVSA engine run.

@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 256])
@pytest.mark.parametrize("act", ["identity", "abs"])
def test_masked_kernel_at_nvsa_width_bit_equals_plain_version(cuda, n, act):
    gen = torch.Generator().manual_seed(n)
    cbs = _bipolar(gen, (3, 10, 1024), cuda)
    qs = _bipolar(gen, (n, 1024), cuda)
    est = _bipolar(gen, (n, 3, 1024), cuda)
    mask = torch.stack([torch.arange(10) < s for s in (5, 6, 10)]).to(cuda)
    before = ops.masked_launches
    got = ops.fused_resonator_step_batch_masked(qs, est, cbs, mask, act)
    want = ref.resonator_step_batch_masked_ref(qs, est, cbs, mask, act)
    assert ops.masked_launches == before + 1
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_cnn_on_the_card_matches_the_cpu(cuda):
    from repro_torch.data import raven
    from repro_torch.models import cnn

    cfg = cnn.CNNConfig()
    b = raven.RavenDataset(raven.RavenConfig(batch_size=4)).next_batch()
    imgs = torch.from_numpy(b["candidate_images"].reshape(-1, 32, 32))
    got = cnn.apply(cnn.init(cfg, 1, device=cuda), imgs.to(cuda), cfg)
    want = cnn.apply(cnn.init(cfg, 1, device="cpu"), imgs, cfg)
    for key in ("query", "features"):
        np.testing.assert_allclose(got[key].cpu().numpy(), want[key].numpy(),
                                   atol=1e-4, rtol=0)
    for g, w in zip(got["attr_logits"], want["attr_logits"]):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), atol=1e-4,
                                   rtol=0)


@pytest.mark.cuda
def test_bipolar_fused_nvsa_engine_on_the_card_matches_the_cpu(cuda):
    import dataclasses

    from repro_torch import engine
    from repro_torch.data import raven
    from repro_torch.models import nvsa

    cfg = nvsa.NVSAConfig(vsa=vsa.VSAConfig(1024, 1024))
    cfg = dataclasses.replace(cfg, factorizer=dataclasses.replace(
        cfg.factorizer, noise_std=0.0, restart_every=0, synchronous=True))
    b = raven.RavenDataset(raven.RavenConfig(batch_size=16,
                                             render=False)).next_batch()
    attrs = np.stack([b[f"grid_{a}"].reshape(16, 9)[:, :8]
                      for a in raven.ATTRS], -1)
    cands = np.stack([b[f"cand_{a}"] for a in raven.ATTRS], -1)
    runs = []
    for dev in (cuda, torch.device("cpu")):
        spec = engine.registry.build("nvsa_abduction", 0, cfg=cfg,
                                     fused_step=True, device=dev)
        ctx = nvsa.target_query(spec.codebooks, torch.from_numpy(attrs), cfg)
        cand = nvsa.target_query(spec.codebooks, torch.from_numpy(cands), cfg)
        eng = engine.Engine(spec, slots=32, device=dev)
        before = ops.masked_launches
        ids = [eng.submit(ctx[t], meta={"cand": cand[t]}, generator=t)
               for t in range(16)]
        done = {r.id: r for r in eng.drain()}
        if dev.type == "cuda":
            assert ops.masked_launches - before == eng.sweeps_total > 0
        runs.append([done[i] for i in ids])
    for g, w in zip(*runs):  # the factorization bitwise (+-1 operands)
        for name in ("indices", "iterations", "converged", "scores"):
            np.testing.assert_array_equal(getattr(g.factorization, name),
                                          getattr(w.factorization, name))
        # the abduction tail: fp32 on soft beliefs (exp, cuBLAS); sims are
        # cosines in [-1, 1] summed over D = 1024
        assert g.result["answer"] == w.result["answer"]
        np.testing.assert_allclose(g.result["sims"], w.result["sims"],
                                   atol=1e-5, rtol=0)


# -- the supervised runtime: a stepper thread drives the card ----------------

def _lvrf_on(dev, n_good=24, n_junk=2, seed=3):
    from repro_torch import engine
    from repro_torch.device import generator
    from repro_torch.models import lvrf

    cfg = lvrf.LVRFConfig()
    atoms = lvrf.init_atoms(generator(0), cfg, device=dev)
    spec = engine.registry.build("lvrf_rows", 0, fused_step=True, atoms=atoms,
                                 device=dev)
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, cfg.n_values, (n_good, 3))
    junk = torch.from_numpy(rng.normal(size=(n_junk, cfg.vsa.dim))
                            .astype(np.float32)).to(dev)
    qs = torch.cat([lvrf.encode_row(atoms, vals, cfg), junk])
    return spec, qs, fz.draw_keys(seed, len(qs)), vals


@pytest.mark.cuda
def test_runtime_stepper_launches_are_counted(cuda):
    """Every sweep the runtime's stepper thread runs on the card launches the
    fused kernel once, and the wrapper's count sees each launch."""
    from repro_torch import engine, runtime as rt

    spec, qs, keys, vals = _lvrf_on(cuda)
    eng = engine.Engine(spec, slots=16, device=cuda)
    r = rt.Runtime()
    r.register("lvrf", eng)
    before = ops.launches
    with r:
        gids = [r.submit("lvrf", qs[i], keys=keys[i][None])
                for i in range(len(qs))]
        reqs = [r.result(g, timeout=120) for g in gids]
    assert ops.launches - before == eng.sweeps_total > 0
    # the +-1 rows against the same engine on the CPU, bit for bit
    cpu = engine.Engine(spec, slots=16, device="cpu")
    ids = [cpu.submit(qs[i].cpu(), keys=keys[i][None])
           for i in range(len(vals))]
    want = {q.id: q for q in cpu.drain()}
    for i, rid in enumerate(ids):
        a, b = reqs[i].factorization, want[rid].factorization
        for name in ("indices", "iterations", "converged", "scores"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        if a.converged[0]:
            assert reqs[i].result["values"][0].tolist() == vals[i].tolist()


@pytest.mark.cuda
def test_runtime_catches_a_nan_in_cuda_state_and_replays_bitwise(cuda):
    """The chaos harness's NaN poke into the card's resonator state is caught
    by the health check and replayed: decodes bitwise equal to a
    fault-free run with the same keys."""
    from repro_torch import engine, runtime as rt

    spec, qs, keys, _ = _lvrf_on(cuda, n_good=12, n_junk=4)

    def run(plan):
        chaos = rt.ChaosEngine(engine.Engine(spec, slots=8, device=cuda),
                               plan)
        r = rt.Runtime(failure=rt.FailurePolicy(
            max_restarts=50, backoff_initial_s=0.01, backoff_max_s=0.05,
            health_check_every=1))
        r.register("lvrf", chaos)
        with r:
            gids = [r.submit("lvrf", qs[i], keys=keys[i][None])
                    for i in range(len(qs))]
            out = [r.result(g, timeout=120) for g in gids]
        return out, chaos, r

    got, chaos, r = run(rt.FaultPlan(seed=5, corrupt_rate=1.0, max_faults=2))
    want, _, _ = run(rt.FaultPlan(seed=5))
    assert chaos.injected["corrupt"] == 2
    assert chaos.inner.state.est.device.type == "cuda"
    tags = [t for _, t in r.stats()["lvrf"]["supervision"]["events"]]
    assert tags.count("fault fault") >= 1
    for a, b in zip(got, want):
        for name in ("indices", "iterations", "converged", "scores"):
            np.testing.assert_array_equal(getattr(a.factorization, name),
                                          getattr(b.factorization, name))


@pytest.mark.cuda
def test_measured_retune_times_the_card_from_the_stepper_thread(cuda,
                                                                monkeypatch):
    """A measured-cost re-tune runs measure_sweep_seconds on the stepper
    thread, on the card: a positive time per candidate and a resize."""
    import threading

    from repro_torch import engine, runtime as rt
    from repro_torch.engine.sharding import autotune

    spec, qs, keys, _ = _lvrf_on(cuda, n_good=16, n_junk=2)
    seen = []
    orig = autotune.measure_sweep_seconds

    def spy(spec_, n, **kw):
        t = orig(spec_, n, **kw)
        seen.append((threading.current_thread().name, kw.get("device"), t))
        return t

    monkeypatch.setattr(autotune, "measure_sweep_seconds", spy)
    eng = engine.Engine(spec, slots=8, sweeps_per_step=2, device=cuda)
    r = rt.Runtime()
    r.register("lvrf", eng, retune=rt.RetunePolicy(
        threshold=2.0, check_every=1, baseline_rps=1e-3, candidates=(16,),
        use_measured_cost=True))
    with r:
        gids = [r.submit("lvrf", qs[i], keys=keys[i][None])
                for i in range(len(qs))]
        for g in gids:
            r.result(g, timeout=120)
    assert r.telemetry["lvrf"].retunes >= 1 and eng.slots == 16
    assert seen and all(name == "repro-runtime-stepper" and t > 0
                        and torch.device(d).type == "cuda"
                        for name, d, t in seen)


# Training (slice 11) ----------------------------------------------------------

def _frontend_batch(n=16):
    from repro_torch.data import raven
    return raven.attribute_classification_batch(np.random.default_rng(0), n)


@pytest.mark.cuda
def test_frontend_loss_gradients_on_the_card_match_the_cpu(cuda):
    """cuDNN convolutions (TF32 off) and cuBLAS sum in another order than
    the CPU's: the loss at rtol 1e-5, every gradient at rtol 1e-4, atol
    1e-6 (the CPU tests' band against the reference)."""
    from repro_torch.models import cnn, nvsa
    cfg = nvsa.NVSAConfig()
    b = _frontend_batch()
    out = {}
    for dev in ("cpu", cuda):
        cbs, _ = nvsa.make_codebooks(0, cfg, device=dev)
        model = cnn.init(cfg.cnn, 0, device=dev).requires_grad_(True)
        loss, _ = nvsa.frontend_loss(model, {k: torch.from_numpy(v).to(dev)
                                             for k, v in b.items()}, cbs, cfg)
        loss.backward()
        out[str(dev)] = (loss.item(), {k: p.grad.cpu() for k, p in
                                       model.named_parameters()})
    (l_c, g_c), (l_g, g_g) = out["cpu"], out[str(cuda)]
    assert l_g == pytest.approx(l_c, rel=1e-5)
    for k in g_c:
        torch.testing.assert_close(g_g[k], g_c[k], rtol=1e-4, atol=1e-6,
                                   msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_one_optimizer_step_on_the_card_matches_the_cpu(cuda, kind):
    """One step from the same params and gradients: elementwise fp32 (sqrt
    and division within an ulp on the card) and, for Adafactor, mean
    reductions in another order: rtol 1e-5, atol 1e-7."""
    from repro_torch.train import optimizer as optim
    from repro_torch.train.checkpoint import flatten
    rng = np.random.default_rng(1)
    shapes = {"w": (256, 128), "b": (128,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    g0 = {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
          for k, s in shapes.items()}
    got = {}
    for dev in ("cpu", cuda):
        ps = [torch.tensor(p0[k], device=dev, requires_grad=True)
              for k in sorted(shapes)]
        opt = (optim.adamw(ps, 1e-2, weight_decay=0.01) if kind == "adamw"
               else optim.adafactor(ps, 1e-2))
        for p, k in zip(ps, sorted(shapes)):
            p.grad = torch.from_numpy(g0[k]).to(dev)
        opt.step()
        got[str(dev)] = [p.detach().cpu() for p in ps] + [
            t.cpu() for t in flatten(opt.state_tree())]
    for a, c in zip(got[str(cuda)], got["cpu"]):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
def test_circconv_bind_on_the_card_refuses_autograd(cuda):
    from repro_torch.kernels.circconv import ops as cc
    cfg = vsa.VSAConfig(2048, 8, impl="pallas")
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((4, 2048), generator=gen).to(cuda).requires_grad_(True)
    y = torch.randn((4, 2048), generator=gen).to(cuda)
    before = cc.rows_launches
    with pytest.raises(RuntimeError, match="no gradient"):
        vsa.bind(x, y, cfg)
    assert cc.rows_launches == before  # refused before any launch
    with torch.no_grad():
        out = vsa.bind(x, y, cfg)
    assert cc.rows_launches == before + 1
    torch.testing.assert_close(out, vsa.bind(x.detach(), y, vsa.VSAConfig(
        2048, 8, impl="fft")), rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_cnn_params_round_trip_through_the_reference_layout_on_the_card(cuda):
    from repro_torch import convert
    from repro_torch.models import cnn
    model = cnn.init(cnn.CNNConfig(), 3, device=cuda)
    back = convert.cnn_params_from_reference(
        convert.cnn_params_to_reference(model), device=cuda)
    for (k, p), (_, q) in zip(model.named_parameters(),
                              back.named_parameters()):
        assert q.device.type == "cuda" and torch.equal(p, q), k
    assert convert.cnn_params_to_reference(model)["conv0_w"].shape == \
        (3, 3, 1, 32)


def _lm_batch(cfg, dev, B=2, S=16, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)).to(dev)}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-moe-3b-a800m"])
def test_a_smoke_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """fp32 masters and activations, the same batch: the loss within 1e-5
    relative, every gradient within 2e-5 of its leaf's largest |g| (at
    least 1e-3 of the model's largest), and the parameters after one
    AdamW step of ``build_train_step`` within 1e-3 of how far each leaf moved."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.launch import train as TR
    from repro_torch.nn import transformer as T
    spec = registry.get(arch)
    cfg = dataclasses.replace(spec.smoke(), activ_dtype=torch.float32)
    got = {}
    for dev in ("cpu", cuda):
        model = T.init(cfg, torch.Generator().manual_seed(4), "cpu",
                       trainable=True).to(dev)
        start = [p.detach().cpu().clone() for p in model.parameters()]
        loss, _ = T.loss_fn(model, cfg, _lm_batch(cfg, dev))
        loss.backward()
        grads = [p.grad.cpu() for p in model.parameters()]
        model.zero_grad(set_to_none=True)
        _, step = TR.build_train_step(model, spec, 4)
        _, m = step(None, _lm_batch(cfg, dev, seed=2))
        got[str(dev)] = (float(loss.detach()), grads,
                         [p.detach().cpu() for p in model.parameters()],
                         start)
    (lg, gg, pg, _), (lc, gc, pc, start) = got[str(cuda)], got["cpu"]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    top = max(float(g.abs().max()) for g in gc)
    for a, b in zip(gg, gc):
        scale = max(float(b.abs().max()), 1e-3 * top)
        assert float((a - b).abs().max()) <= 2e-5 * scale
    for a, b, s in zip(pg, pc, start):
        assert float((a - b).norm()) <= 1e-3 * float((b - s).norm())


@pytest.mark.cuda
def test_remat_full_holds_less_for_the_backward_pass(cuda):
    """Llama 3.2 3B's widths (d 3072, 24/8 heads of 128, d_ff 8192) at 8
    layers, vocab cut to 512, 2 x 1024 tokens, bf16 activations: with
    remat "full" the memory held from the forward pass for the backward
    (allocated after the loss, less the parameters) is under a quarter of
    what it is without remat, the peak over forward and backward is lower,
    and the gradients are the same."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.nn import transformer as T
    base = dataclasses.replace(registry.get("llama3.2-3b").full(),
                               n_layers=8, vocab=512)
    batch = _lm_batch(base, cuda, B=2, S=1024)
    held, peak, grads = {}, {}, {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        model = T.init(cfg, 0, cuda, trainable=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        floor = torch.cuda.memory_allocated()
        loss, _ = T.loss_fn(model, cfg, batch)
        held[remat] = torch.cuda.memory_allocated() - floor
        loss.backward()
        torch.cuda.synchronize()
        peak[remat] = torch.cuda.max_memory_allocated() - floor
        grads[remat] = [p.grad.float().norm().item()
                        for p in model.parameters()]
        del model, loss
        torch.cuda.empty_cache()
    assert held[True] < 0.25 * held[False], held
    assert peak[True] < peak[False], peak
    np.testing.assert_allclose(grads[True], grads[False], rtol=1e-6)


@pytest.mark.cuda
def test_a_trainable_forward_builds_a_graph_and_its_serving_copy_none(cuda):
    from repro_torch.configs import registry
    from repro_torch.nn import transformer as T
    cfg = registry.get("llama3.2-3b").smoke()
    model = T.init(cfg, 0, cuda, trainable=True)
    toks = _lm_batch(cfg, cuda)["tokens"]
    logits, _ = T.forward(model, cfg, toks)
    assert logits.requires_grad and logits.grad_fn is not None
    served = T.serving_copy(model)
    assert all(p.device.type == "cuda" and not p.requires_grad
               for p in served.parameters())
    assert served.embed.dtype == torch.bfloat16
    out, _ = T.forward(served, cfg, toks)
    assert not out.requires_grad and out.grad_fn is None
    torch.testing.assert_close(out, logits.detach(), rtol=0, atol=0)
