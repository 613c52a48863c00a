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
