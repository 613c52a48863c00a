"""CUDA kernels of the port against their plain versions, on the card.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips elsewhere.
This file imports nothing of the JAX package, so it also runs where JAX is
not installed:  ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import factorizer as fz
from repro_torch.core import vsa
from repro_torch.device import disable_tf32
from repro_torch.kernels.resonator_step import ops
from repro_torch.kernels.resonator_step import ref


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
