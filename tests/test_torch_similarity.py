"""The port's int8 codebook similarity (``repro_torch.kernels.similarity``)
against the reference kernel run in Pallas interpret mode.

On the CPU ``ops.codebook_scores`` takes the plain version (``ref.py``) and
launches nothing; the CUDA kernel itself is held against that plain version
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Tolerance:
the reference's own for its kernel, atol 2e-2 and rtol 1e-3
(``tests/test_kernels.py``).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.quantization import quantize as r_quantize
from repro.kernels.similarity import kernel as rsk
from repro.kernels.similarity import ref as rsr
from repro_torch import convert
from repro_torch.core.quantization import quantize
from repro_torch.kernels.similarity import kernel as k
from repro_torch.kernels.similarity import ops

# the reference test's shapes, then the int8 serving shape (256 slots, M=10,
# D=1024)
SHAPES = [(1, 10, 64), (7, 100, 512), (128, 257, 1024), (3, 1000, 100),
          (256, 10, 1024)]


def _inputs(n, m, d):
    kq, kw = jax.random.split(jax.random.PRNGKey(n + m + d))
    q = jax.random.normal(kq, (n, d))
    w = r_quantize(jax.random.normal(kw, (m, d)), "int8")
    return q, w


@pytest.mark.parametrize("n,m,d", SHAPES)
def test_plain_version_matches_the_reference_kernel(n, m, d):
    q, w = _inputs(n, m, d)
    want = np.asarray(rsk.similarity_int8(q, w.values, w.scale,
                                          interpret=True))
    tw = convert.qtensor_from_reference(w, device="cpu")
    tq = torch.from_numpy(np.array(q))
    before = ops.launches
    got = ops.codebook_scores(tq, tw)
    assert ops.launches == before  # a CPU tensor launches nothing
    assert got.shape == (n, m) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=1e-3)
    np.testing.assert_allclose(  # and the reference's own oracle, tighter
        got.numpy(), np.asarray(rsr.similarity_int8_ref(q, w.values, w.scale)),
        atol=1e-4, rtol=1e-5)


def test_codebook_scores_keeps_leading_dims():
    q, w = _inputs(6, 10, 64)
    tw = convert.qtensor_from_reference(w, device="cpu")
    tq = torch.from_numpy(np.array(q))
    got = ops.codebook_scores(tq.reshape(2, 3, 64), tw)
    assert got.shape == (2, 3, 10)
    assert torch.equal(got.reshape(6, 10), ops.codebook_scores(tq, tw))


def test_int8_scores_keep_the_fp32_argmax():
    """Quantised scores must preserve the argmax (Tab. IX parity), as in the
    reference's tests/test_kernels.py."""
    kq, kw = jax.random.split(jax.random.PRNGKey(9))
    w_f = np.array(jax.random.normal(kw, (50, 512)))
    q = w_f[17] + 0.1 * np.asarray(jax.random.normal(kq, (512,)))
    scores = ops.codebook_scores(torch.from_numpy(q[None]),
                                 quantize(torch.from_numpy(w_f)))
    assert int(torch.argmax(scores)) == 17


def test_the_kernel_wrapper_refuses_cpu_tensors():
    q = torch.randn(4, 64)
    w = quantize(torch.randn(10, 64))
    before = ops.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        k.similarity_int8(q, w.values, w.scale)
    with pytest.raises(ValueError, match=r"\[N, D\]"):
        k.similarity_int8(q[0], w.values, w.scale)
    assert ops.launches == before


@pytest.mark.parametrize("n,m,d,tn,tm", [
    (256, 10, 1024, 1, 10),  # serving shape: M in one exact tile, 256 blocks
    (1, 1, 1, 1, 1),
    (3, 1000, 100, 1, 16),  # 63 tiles of 16 rows: 8 rows past M
    (128, 257, 1024, 2, 16),  # 17 tiles of 16, two rows a block
    (5, 8, 5000, 1, 8),
    (5, 33, 8192, 1, 11),  # 3 exact tiles of 11
])
def test_launch_geometry(n, m, d, tn, tm):
    assert k.launch_geometry(n, m, d, sms=132) == (tn, tm)
    tiles = -(-m // tm)
    assert tn * tm <= k.MAX_TILE and tm <= k.MAX_TM
    assert tiles * tm - m < tiles  # fewer than one row a tile wasted
    if tn > 1:  # a larger tile only where the grid still fills the SMs
        assert -(-n // tn) * tiles >= 132


@pytest.mark.parametrize("n,m,d", [(256, 10, 1024), (128, 257, 1024)])
def test_launch_geometry_fills_the_sms_at_the_timed_shapes(n, m, d):
    tn, tm = k.launch_geometry(n, m, d, sms=132)
    assert -(-n // tn) * -(-m // tm) >= 132


def test_launch_geometry_refuses_shapes_beyond_the_design():
    with pytest.raises(ValueError, match=">= 1"):
        k.launch_geometry(0, 10, 64, sms=132)
    with pytest.raises(ValueError, match="2\\^31"):
        k.launch_geometry(2 ** 20, 10, 2 ** 12, sms=132)
    with pytest.raises(ValueError, match="tiles"):
        k.launch_geometry(1, 32 * 65536, 1, sms=132)
