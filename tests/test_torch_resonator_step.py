"""The port's fused resonator sweep against the reference's Pallas kernels.

On the CPU the port runs the plain versions (``ref.py``); they must equal
the reference kernels (interpret mode) and oracles BITWISE on +-1 inputs,
where every score and projection entry is an integer fp32 holds exactly.
The CUDA kernel itself is checked against the plain versions on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from repro.kernels.resonator_step import kernel as rsk
from repro.kernels.resonator_step import ref as rsr
from repro_torch.device import disable_tf32
from repro_torch.kernels.resonator_step import kernel as tk
from repro_torch.kernels.resonator_step import ops as tops

F, M, D = 3, 12, 256
MASK_SIZES = (5, 12, 0)  # ragged cardinalities and an ALL-invalid factor


def _bipolar(rng, shape):
    return np.where(rng.random(shape) < 0.5, 1.0, -1.0).astype(np.float32)


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    return (_bipolar(rng, (F, M, D)), _bipolar(rng, (n, D)),
            _bipolar(rng, (n, F, D)))


def _mask():
    return np.stack([np.arange(M) < m for m in MASK_SIZES])


@pytest.mark.parametrize("n", [1, 3, 8, 50, 130])
@pytest.mark.parametrize("act", ["identity", "abs"])
def test_plain_batch_bit_equals_reference_kernel(n, act):
    disable_tf32()
    cbs, qs, est = _inputs(n, n)
    a_k, e_k = rsk.resonator_step_batch(qs, est, cbs, activation=act,
                                        interpret=True)
    a_r, e_r = rsr.resonator_step_batch_ref(qs, est, cbs, activation=act)
    a_t, e_t = tops.fused_resonator_step_batch(
        torch.from_numpy(qs), torch.from_numpy(est), torch.from_numpy(cbs),
        activation=act)
    for ref_a, ref_e in ((a_k, e_k), (a_r, e_r)):
        np.testing.assert_array_equal(a_t.numpy(), np.asarray(ref_a))
        np.testing.assert_array_equal(e_t.numpy(), np.asarray(ref_e))


@pytest.mark.parametrize("n", [1, 3, 8, 50, 130])
@pytest.mark.parametrize("act", ["identity", "abs"])
def test_plain_masked_bit_equals_reference_kernel(n, act):
    disable_tf32()
    cbs, qs, est = _inputs(n, n + 100)
    mask = _mask()
    a_k, e_k = rsk.resonator_step_batch_masked(qs, est, cbs, mask,
                                               activation=act, interpret=True)
    a_r, e_r = rsr.resonator_step_batch_masked_ref(qs, est, cbs, mask,
                                                   activation=act)
    a_t, e_t = tops.fused_resonator_step_batch_masked(
        torch.from_numpy(qs), torch.from_numpy(est), torch.from_numpy(cbs),
        torch.from_numpy(mask), activation=act)
    for ref_a, ref_e in ((a_k, e_k), (a_r, e_r)):
        np.testing.assert_array_equal(a_t.numpy(), np.asarray(ref_a))
        np.testing.assert_array_equal(e_t.numpy(), np.asarray(ref_e))
    # invalid rows never win the argmax; the all-invalid factor's projection
    # is exactly zero and saturates to +1 everywhere
    assert a_t[:, 0, MASK_SIZES[0]:].max() <= -1e9
    assert a_t[:, 2].max() <= -1e9
    assert bool((e_t[:, 2] == 1.0).all())


def test_single_query_wrapper_matches_reference():
    cbs, qs, est = _inputs(1, 5)
    a_r, e_r = rsr.resonator_step_ref(qs[0], est[0], cbs, activation="abs")
    a_t, e_t = tops.fused_resonator_step(
        torch.from_numpy(qs[0]), torch.from_numpy(est[0]),
        torch.from_numpy(cbs), activation="abs")
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_r))
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_r))


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    cbs, qs, est = (torch.from_numpy(a) for a in _inputs(4, 9))
    before = (tops.launches, tops.masked_launches)
    tops.fused_resonator_step_batch(qs, est, cbs)
    tops.fused_resonator_step_batch_masked(qs, est, cbs,
                                           torch.from_numpy(_mask()))
    assert (tops.launches, tops.masked_launches) == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never computes on the CPU: no silent fallback."""
    cbs, qs, est = (torch.from_numpy(a) for a in _inputs(2, 3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk.resonator_step_batch(qs, est, cbs)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk.resonator_step_batch_masked(qs, est, cbs, torch.from_numpy(_mask()))


def test_fused_config_type_is_checked():
    cbs, qs, est = (torch.from_numpy(a) for a in _inputs(2, 3))
    with pytest.raises(TypeError, match="FusedConfig"):
        tops.fused_resonator_step_batch(qs, est, cbs, fused=True)


@pytest.mark.parametrize("n,f,m,d,tn", [
    (256, 3, 10, 2048, 128),  # the engine's shape
    (1, 3, 10, 2048, 128), (7, 3, 10, 2048, 128), (257, 3, 10, 2048, 128),
    (4096, 3, 10, 2048, 128), (130, 3, 12, 256, 8), (5, 1, 1, 1, 128),
    (64, 3, 1024, 4096, 128), (100, 2, 700, 33, 16), (3, 4, 10, 100000, 1),
])
def test_launch_geometry_fits_the_card(n, f, m, d, tn):
    g = tk.launch_geometry(n, f, m, d, tn, sms=132)
    assert g.rows & (g.rows - 1) == 0 and 1 <= g.rows <= min(tn, tk.MAX_ROWS)
    assert g.clusters == -(-n // g.rows)
    # D cut into csize slices of ds (a multiple of 4), none of them empty
    assert 1 <= g.csize <= tk.MAX_CLUSTER and g.ds % 4 == 0
    assert (g.csize - 1) * g.ds < d <= g.csize * g.ds
    assert g.dc % 4 == 0 and 4 <= g.dc <= g.ds
    # M in equal score tiles of at most 8 rows, fewer than a tile wasted
    tiles = -(-m // g.mt)
    assert 1 <= g.mt <= tk.MAX_MT and tiles * g.mt - m < tiles
    assert g.smem == 4 * tk.smem_floats(f, m, g.rows, g.dc)
    assert g.smem <= tk.SMEM_BUDGET < 227 * 1024
    if g.rows > 1:  # never fewer blocks than SMs once rows grew past one
        assert g.clusters * g.csize >= 132


def test_launch_geometry_at_the_engine_shape():
    """Clusters of 8 blocks, each a 256-float slice of D, 8 rows a cluster:
    256 blocks fill the 132 SMs, and every factor's codebook slice
    (3 x 10 x 256 floats) stays resident from the scores to the
    projection (one chunk); M = 10 is two exact score tiles of 5."""
    g = tk.launch_geometry(256, 3, 10, 2048, 128, sms=132)
    assert g == (8, 32, 8, 256, 256, 5,
                 4 * (256 * (30 + 8 * 3) + 240 + 8 * 3 * 12 + 32))
    assert g.clusters * g.csize >= 132 and g.dc == g.ds


@pytest.mark.parametrize("shape,match", [
    ((4, 3, 1025, 256), "M=1025"), ((4, 3, 0, 256), "M=0"),
    ((0, 3, 10, 256), "N=0"), ((4, 3, 10, 0), "D=0"),
    ((1, 20, 1024, 256), "do not fit"),
])
def test_launch_geometry_rejects_unsupported_shapes(shape, match):
    with pytest.raises(ValueError, match=match):
        tk.launch_geometry(*shape, tn=128, sms=132)
