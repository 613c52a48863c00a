"""The port's VSA algebra (``repro_torch.core.vsa``) against ``repro.core.vsa``.

Inputs are made with numpy and fed to both packages.  Bipolar (MAP) ops are
exact; FFT ops are held to fp32 round-off (atol 1e-5 on unit-norm vectors).
"""
import numpy as np
import pytest
import torch

from repro.core import vsa as rv
from repro_torch.core import vsa as tv

ALGEBRAS = {"map": (256, 256), "block": (256, 4), "hrr": (128, 1)}


def _cfgs(name):
    dim, blocks = ALGEBRAS[name]
    return rv.VSAConfig(dim, blocks), tv.VSAConfig(dim, blocks)


def _vecs(shape, seed, bipolar):
    rng = np.random.default_rng(seed)
    if bipolar:
        return np.where(rng.random(shape) < 0.5, 1.0, -1.0).astype(np.float32)
    return (rng.normal(size=shape) / np.sqrt(shape[-1])).astype(np.float32)


def _close(t, ref, exact):
    if exact:
        np.testing.assert_array_equal(t.numpy(), np.asarray(ref))
    else:
        np.testing.assert_allclose(t.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("algebra", list(ALGEBRAS))
@pytest.mark.parametrize("impl", ["fft", "direct"])
def test_bind_and_unbind_match_reference(algebra, impl):
    rc, tc = _cfgs(algebra)
    exact = algebra == "map" and impl == "direct"
    x = _vecs((3, rc.dim), 1, algebra == "map")
    y = _vecs((3, rc.dim), 2, algebra == "map")
    _close(tv.bind(torch.from_numpy(x), torch.from_numpy(y), tc, impl=impl),
           rv.bind(x, y, rc, impl=impl), exact)
    _close(tv.unbind(torch.from_numpy(x), torch.from_numpy(y), tc, impl=impl),
           rv.unbind(x, y, rc, impl=impl), exact)


@pytest.mark.parametrize("algebra", list(ALGEBRAS))
def test_bind_all_and_involution_match_reference(algebra):
    rc, tc = _cfgs(algebra)
    xs = _vecs((4, 3, rc.dim), 3, algebra == "map")
    exact = algebra == "map"  # Hadamard product when lanes == 1
    _close(tv.bind_all(torch.from_numpy(xs), tc, axis=-2),
           rv.bind_all(xs, rc, axis=-2), exact)
    _close(tv.bind_all(torch.from_numpy(xs), tc, axis=0),
           rv.bind_all(xs, rc, axis=0), exact)
    _close(tv.involution(torch.from_numpy(xs), tc), rv.involution(xs, rc), True)


def test_unitary_unbind_recovers_the_bound_atom():
    tc = tv.VSAConfig(256, 4)
    g = torch.Generator().manual_seed(0)
    x, y = tv.random_unitary(g, (2,), tc, device="cpu")
    np.testing.assert_allclose(
        tv.similarity(tv.unbind(tv.bind(x, y, tc), y, tc), x).item(), 1.0,
        atol=1e-5)
    np.testing.assert_allclose(torch.linalg.norm(x).item(), 1.0, atol=1e-5)


def test_normalize_sign_maps_zero_to_plus_one():
    x = np.array([[-2.0, 0.0, 3.0, -0.0, 1e-30, -1e-30]], np.float32)
    got = tv.normalize_sign(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(rv.normalize_sign(x)))
    np.testing.assert_array_equal(got.numpy(), [[-1, 1, 1, 1, 1, -1]])


@pytest.mark.parametrize("algebra", ["block", "hrr"])
def test_normalize_unitary_matches_reference(algebra):
    rc, tc = _cfgs(algebra)
    x = _vecs((5, rc.dim), 4, False)
    _close(tv.normalize_unitary(torch.from_numpy(x), tc),
           rv.normalize_unitary(x, rc), False)


@pytest.mark.parametrize("bipolar", [True, False])
def test_similarity_and_codebook_similarity_match_reference(bipolar):
    x = _vecs((6, 256), 5, bipolar)
    y = _vecs((6, 256), 6, bipolar)
    cb = _vecs((10, 256), 7, bipolar)
    got = tv.similarity(torch.from_numpy(x), torch.from_numpy(y))
    want = np.asarray(rv.similarity(x, y))
    if bipolar:  # integer dot products over sqrt(D) norms: exact
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tv.codebook_similarity(torch.from_numpy(x), torch.from_numpy(cb)).numpy(),
        np.asarray(rv.codebook_similarity(x, cb)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tv.bundle(torch.from_numpy(x)).numpy(), np.asarray(rv.bundle(x)),
        rtol=1e-6, atol=1e-7)


def test_random_bipolar_is_pm1_and_device_independent():
    tc = tv.VSAConfig(64, 64)
    a = tv.random_bipolar(torch.Generator().manual_seed(3), (2, 5), tc,
                          device="cpu")
    b = tv.random_bipolar(torch.Generator().manual_seed(3), (2, 5), tc,
                          device="cpu")
    assert a.shape == (2, 5, 64) and a.dtype == torch.float32
    assert bool((a.abs() == 1).all()) and torch.equal(a, b)


def test_pallas_impl_waits_for_the_circconv_kernels():
    tc = tv.VSAConfig(64, 4, impl="pallas")
    x = torch.ones(64)
    with pytest.raises(NotImplementedError, match="Queue B"):
        tv.bind(x, x, tc)


def test_cuda_default_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        tv.random_bipolar(torch.Generator(), (1,), tv.VSAConfig(8, 8))
