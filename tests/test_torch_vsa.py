"""The port's VSA algebra (``repro_torch.core.vsa``) against ``repro.core.vsa``.

Inputs are made with numpy and fed to both packages.  Bipolar (MAP) ops are
exact; FFT ops are held to fp32 round-off (atol 1e-5 on unit-norm vectors).
``impl="pallas"`` (the circconv plain versions on the CPU) is held to every
reference impl at the reference's own tolerance, atol 1e-4.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import vsa as rv
from repro_torch.core import vsa as tv
from repro_torch.kernels.circconv import kernel as cc_kernel
from repro_torch.kernels.circconv import ops as cc_ops

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


def test_random_normal_has_unit_mean_squared_norm_and_is_seeded():
    """As the reference's ``random_normal``: i.i.d. N(0, 1/D) lanes, so a
    vector's squared norm is chi^2_D / D (mean 1, variance 2/D); the mean of
    N vectors' lies within 3 sigma = 3 sqrt(2 / (N D)) of 1."""
    cfg = tv.VSAConfig(1024, 4)
    n = 512
    x = tv.random_normal(torch.Generator().manual_seed(5), (2, n // 2), cfg,
                         device="cpu")
    assert x.shape == (2, n // 2, 1024) and x.dtype == torch.float32
    sq = float(torch.sum(x * x, dim=-1).mean())
    assert abs(sq - 1.0) <= 3 * (2.0 / (n * 1024)) ** 0.5, sq
    ref = np.asarray(rv.random_normal(jax.random.PRNGKey(5), (n,),
                                      rv.VSAConfig(1024, 4)))
    assert abs(float(np.sum(ref * ref, -1).mean()) - 1.0) <= \
        3 * (2.0 / (n * 1024)) ** 0.5  # the reference's own draw, same bound
    again = tv.random_normal(torch.Generator().manual_seed(5), (2, n // 2),
                             cfg, device="cpu")
    other = tv.random_normal(torch.Generator().manual_seed(6), (2, n // 2),
                             cfg, device="cpu")
    assert torch.equal(x, again) and not torch.equal(x, other)
    assert tv.random_normal(0, (3,), cfg, dtype=torch.float64,
                            device="cpu").dtype == torch.float64


def test_pallas_impl_waits_for_the_circconv_kernels():
    """The circconv kernels wait for a CUDA tensor: on CPU tensors
    ``impl="pallas"`` binds and unbinds through their plain versions and
    launches neither kernel, and the kernel wrappers refuse CPU tensors."""
    tc = tv.VSAConfig(64, 4, impl="pallas")
    x = torch.from_numpy(_vecs((3, 64), 8, False))
    y = torch.from_numpy(_vecs((3, 64), 9, False))
    before = (cc_ops.rows_launches, cc_ops.single_launches)
    got = tv.bind(x, y, tc)
    back = tv.unbind(got, y, tc)
    want = cc_ops.block_circconv_ref(tc.blockify(x), tc.blockify(y))
    assert (cc_ops.rows_launches, cc_ops.single_launches) == before
    assert got.dtype == torch.float32 and got.shape == (3, 64)
    assert torch.equal(got, tc.flatten(want))
    assert torch.equal(back, tc.flatten(cc_ops.block_circconv_ref(
        tc.blockify(got), tc.blockify(tv.involution(y, tc)))))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cc_kernel.circconv_rows(tc.blockify(x)[0], tc.blockify(y)[0])


def test_pallas_impl_matches_reference_impls():
    """The reference's ``test_impls_agree`` inputs through the port's pallas
    bind and the reference's fft, direct and pallas binds (its tolerance)."""
    rc = rv.VSAConfig(dim=256, blocks=2)
    tc = tv.VSAConfig(dim=256, blocks=2, impl="pallas")
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    x = np.array(rv.random_normal(k1, (3,), rc))
    y = np.array(rv.random_normal(k2, (3,), rc))
    got = tv.bind(torch.from_numpy(x), torch.from_numpy(y), tc).numpy()
    for impl in ("fft", "direct", "pallas"):
        np.testing.assert_allclose(got, np.asarray(rv.bind(x, y, rc, impl=impl)),
                                   atol=1e-4, err_msg=impl)
    got = tv.unbind(torch.from_numpy(x), torch.from_numpy(y), tc).numpy()
    np.testing.assert_allclose(got, np.asarray(rv.unbind(x, y, rc, impl="pallas")),
                               atol=1e-4)


def test_pallas_bind_broadcasts_both_operands():
    """MIMONet's unbind shape: [N, 1, D] against [1, S, D].  The port's
    pallas bind equals its fft bind; the reference's ``block_circconv``
    broadcasts only y to x's shape and raises (a recorded divergence,
    ROADMAP Queue C)."""
    rc, tc = rv.VSAConfig(256, 8), tv.VSAConfig(256, 8, impl="pallas")
    x = _vecs((3, 1, 256), 10, False)
    y = _vecs((1, 2, 256), 11, False)
    got = tv.bind(torch.from_numpy(x), torch.from_numpy(y), tc)
    want = tv.bind(torch.from_numpy(x), torch.from_numpy(y), tc, impl="fft")
    assert got.shape == (3, 2, 256)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(rv.bind(x, y, rc, impl="direct")),
                               atol=1e-5)
    with pytest.raises(ValueError, match="broadcast"):
        rv.bind(x, y, rc, impl="pallas")


def test_cuda_default_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        tv.random_bipolar(torch.Generator(), (1,), tv.VSAConfig(8, 8))
