"""The port's quantization (``repro_torch.core.quantization``) against the
reference's, and ``convert.qtensor_from_reference``.

Inputs are drawn with ``jax.random`` and carried across as numpy.  Contract:
``quantize`` values and scales BITWISE for int8, fp8 e4m3 and fp8 e5m2 (fp8
compared as their bytes); the int8 ``quantized_matvec`` BITWISE (exact
integer accumulation on both sides); the fp8 one within one bf16 rounding
(both contract in bf16, in another summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import factorizer as rfz
from repro.core import quantization as rq
from repro_torch import convert
from repro_torch.core import factorizer as tfz
from repro_torch.core import quantization as tq

FMTS = ["int8", "fp8_e4m3", "fp8_e5m2"]
SHAPES = [(3, 10, 1024), (7, 100), (1000, 100)]


def _x(shape, seed=0):
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape)) * 3
    x[(0,) * (len(shape) - 1)][:4] = 0.0  # exact zeros round-trip
    return x


def _bytes(values):
    """Values as comparable integers (fp8 through their bytes)."""
    if isinstance(values, torch.Tensor):
        if values.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            values = values.view(torch.uint8)
        return values.numpy()
    values = np.asarray(values)
    return values.view(np.uint8) if values.dtype.itemsize == 1 and \
        values.dtype != np.int8 else values


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fmt", FMTS)
def test_quantize_bit_equals_reference(fmt, shape):
    x = _x(shape)
    ref = rq.quantize(jnp.asarray(x), fmt)
    got = tq.quantize(torch.from_numpy(x), fmt)
    assert got.values.dtype == {"int8": torch.int8,
                                "fp8_e4m3": torch.float8_e4m3fn,
                                "fp8_e5m2": torch.float8_e5m2}[fmt]
    np.testing.assert_array_equal(_bytes(got.values), _bytes(ref.values))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    assert got.shape == tuple(shape) and got.scale.shape == shape[:-1] + (1,)
    assert got.nbytes() == ref.nbytes()
    for dtype_t, dtype_r in ((torch.float32, jnp.float32),
                             (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            got.dequantize(dtype_t).float().numpy(),
            np.asarray(ref.dequantize(dtype_r).astype(jnp.float32)))


def test_round_half_to_even_as_the_reference():
    # amax 127 makes the scale 1.0 (the 1e-12 is below its ulp), so x / scale
    # lands exactly on the halves
    x = np.array([[0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.0]], np.float32)
    got = tq.quantize(torch.from_numpy(x), "int8")
    assert got.scale.item() == 1.0
    np.testing.assert_array_equal(got.values.numpy(),
                                  [[0, 2, 2, 0, -2, -2, 126, 127]])
    np.testing.assert_array_equal(
        got.values.numpy(), np.asarray(rq.quantize(jnp.asarray(x)).values))


def test_unknown_format_raises():
    with pytest.raises(ValueError):
        tq.quantize(torch.ones(2, 3), "int4")


@pytest.mark.parametrize("fmt", FMTS)
def test_quantized_matvec_matches_reference(fmt):
    q = np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 5, 64)))
    w = rq.quantize(jax.random.normal(jax.random.PRNGKey(2), (10, 64)), fmt)
    ref = np.asarray(rq.quantized_matvec(jnp.asarray(q), w))
    got = tq.quantized_matvec(torch.from_numpy(q),
                              convert.qtensor_from_reference(w, device="cpu"))
    assert got.dtype == torch.float32 and got.shape == (2, 5, 10)
    if fmt == "int8":
        np.testing.assert_array_equal(got.numpy(), ref)
    else:  # one bf16 rounding of the result
        np.testing.assert_allclose(got.numpy(), ref, rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(ref).max())


def test_int8_matvec_accumulates_exactly_where_int8_wraps():
    """Full-scale rows: every product is -127^2 and the sum -64 * 16129, far
    beyond what an int8 accumulator holds."""
    q = torch.full((1, 64), 2.0)
    w = tq.quantize(torch.full((3, 64), -5.0))
    got = tq.quantized_matvec(q, w)
    ref = rq.quantized_matvec(jnp.full((1, 64), 2.0),
                              rq.quantize(jnp.full((3, 64), -5.0)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    torch.testing.assert_close(got, torch.full((1, 3), -640.0), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("fmt", FMTS)
def test_quantization_error_matches_reference(fmt):
    x = _x((4, 256), seed=3)
    np.testing.assert_allclose(
        tq.quantization_error(torch.from_numpy(x), fmt).item(),
        float(rq.quantization_error(jnp.asarray(x), fmt)), rtol=1e-5)


@pytest.mark.parametrize("fmt", FMTS)
def test_convert_carries_a_reference_qtensor_bit_for_bit(fmt):
    ref = rq.quantize(jnp.asarray(_x((3, 10, 128), seed=4)), fmt)
    got = convert.qtensor_from_reference(ref, device="cpu")
    assert isinstance(got, tq.QTensor)
    np.testing.assert_array_equal(_bytes(got.values), _bytes(ref.values))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(got.dequantize().numpy(),
                                  np.asarray(ref.dequantize()))
    # and back: the port's own quantize of the same input is the same tensor
    again = tq.quantize(torch.from_numpy(_x((3, 10, 128), seed=4)), fmt)
    assert torch.equal(_as_int(again.values), _as_int(got.values))


def _as_int(v):
    return v.view(torch.uint8) if v.dtype != torch.int8 else v


def test_convert_refuses_other_value_types():
    bad = rq.QTensor(jnp.ones((2, 3), jnp.float32), jnp.ones((2, 1)))
    with pytest.raises(ValueError, match="int8"):
        convert.qtensor_from_reference(bad, device="cpu")


def test_qtensor_indexes_by_factor_and_moves():
    qt = tq.quantize(torch.from_numpy(_x((3, 10, 64))))
    f1 = qt[1]
    assert f1.shape == (10, 64) and f1.scale.shape == (10, 1)
    assert torch.equal(f1.values, qt.values[1])
    moved = qt.to("cpu")
    assert moved.device.type == "cpu" and torch.equal(moved.values, qt.values)


@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3"])
def test_quantize_codebooks_equals_reference(fmt):
    rcfg = rfz.FactorizerConfig(vsa=rfz.VSAConfig(256, 4), num_factors=3,
                                codebook_size=7, algebra="unitary")
    cbs = rfz.make_codebooks(jax.random.PRNGKey(1), rcfg)
    ref = rfz.quantize_codebooks(cbs, fmt)
    got = tfz.quantize_codebooks(torch.from_numpy(np.array(cbs)), fmt)
    np.testing.assert_array_equal(_bytes(got.values), _bytes(ref.values))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    assert got.nbytes() < cbs.size * 4 / 3.5  # Tab. IX: 4x smaller
