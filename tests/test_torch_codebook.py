"""The port's exhaustive product-codebook baseline (``repro_torch.core.codebook``)
against the reference's, on the same codebooks (drawn with ``jax.random``).

Contract: product vectors within 1e-5 (FFTs in two frameworks), decoded
indices equal, byte counts equal.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import codebook as rcb
from repro.core import factorizer as rfz
from repro.core import vsa as rv
from repro_torch.core import codebook as tcb
from repro_torch.core import vsa as tv


def _problem(dim, blocks, algebra, trials=16, F=3, M=8):
    cfg = rfz.FactorizerConfig(vsa=rv.VSAConfig(dim, blocks), num_factors=F,
                               codebook_size=M, algebra=algebra)
    cbs = rfz.make_codebooks(jax.random.PRNGKey(1), cfg)
    idxs = jax.random.randint(jax.random.PRNGKey(7), (trials, F), 0, M)
    qs = rfz.bind_combo(cbs, idxs, cfg.vsa)
    return cfg, cbs, np.asarray(idxs), qs


@pytest.mark.parametrize("dim,blocks,algebra", [
    (512, 4, "unitary"), (256, 1, "unitary"), (256, 256, "bipolar")])
def test_product_codebook_and_brute_force_decode_match_reference(dim, blocks,
                                                                 algebra):
    cfg, cbs, idxs, qs = _problem(dim, blocks, algebra)
    ref = rcb.build_product_codebook(cbs, cfg.vsa)
    got = tcb.build_product_codebook(torch.from_numpy(np.array(cbs)),
                                     tv.VSAConfig(dim, blocks))
    assert got.shape == ref.shape == (8, 8, 8)
    assert got.vectors.shape == (8 ** 3, dim)
    np.testing.assert_allclose(got.vectors.numpy(), np.asarray(ref.vectors),
                               atol=1e-5)
    t_qs = torch.from_numpy(np.array(qs))
    dec = tcb.brute_force_decode(t_qs, got)
    assert dec.dtype == torch.int32 and dec.shape == (16, 3)
    np.testing.assert_array_equal(dec.numpy(), idxs)
    np.testing.assert_array_equal(
        dec.numpy(), np.asarray(rcb.brute_force_decode(qs, ref)))
    one = tcb.brute_force_decode(t_qs[5], got)  # a single query [D] -> [F]
    assert one.shape == (3,)
    np.testing.assert_array_equal(one.numpy(), idxs[5])


@pytest.mark.parametrize("F,M,D,itemsize", [(3, 10, 1024, 4), (4, 10, 1024, 1),
                                            (5, 16, 2048, 4)])
def test_product_codebook_bytes_equal_reference(F, M, D, itemsize):
    assert (tcb.product_codebook_bytes(F, M, D, itemsize)
            == rcb.product_codebook_bytes(F, M, D, itemsize) == M ** F * D
            * itemsize)
