"""The port's superposition wrapper (``repro_torch.core.superposition``)
against ``repro.core.superposition`` on the reference's keys.

The keys come from the reference's ``make_stream_keys`` (a ``jax.random``
key) and the embeddings from numpy; both packages bind through their
default ``impl`` (fft).  Tolerance atol 1e-5, rtol 1e-4 (fp32 FFTs of
unit-variance embeddings in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import superposition as rsup
from repro_torch.core import superposition as tsup
from repro_torch.core import vsa as tv


def _inputs(streams, d, seed):
    keys = np.array(rsup.make_stream_keys(jax.random.PRNGKey(seed), streams, d))
    embs = np.random.default_rng(seed).normal(
        size=(2, streams, 8, d)).astype(np.float32)
    return keys, embs


@pytest.mark.parametrize("carrier_rms", [None, 4.0])
@pytest.mark.parametrize("streams,d,blocks", [(3, 512, 8), (2, 256, 1)])
def test_superpose_and_unbind_match_the_reference(carrier_rms, streams, d,
                                                  blocks):
    keys, embs = _inputs(streams, d, streams + d)
    want = rsup.superpose_embeddings(jnp.asarray(embs), jnp.asarray(keys),
                                     blocks, carrier_rms=carrier_rms)
    got = tsup.superpose_embeddings(torch.from_numpy(embs),
                                    torch.from_numpy(keys), blocks,
                                    carrier_rms=carrier_rms)
    assert got.shape == (2, 8, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-4)
    rec = tsup.unbind_hidden(got, torch.from_numpy(keys), blocks)
    want_rec = rsup.unbind_hidden(want, jnp.asarray(keys), blocks)
    assert rec.shape == (2, streams, 8, d)
    np.testing.assert_allclose(rec.numpy(), np.asarray(want_rec), atol=1e-5,
                               rtol=1e-4)


def test_superpose_unbind_roundtrip():
    """The reference's ``test_superpose_unbind_roundtrip`` on the port's own
    keys: each recovered stream correlates best with its own original."""
    keys = tsup.make_stream_keys(0, 3, 512, device="cpu")
    embs = torch.randn((2, 3, 8, 512), generator=torch.Generator().manual_seed(1))
    rec = tsup.unbind_hidden(tsup.superpose_embeddings(embs, keys), keys)
    for s in range(3):
        own = float(torch.mean(rec[:, s] * embs[:, s]))
        other = max(float(torch.mean(rec[:, s] * embs[:, o]))
                    for o in range(3) if o != s)
        assert own > 2 * abs(other), (s, own, other)


def test_make_stream_keys_are_unitary():
    keys = tsup.make_stream_keys(torch.Generator().manual_seed(2), 4, 1024,
                                 blocks=4, device="cpu")
    cfg = tv.VSAConfig(1024, 4)
    assert keys.shape == (4, 1024) and keys.dtype == torch.float32
    spec = torch.fft.rfft(cfg.blockify(keys), dim=-1)
    np.testing.assert_allclose(spec.abs().numpy(), np.full(spec.shape, 0.5),
                               rtol=1e-4)
    again = tsup.make_stream_keys(2, 4, 1024, blocks=4, device="cpu")
    assert torch.equal(keys, again)


def test_mimo_lm_logits_waits_for_the_full_sequence_forward():
    with pytest.raises(NotImplementedError, match="Queue A item 1b"):
        tsup.mimo_lm_logits(None, None, torch.zeros((1, 2, 4), dtype=torch.long),
                            torch.zeros((2, 64)))
