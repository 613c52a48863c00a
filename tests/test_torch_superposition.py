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


def _mimo_model():
    from repro.configs.registry import ARCHS
    from repro.nn import transformer as RT
    from repro_torch import convert
    from repro_torch.configs import registry

    cfg_r = ARCHS["llama3.2-3b"].smoke()
    cfg_t = registry.get("llama3.2-3b").smoke()
    params, _ = RT.init(jax.random.PRNGKey(0), cfg_r)
    model = convert.lm_params_from_reference(jax.tree.map(np.asarray, params),
                                             cfg_t, device="cpu")
    return cfg_r, params, cfg_t, model


def test_mimo_lm_logits_match_the_reference_run_op_by_op():
    """Two token streams through ONE llama backbone pass (bf16), against the
    reference run op by op: within one bf16 ulp of each row's largest
    |logit| (its FFT binds round in other places)."""
    cfg_r, params, cfg_t, model = _mimo_model()
    keys = np.array(rsup.make_stream_keys(jax.random.PRNGKey(1), 2,
                                          cfg_r.d_model))
    toks = np.random.default_rng(2).integers(0, cfg_r.vocab, (2, 2, 16)
                                             ).astype(np.int32)
    with jax.disable_jit():
        want = np.asarray(rsup.mimo_lm_logits(
            params, cfg_r, jnp.asarray(toks), jnp.asarray(keys))
        ).astype(np.float32)
    got = tsup.mimo_lm_logits(model, cfg_t, torch.from_numpy(toks),
                              torch.from_numpy(keys))
    assert got.shape == (2, 2, 16, cfg_r.vocab)
    assert got.dtype == cfg_t.activ_dtype
    top = np.abs(want).max(-1, keepdims=True)
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert (np.abs(got.float().numpy() - want) <= ulp).all()


def test_mimo_lm_streams_are_separable():
    """The reference's oracle on the port: per-stream logits track their own
    stream when the streams swap key slots, not the other stream."""
    cfg_r, _, cfg_t, model = _mimo_model()
    keys = tsup.make_stream_keys(1, 2, cfg_t.d_model, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg_t.vocab, (2, 2, 16)))
    logits = tsup.mimo_lm_logits(model, cfg_t, toks, keys).float()
    assert bool(torch.isfinite(logits).all())
    swapped = tsup.mimo_lm_logits(model, cfg_t, toks.flip(1), keys).float()
    a = logits[:, 0].ravel().numpy()
    corr_same = np.corrcoef(a, swapped[:, 1].ravel().numpy())[0, 1]
    corr_other = np.corrcoef(a, swapped[:, 0].ravel().numpy())[0, 1]
    assert corr_same > corr_other, (corr_same, corr_other)
