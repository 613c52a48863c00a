"""The port's MIMONet (``repro_torch.models.mimonet``) against
``repro.models.mimonet`` on the same weights and images.

The reference's weights (``mimonet.init`` with a ``jax.random`` key) cross
over with ``convert.mimonet_params_from_reference``; images come from numpy
(``attribute_classification_batch``).  Small widths (D 512, hidden 256 x 2)
keep the reference's interpret-mode kernels quick.  Tolerance on the logits
(of order 0.05 here): atol 1e-5, rtol 1e-4, for fp32 matmuls and binds summed
in another order; equal predictions; the loss within 1e-5 relative and
the accuracies within 1e-6 (their means round apart).

The port binds with ``impl="pallas"`` (the circconv plain versions on the
CPU).  With S >= 2 the reference's own pallas path raises (its
``block_circconv`` broadcasts only one operand, ROADMAP Queue C), so S = 2
is held against the reference's ``fft`` and ``direct`` binds, and S = 1
(rows and the one-row HRR corner) against its ``pallas`` bind.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import vsa as rv
from repro.data import raven as rraven
from repro.models import mimonet as rm
from repro_torch import convert
from repro_torch.core import vsa as tv
from repro_torch.data import raven as traven
from repro_torch.kernels.circconv import ops as cc_ops
from repro_torch.kernels.circconv import ref as cc_ref
from repro_torch.models import mimonet as tm

ATOL, RTOL = 1e-5, 1e-4


def _cfgs(dim, blocks, streams, ref_impl):
    rc = rm.MIMONetConfig(vsa=rv.VSAConfig(dim, blocks, impl=ref_impl),
                          num_streams=streams, hidden=(256, 256))
    tc = tm.MIMONetConfig(vsa=tv.VSAConfig(dim, blocks, impl="pallas"),
                          num_streams=streams, hidden=(256, 256))
    return rc, tc


def _batch(items, streams, seed):
    b = rraven.attribute_classification_batch(np.random.default_rng(seed),
                                              items * streams)
    out = {"images": b["images"].reshape(items, streams, 32, 32)}
    for name in tm.ATTRS:
        out[name] = b[name].reshape(items, streams)
    return out


def _check(rc, tc, items, seed):
    params = rm.init(jax.random.PRNGKey(seed), rc)
    model = convert.mimonet_params_from_reference(
        jax.tree.map(np.asarray, params), device="cpu")
    batch = _batch(items, rc.num_streams, seed + 100)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = rm.apply(params, jnp.asarray(batch["images"]), rc)
    got = tm.apply(model, tbatch["images"], tc)
    for a, n in enumerate(rc.attr_sizes):
        assert got[a].shape == (items, rc.num_streams, n)
        np.testing.assert_allclose(got[a].numpy(), np.asarray(want[a]),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_array_equal(got[a].argmax(-1).numpy(),
                                      np.asarray(want[a]).argmax(-1))
    loss, accs = tm.loss_fn(model, tbatch, tc)
    rloss, raccs = rm.loss_fn(params, {k: jnp.asarray(v)
                                       for k, v in batch.items()}, rc)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    assert accs.keys() == raccs.keys()
    for name in accs:  # the same predictions; the means round apart
        np.testing.assert_allclose(float(accs[name]), float(raccs[name]),
                                   atol=1e-6, err_msg=name)
    return got


@pytest.mark.parametrize("ref_impl", ["fft", "direct"])
def test_two_streams_match_the_reference(ref_impl):
    rc, tc = _cfgs(512, 8, 2, ref_impl)
    before = (cc_ops.rows_launches, cc_ops.single_launches)
    _check(rc, tc, items=6, seed=0)
    assert (cc_ops.rows_launches, cc_ops.single_launches) == before


def test_one_stream_matches_the_reference_pallas_path():
    rc, tc = _cfgs(512, 8, 1, "pallas")
    _check(rc, tc, items=5, seed=1)


def test_hrr_one_item_matches_the_reference_pallas_path(monkeypatch):
    """B = 1, one item, S = 1: each bind is one row of L = 512, the
    single-row scheme in both packages."""
    rc, tc = _cfgs(512, 1, 1, "pallas")
    routes = []
    single = cc_ref.circconv_single_ref
    monkeypatch.setattr(cc_ref, "circconv_single_ref",
                        lambda x, y: routes.append(x.shape) or single(x, y))
    _check(rc, tc, items=1, seed=2)
    assert routes == [(512,)] * 4  # apply's bind and unbind, twice


def test_streams_are_separated():
    """The reference's ``test_mimonet_superposition_shapes_and_unbinding``:
    per-stream outputs differ (unbinding separates the streams)."""
    cfg = tm.MIMONetConfig(vsa=tv.VSAConfig(512, 8, impl="pallas"),
                           num_streams=2, hidden=(256, 256))
    model = tm.init(cfg, 0, device="cpu")
    imgs = torch.rand((4, 2, 32, 32), generator=torch.Generator().manual_seed(1))
    logits = tm.apply(model, imgs, cfg)
    assert [tuple(l.shape) for l in logits] == [(4, 2, 5), (4, 2, 6), (4, 2, 10)]
    assert not np.allclose(logits[0][:, 0].numpy(), logits[0][:, 1].numpy())


def test_init_has_the_reference_names_shapes_and_scales():
    rc = rm.MIMONetConfig(vsa=rv.VSAConfig(512, 8), num_streams=3,
                          hidden=(256, 128))
    tc = tm.MIMONetConfig(vsa=tv.VSAConfig(512, 8), num_streams=3,
                          hidden=(256, 128))
    want = rm.init(jax.random.PRNGKey(0), rc)
    got = dict(tm.init(tc, 0, device="cpu").named_parameters())
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    for name, w in got.items():
        assert w.dtype == torch.float32 and not w.requires_grad
        ref_std = float(np.std(np.asarray(want[name])))
        np.testing.assert_allclose(float(w.std()), ref_std, rtol=0.1,
                                   atol=1e-6, err_msg=name)
    spec = torch.fft.rfft(tc.vsa.blockify(got["stream_keys"]), dim=-1)
    np.testing.assert_allclose(spec.abs().numpy(),
                               np.full(spec.shape, 8 ** -0.5), rtol=1e-4)


def test_full_width_default_config_matches_the_reference_defaults():
    r, t = rm.MIMONetConfig(), tm.MIMONetConfig()
    assert (t.vsa.dim, t.vsa.blocks, t.vsa.impl, t.num_streams, t.img,
            t.hidden, t.attr_sizes) == (r.vsa.dim, r.vsa.blocks, r.vsa.impl,
                                        r.num_streams, r.img, r.hidden,
                                        r.attr_sizes)


@pytest.mark.parametrize("seed,size", [(0, 16), (7, 64)])
def test_attribute_classification_batch_is_bit_equal(seed, size):
    got = traven.attribute_classification_batch(np.random.default_rng(seed),
                                                size)
    want = rraven.attribute_classification_batch(np.random.default_rng(seed),
                                                 size)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_render_panel_is_bit_equal_for_every_attribute_value():
    assert (traven.NUM_TYPES, traven.NUM_SIZES, traven.NUM_COLORS,
            traven.IMG_SIZE) == (rraven.NUM_TYPES, rraven.NUM_SIZES,
                                 rraven.NUM_COLORS, rraven.IMG_SIZE)
    for t in range(traven.NUM_TYPES):
        for s in range(traven.NUM_SIZES):
            c = (t + 3 * s) % traven.NUM_COLORS
            np.testing.assert_array_equal(traven.render_panel(t, s, c),
                                          rraven.render_panel(t, s, c))
    np.testing.assert_array_equal(traven.render_panel(1, 2, 3, img=17),
                                  rraven.render_panel(1, 2, 3, img=17))
