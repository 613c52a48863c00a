"""Training the paper's workloads in the port against the reference.

* NVSA's ``frontend_loss`` on the reference's ``cnn.init`` weights (carried
  across by ``convert.cnn_params_from_reference``) and codebooks, a batch of
  16 panels: the loss and metrics at rtol 1e-5, every gradient at rtol 1e-4
  and atol 1e-6 against ``jax.value_and_grad(nvsa.frontend_loss,
  has_aux=True)`` after ``convert.cnn_params_to_reference``.  Then 30 steps
  of the reference example's step (AdamW over ``cosine_schedule(3e-3, 100,
  4000)``, global-norm clip 1.0) on the same batches: each step's loss
  within 1e-3 relative (fp32 convolutions summed in another order, carried
  through 30 updates).
* MIMONet at a small config (D = 256, 4 blocks, hidden 256 x 2, S = 2,
  ``impl="fft"`` as the reference's example trains): the same two checks,
  the stream keys' gradient included.
* The autograd guard: every entry point of the four kernels' ``ops.py``
  raises under autograd with an operand that requires grad, on the CPU as
  the reference's ``pallas_call`` refuses in interpret mode, and does not
  under ``torch.no_grad()``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import vsa as rv
from repro.data import raven as rr
from repro.models import cnn as rc
from repro.models import mimonet as rm
from repro.models import nvsa as rn
from repro.train import optimizer as ro
from repro_torch import convert
from repro_torch.core import vsa as tv
from repro_torch.core.quantization import quantize
from repro_torch.device import disable_tf32
from repro_torch.kernels.circconv import ops as cc
from repro_torch.kernels.flash_decode import ops as fd
from repro_torch.kernels.resonator_step import ops as rs
from repro_torch.kernels.similarity import ops as sim
from repro_torch.models import mimonet as tm
from repro_torch.models import nvsa as tn
from repro_torch.train import optimizer as to

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
STEP_RTOL = 1e-3
STEPS = 30


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    disable_tf32()
    yield
    torch.set_num_threads(n)


def _batch(rng, n):
    return rr.attribute_classification_batch(rng, n)


def _assert_grads(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


# NVSA's frontend --------------------------------------------------------------

@pytest.fixture(scope="module")
def frontend():
    cfg_r, cfg_t = rn.NVSAConfig(), tn.NVSAConfig()
    k_cb, _ = jax.random.split(jax.random.PRNGKey(0))
    cbs_r, _ = rn.make_codebooks(k_cb, cfg_r)
    cbs_t, _ = convert.spec_arrays_from_reference(np.asarray(cbs_r),
                                                  device="cpu")
    params = rc.init(jax.random.split(jax.random.PRNGKey(0))[1], cfg_r.cnn)
    return cfg_r, cfg_t, cbs_r, cbs_t, params


def _model(params):
    return convert.cnn_params_from_reference(
        jax.tree.map(np.asarray, params), device="cpu").requires_grad_(True)


def test_frontend_loss_and_every_gradient_match_the_reference(frontend):
    cfg_r, cfg_t, cbs_r, cbs_t, params = frontend
    b = _batch(np.random.default_rng(0), 16)
    (loss_r, m_r), g_r = jax.jit(jax.value_and_grad(
        lambda p, b: rn.frontend_loss(p, b, cbs_r, cfg_r), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in b.items()})
    model = _model(params)
    loss, m = tn.frontend_loss(model, {k: torch.from_numpy(v)
                                       for k, v in b.items()}, cbs_t, cfg_t)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(loss_r), rel=LOSS_RTOL)
    assert set(m) == {"cosine", "aux_ce"}
    for k in m:
        assert float(m[k]) == pytest.approx(float(m_r[k]), rel=LOSS_RTOL)
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert all(g is not None for g in grads.values())
    _assert_grads(convert.cnn_params_to_reference(grads), g_r)


def test_cnn_params_round_trip_to_the_reference_layout(frontend):
    *_, params = frontend
    back = convert.cnn_params_to_reference(_model(params))
    for k, v in params.items():
        assert back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], np.asarray(v))


def test_thirty_frontend_steps_track_the_reference(frontend):
    cfg_r, cfg_t, cbs_r, cbs_t, params = frontend
    opt_r = ro.adamw(ro.cosine_schedule(3e-3, 100, 4000))

    @jax.jit
    def step_r(params, ostate, batch):
        (loss, _), g = jax.value_and_grad(rn.frontend_loss, has_aux=True)(
            params, batch, cbs_r, cfg_r)
        g, _ = ro.clip_by_global_norm(g, 1.0)
        params, ostate = opt_r.update(g, ostate, params)
        return params, ostate, loss

    model = _model(params)
    ps = list(model.parameters())
    opt_t = to.adamw(ps, to.cosine_schedule(3e-3, 100, 4000))
    ostate = opt_r.init(params)
    rng = np.random.default_rng(0)
    losses_r, losses_t = [], []
    for _ in range(STEPS):
        b = _batch(rng, 32)
        params, ostate, loss_r = step_r(
            params, ostate, {k: jnp.asarray(v) for k, v in b.items()})
        loss, _ = tn.frontend_loss(model, {k: torch.from_numpy(v)
                                           for k, v in b.items()},
                                   cbs_t, cfg_t)
        opt_t.zero_grad()
        loss.backward()
        to.clip_by_global_norm([p.grad for p in ps], 1.0)
        opt_t.step()
        losses_r.append(float(loss_r))
        losses_t.append(float(loss.detach()))
    np.testing.assert_allclose(losses_t, losses_r, rtol=STEP_RTOL)
    assert losses_t[-1] < losses_t[0]  # it trains


# MIMONet ----------------------------------------------------------------------

def _mimo_cfgs():
    kw = dict(num_streams=2, hidden=(256, 256))
    return (rm.MIMONetConfig(vsa=rv.VSAConfig(256, 4), **kw),
            tm.MIMONetConfig(vsa=tv.VSAConfig(256, 4), **kw))


def _streams(rng, B, S):
    b = _batch(rng, B * S)
    return {"images": b["images"].reshape(B, S, 32, 32),
            **{a: b[a].reshape(B, S) for a in tm.ATTRS}}


def test_mimonet_loss_and_every_gradient_match_the_reference():
    cfg_r, cfg_t = _mimo_cfgs()
    params = rm.init(jax.random.PRNGKey(3), cfg_r)
    b = _streams(np.random.default_rng(1), 16, 2)
    (loss_r, acc_r), g_r = jax.jit(jax.value_and_grad(
        lambda p, b: rm.loss_fn(p, b, cfg_r), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in b.items()})
    model = convert.mimonet_params_from_reference(
        jax.tree.map(np.asarray, params), device="cpu").requires_grad_(True)
    loss, acc = tm.loss_fn(model, {k: torch.from_numpy(v)
                                   for k, v in b.items()}, cfg_t)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(loss_r), rel=LOSS_RTOL)
    for k in acc_r:
        assert float(acc[k]) == pytest.approx(float(acc_r[k]), abs=1e-6)
    grads = convert.mimonet_params_to_reference(
        {k: p.grad for k, p in model.named_parameters()})
    assert np.abs(grads["stream_keys"]).max() > 0  # the keys are trained
    _assert_grads(grads, g_r)


def test_thirty_mimonet_steps_track_the_reference():
    cfg_r, cfg_t = _mimo_cfgs()
    params = rm.init(jax.random.PRNGKey(4), cfg_r)
    opt_r = ro.adamw(1e-3)

    @jax.jit
    def step_r(params, ostate, batch):
        (loss, _), g = jax.value_and_grad(rm.loss_fn, has_aux=True)(
            params, batch, cfg_r)
        g, _ = ro.clip_by_global_norm(g, 1.0)
        params, ostate = opt_r.update(g, ostate, params)
        return params, ostate, loss

    model = convert.mimonet_params_from_reference(
        jax.tree.map(np.asarray, params), device="cpu").requires_grad_(True)
    ps = list(model.parameters())
    opt_t = to.adamw(ps, 1e-3)
    ostate = opt_r.init(params)
    rng = np.random.default_rng(5)
    losses_r, losses_t = [], []
    for _ in range(STEPS):
        b = _streams(rng, 16, 2)
        params, ostate, loss_r = step_r(
            params, ostate, {k: jnp.asarray(v) for k, v in b.items()})
        loss, _ = tm.loss_fn(model, {k: torch.from_numpy(v)
                                     for k, v in b.items()}, cfg_t)
        opt_t.zero_grad()
        loss.backward()
        to.clip_by_global_norm([p.grad for p in ps], 1.0)
        opt_t.step()
        losses_r.append(float(loss_r))
        losses_t.append(float(loss.detach()))
    np.testing.assert_allclose(losses_t, losses_r, rtol=STEP_RTOL)
    assert losses_t[-1] < losses_t[0]


def test_the_models_are_built_frozen():
    cfg_r, cfg_t = _mimo_cfgs()
    assert not any(p.requires_grad for p in tm.init(
        cfg_t, 0, device="cpu").parameters())
    assert not any(p.requires_grad for p in tn.cnn.init(
        tn.NVSAConfig().cnn, 0, device="cpu").parameters())


# The autograd guard -----------------------------------------------------------

def _bipolar(gen, shape):
    return torch.where(torch.rand(shape, generator=gen) < 0.5, -1.0, 1.0)


def _calls():
    """(name, call(x) for an operand x, that operand) per entry point."""
    gen = torch.Generator().manual_seed(0)
    xb = torch.randn((3, 4, 64), generator=gen)
    yb = torch.randn((3, 4, 64), generator=gen)
    qs, est = _bipolar(gen, (4, 64)), _bipolar(gen, (4, 3, 64))
    books = _bipolar(gen, (3, 10, 64))
    mask = torch.ones((3, 10), dtype=torch.bool)
    w = quantize(torch.randn((10, 64), generator=gen), "int8")
    q = torch.randn((2, 1, 2, 16), generator=gen)
    pool = {"k": torch.randn((5, 4, 1, 16), generator=gen).bfloat16(),
            "v": torch.randn((5, 4, 1, 16), generator=gen).bfloat16()}
    table = torch.arange(4, dtype=torch.int32).reshape(2, 2)
    lens = torch.tensor([5, 8], dtype=torch.int32)
    vcfg = tv.VSAConfig(256, 4, impl="pallas")
    return [
        ("block_circconv", lambda x: cc.block_circconv(x, yb), xb),
        ("block_circconv", lambda x: cc.block_circcorr(xb, x), yb),
        ("block_circconv", lambda x: tv.bind(x, yb.reshape(3, 256), vcfg),
         xb.reshape(3, 256)),
        ("fused_resonator_step_batch",
         lambda x: rs.fused_resonator_step_batch(x, est, books), qs),
        ("fused_resonator_step_batch_masked",
         lambda x: rs.fused_resonator_step_batch_masked(qs, x, books, mask),
         est),
        ("fused_resonator_step_batch_local",
         lambda x: rs.fused_resonator_step_batch_local(qs, est, x), books),
        ("fused_resonator_step",
         lambda x: rs.fused_resonator_step(x, est[0], books), qs[0]),
        ("codebook_scores", lambda x: sim.codebook_scores(x, w),
         torch.randn((4, 64), generator=gen)),
        ("flash_decode", lambda x: fd.flash_decode(x, pool, table, lens), q),
    ]


@pytest.mark.parametrize("i", range(9))
def test_every_kernel_entry_point_refuses_autograd(i):
    name, call, x = _calls()[i]
    with pytest.raises(RuntimeError, match=f"{name}: the kernel has no "
                       "gradient.*impl='fft'"):
        call(x.clone().requires_grad_(True))
    with torch.no_grad():
        call(x.clone().requires_grad_(True))  # inference is untouched
    call(x)  # no operand requires grad: untouched under grad mode too


def test_the_reference_refuses_too_and_fft_trains():
    """jax.grad through the reference's pallas bind raises in interpret
    mode; the port's fft bind gives the reference's fft gradient (atol 1e-4:
    fp32 FFTs of 64-lane blocks err in proportion to the block's norm, and
    these gradients reach 15)."""
    cfg_r = rv.VSAConfig(256, 4)
    x = np.random.default_rng(6).standard_normal((2, 256)).astype(np.float32)
    y = np.random.default_rng(7).standard_normal((2, 256)).astype(np.float32)

    def f(x, impl):
        return jnp.sum(jnp.sin(rv.bind(x, jnp.asarray(y), cfg_r, impl=impl)))

    with pytest.raises(Exception, match="reverse-mode"):
        jax.grad(f)(jnp.asarray(x), "pallas")
    want = jax.grad(f)(jnp.asarray(x), "fft")
    xt = torch.from_numpy(x).requires_grad_(True)
    torch.sum(torch.sin(tv.bind(xt, torch.from_numpy(y), tv.VSAConfig(
        256, 4, impl="fft")))).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want),
                               rtol=GRAD_RTOL, atol=1e-4)
    with pytest.raises(RuntimeError, match="no gradient"):
        tv.bind(xt, torch.from_numpy(y), dataclasses.replace(
            tv.VSAConfig(256, 4), impl="pallas"))
