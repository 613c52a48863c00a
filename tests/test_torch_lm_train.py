"""Gradients of the port's LM stack against the reference's, for all ten
architectures at smoke size.

The reference's ``T.init(PRNGKey(0))`` weights come across in the training
layout (``convert.lm_params_from_reference(..., trainable=True)``: every
leaf fp32 and trainable), the batch from numpy; the port's gradients go
back through ``convert.lm_params_to_reference(model, grads=True)`` and are
held leaf by leaf against ``jax.value_and_grad(T.loss_fn)``:

  * ``activ_dtype`` fp32: the loss and the aux terms within 1e-5
    relative; every leaf's gradient within 2e-5 of the leaf's largest |g|
    (sums in another order), where a leaf's largest |g| counts as at least
    1e-3 of the model's largest: the mLSTM input gate's bias has a
    gradient that cancels to ~1e-10 (the stabiliser tracks the gate), so
    only its absolute error is meaningful;
  * bf16: every gradient finite, the global norm positive and within 1 %
    of the reference's run op by op (``jax.disable_jit()``), and every
    leaf within 0.06 of its largest |g| under the same floor (rounding to
    bf16 in another order through the backward pass; the largest reading
    was 0.037, jamba);
  * remat on against off (``"full"`` and the matmul-saving policy), and the
    inner checkpoints (flash attention's KV blocks, Mamba's chunks, xLSTM's
    step chunks) against the same code without them: bitwise on the CPU.

Plus the layouts: the training layout round-trips through the reference's
tree bitwise, its serving copy equals the serving conversion of the same
fp32 parameters, and grad mode follows the caller while serving builds no
graph.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as RARCHS
from repro.nn import transformer as RT
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.nn import layers as L
from repro_torch.nn import mamba as Mb
from repro_torch.nn import transformer as T
from repro_torch.nn import xlstm as Xl

FP32_RTOL = 1e-5  # loss and aux terms
FP32_GRAD_RTOL = 2e-5  # of the leaf's largest |g|
BF16_GRAD_RTOL = 0.06
GRAD_FLOOR = 1e-3  # a leaf's scale is at least this share of the model's
BF16_GNORM_RTOL = 0.01


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch_id, fp32: bool):
    cfg_r, cfg_t = RARCHS[arch_id].smoke(), registry.get(arch_id).smoke()
    if fp32:
        cfg_r = dataclasses.replace(cfg_r, activ_dtype=jnp.float32)
        cfg_t = dataclasses.replace(cfg_t, activ_dtype=torch.float32)
    params, _ = RT.init(jax.random.PRNGKey(0), cfg_r)
    model = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, params), cfg_t, device="cpu",
        trainable=True)
    return cfg_r, params, cfg_t, model


def _batch(cfg, B=2, S=16, seed=1) -> dict:
    """tokens and a loss mask (+ M-RoPE positions and vision patches, +
    encoder frames), numpy."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "loss_mask": (rng.random((B, S)) < 0.8).astype(np.float32)}
    if cfg.mrope_sections is not None:
        b["positions"] = (np.arange(S)[None, None]
                          * np.array([1, 2, 3])[None, :, None]
                          ).repeat(B, 0).astype(np.int32)
        b["vision_embeds"] = rng.standard_normal(
            (B, cfg.vision_patches, cfg.d_model)).astype(np.float32)
    if cfg.encoder is not None:
        b["encoder_frames"] = rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.encoder.d_model)).astype(np.float32)
    return b


def _torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _ref_grads(cfg_r, params, b, op_by_op: bool):
    f = jax.value_and_grad(lambda p, bb: RT.loss_fn(p, cfg_r, bb),
                           has_aux=True)
    bj = {k: jnp.asarray(v) for k, v in b.items()}
    if op_by_op:
        with jax.disable_jit():
            return f(params, bj)
    return f(params, bj)


def _port_grads(cfg_t, model, b):
    loss, metrics = T.loss_fn(model, cfg_t, _torch_batch(b))
    loss.backward()
    return loss.detach(), metrics, convert.lm_params_to_reference(
        model, grads=True)


def _leaf_devs(ref_grads, port_grads) -> list:
    """(path, max |port - ref| over the leaf's scale) per leaf, the scale
    being its largest |g|, at least GRAD_FLOOR of the model's largest."""
    flat = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    port = jax.tree.leaves(port_grads)
    assert len(flat) == len(port)
    top = max(float(np.abs(np.asarray(g, np.float32)).max()) for _, g in flat)
    out = []
    for (path, g), p in zip(flat, port):
        g = np.asarray(g, np.float32)
        assert g.shape == p.shape, jax.tree_util.keystr(path)
        scale = max(float(np.abs(g).max()), GRAD_FLOOR * top)
        out.append((jax.tree_util.keystr(path),
                    float(np.abs(p - g).max()) / scale))
    return out


def _gnorm(tree) -> float:
    return float(np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2)
                             for g in jax.tree.leaves(tree))))


@pytest.mark.parametrize("arch_id", sorted(RARCHS))
def test_fp32_loss_and_every_gradient_match_jax(arch_id):
    cfg_r, params, cfg_t, model = _pair(arch_id, fp32=True)
    b = _batch(cfg_t)
    (loss_r, m_r), g_r = _ref_grads(cfg_r, params, b, op_by_op=False)
    loss, m, g_t = _port_grads(cfg_t, model, b)
    assert abs(float(loss) - float(loss_r)) <= FP32_RTOL * abs(float(loss_r))
    for k in ("ce", "load_balance", "router_z", "dropped_frac"):
        assert abs(float(m[k]) - float(m_r[k])) <= \
            FP32_RTOL * max(abs(float(m_r[k])), 1.0), k
    devs = _leaf_devs(g_r, g_t)
    worst = max(devs, key=lambda x: x[1])
    assert worst[1] <= FP32_GRAD_RTOL, worst
    assert all(np.isfinite(g).all() for g in jax.tree.leaves(g_t))


@pytest.mark.parametrize("arch_id", sorted(RARCHS))
def test_bf16_gradients_are_finite_and_track_the_op_by_op_reference(arch_id):
    cfg_r, params, cfg_t, model = _pair(arch_id, fp32=False)
    b = _batch(cfg_t)
    (loss_r, _), g_r = _ref_grads(cfg_r, params, b, op_by_op=True)
    loss, _, g_t = _port_grads(cfg_t, model, b)
    assert bool(torch.isfinite(loss))
    assert all(np.isfinite(g).all() for g in jax.tree.leaves(g_t)), arch_id
    gnorm, gnorm_r = _gnorm(g_t), _gnorm(g_r)
    assert gnorm > 0.0, f"{arch_id}: dead gradients"
    assert abs(gnorm - gnorm_r) <= BF16_GNORM_RTOL * gnorm_r, (gnorm, gnorm_r)
    worst = max(_leaf_devs(g_r, g_t), key=lambda x: x[1])
    assert worst[1] <= BF16_GRAD_RTOL, worst


def _grads_of(cfg, seed=3, S=32, dtype=torch.float32):
    """Loss and every gradient of a trainable model drawn by the port."""
    cfg = dataclasses.replace(cfg, activ_dtype=dtype)
    model = T.init(cfg, torch.Generator().manual_seed(seed), "cpu",
                   trainable=True)
    loss, _ = T.loss_fn(model, cfg, _torch_batch(_batch(cfg, S=S)))
    loss.backward()
    return loss.detach(), [p.grad for p in model.parameters()]


def _equal(a, b) -> bool:
    return torch.equal(a[0], b[0]) and all(
        torch.equal(x, y) for x, y in zip(a[1], b[1]))


@pytest.mark.parametrize("policy", ["full", "dots_with_no_batch_dims_saveable"])
@pytest.mark.parametrize("arch_id", sorted(RARCHS))
def test_remat_is_bitwise_no_remat(arch_id, policy, monkeypatch):
    """Each period runs under one checkpoint (counted), and the loss and
    every gradient equal the run without remat, at fp32 and bf16."""
    calls = []
    inner = T.ckpt.checkpoint

    def counting(fn, *args, **kw):
        calls.append("context_fn" in kw)
        return inner(fn, *args, **kw)

    monkeypatch.setattr(T.ckpt, "checkpoint", counting)
    base = registry.get(arch_id).smoke()
    assert base.remat is False and registry.get(arch_id).full().remat
    for dtype in (torch.float32, torch.bfloat16):
        off = _grads_of(base, dtype=dtype)
        calls.clear()
        on = _grads_of(dataclasses.replace(base, remat=True,
                                           remat_policy=policy), dtype=dtype)
        assert calls == [policy != "full"] * base.n_periods
        assert _equal(on, off), (arch_id, dtype)


def _passthrough(fn, *args, **kw):
    return fn(*args)


@pytest.mark.parametrize("arch_id", ["llama3.2-3b", "jamba-1.5-large-398b",
                                     "xlstm-125m", "whisper-small"])
def test_inner_checkpoints_are_bitwise_the_plain_loops(arch_id, monkeypatch):
    """Flash attention's KV blocks (block 8 over 32 keys), Mamba's chunks
    (8 of 32 tokens) and xLSTM's step chunks (8 of 32) run checkpointed
    under autograd, and give the plain loops' loss and gradients bitwise."""
    cfg = registry.get(arch_id).smoke()
    if cfg.mamba is not None:
        cfg = dataclasses.replace(cfg, mamba=dataclasses.replace(
            cfg.mamba, chunk=8))
    if cfg.xlstm is not None:
        cfg = dataclasses.replace(cfg, xlstm=dataclasses.replace(
            cfg.xlstm, chunk=8))
    monkeypatch.setattr(T.ModelConfig, "attn_cfg",
                        lambda self, causal=True, layer=0:
                        L.AttnConfig(self.d_model, self.n_heads,
                                     self.n_kv_heads, self.head_dim,
                                     self.qkv_bias, self.rope_theta,
                                     self.mrope_sections, causal=causal,
                                     flash_block=8))
    calls = []
    inner = L.checkpoint

    def counting(fn, *args, **kw):
        calls.append(fn.__name__)
        return inner(fn, *args, **kw)

    for mod in (L, Mb, Xl):
        monkeypatch.setattr(mod, "checkpoint", counting)
    with_ckpt = _grads_of(cfg, S=32)
    assert calls, arch_id
    for mod in (L, Mb, Xl):
        monkeypatch.setattr(mod, "checkpoint", _passthrough)
    assert _equal(with_ckpt, _grads_of(cfg, S=32)), arch_id
    calls.clear()
    for mod in (L, Mb, Xl):
        monkeypatch.setattr(mod, "checkpoint", counting)
    with torch.no_grad():  # no graph, no checkpoint
        T.loss_fn(
            T.init(cfg, 0, "cpu", trainable=True), cfg,
            _torch_batch(_batch(cfg, S=32)))
    assert calls == []


@pytest.mark.parametrize("arch_id", sorted(RARCHS))
def test_training_layout_round_trips_through_the_references_tree(arch_id):
    _, params, cfg_t, model = _pair(arch_id, fp32=False)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in model.parameters())
    back = convert.lm_params_to_reference(model)
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = jax.tree.leaves(back)
    assert len(want) == len(got)
    for (path, a), b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b,
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch_id", sorted(RARCHS))
def test_serving_copy_equals_the_serving_conversion(arch_id):
    """The trained model's serving copy is the serving layout of the same
    fp32 parameters: ``stored_dtype`` leaves (bf16 matmul weights), equal
    to ``lm_params_from_reference`` bit for bit, frozen, in storage of its
    own."""
    _, params, cfg, model = _pair(arch_id, fp32=False)
    served = T.serving_copy(model)
    want = convert.lm_params_from_reference(jax.tree.map(np.asarray, params),
                                            cfg, device="cpu")
    got_named = dict(served.named_parameters())
    want_named = dict(want.named_parameters())
    assert got_named.keys() == want_named.keys()
    assert any(p.dtype == torch.bfloat16 for p in served.parameters())
    for name, w in want_named.items():
        g = got_named[name]
        assert g.dtype == w.dtype and not g.requires_grad, name
        assert torch.equal(g, w), name
    src = {p.data_ptr() for p in model.parameters()}
    assert not src & {p.data_ptr() for p in served.parameters()}


def test_grad_mode_follows_the_caller_and_serving_builds_no_graph():
    cfg = registry.get("granite-moe-3b-a800m").smoke()
    model = T.init(cfg, 0, "cpu", trainable=True)
    toks = torch.from_numpy(_batch(cfg)["tokens"])
    logits, aux = T.forward(model, cfg, toks)
    assert logits.requires_grad and aux["load_balance"].requires_grad
    assert aux["router_z"].requires_grad
    assert not aux["dropped_frac"].requires_grad  # no gradient, as in JAX
    with torch.no_grad():
        assert not T.forward(model, cfg, toks)[0].requires_grad
    served = T.serving_copy(model)
    assert not T.forward(served, cfg, toks)[0].requires_grad
    loss, _ = T.loss_fn(served, cfg, {"tokens": toks})
    assert loss.grad_fn is None
    cache = T.init_cache(cfg, 2, 4, device="cpu")
    step, _ = T.decode_step(model, cfg, cache, toks[:, :1])
    assert not step.requires_grad  # decode never builds a graph
