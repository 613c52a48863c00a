"""The port's LM training entry point (``repro_torch.launch.train``) against the
reference's (``repro.launch.train``).

  * 3 steps of ``build_train_step`` from the reference's fp32 ``init``
    weights (``activ_dtype`` fp32) on the reference's token batches,
    against its jitted step, for the four recipes of the ten specs: AdamW
    with a cosine schedule (llama3.2-3b), WSD with a tied head
    (minicpm-2b), Adafactor (jamba, whose spec also names bf16 state) and
    AdamW with bf16 moments (dbrx).  The loss, CE and grad norm at every
    step within 1e-4 relative; every leaf's parameters after 3 steps
    within 1e-3 of how far the leaf moved (L2 over the leaf) for AdamW,
    0.1 for Adafactor, whose first update is g / |g| elementwise, so an
    entry whose gradient cancels to the rounding level moves +-lr either
    way: a share f of such entries gives 2 sqrt(f), and 0.1 allows 0.25 %
    (readings: Adafactor 0.024 on jamba's embedding, AdamW 2e-4);
  * ``main --smoke --device cpu`` lowers ``ce``;
  * a run stopped at step 10 and resumed from its checkpoint to 20 equals
    the uninterrupted 20 steps bitwise (parameters, moments, data
    position);
  * the recipe per spec, the grads freed after a step, and the extras of
    the vision and audio stacks the same every step (the reference's
    ``main`` reuses ``PRNGKey(1)``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as RARCHS
from repro.data.tokens import TokenConfig as RTokenConfig
from repro.data.tokens import TokenDataset as RTokenDataset
from repro.launch import train as RTR
from repro.nn import transformer as RT
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.data.tokens import TokenConfig, TokenDataset
from repro_torch.launch import train as TR
from repro_torch.nn import transformer as T
from repro_torch.train import optimizer as optim
from repro_torch.train.checkpoint import flatten
from repro_torch.train.loop import LoopConfig, run

STEPS = 3
METRIC_RTOL = 1e-4
PARAM_RTOL = {"adamw": 1e-3, "adafactor": 0.1}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch_id", ["llama3.2-3b", "minicpm-2b",
                                     "jamba-1.5-large-398b", "dbrx-132b"])
def test_three_steps_match_the_references_jitted_step(arch_id):
    spec_r, spec = RARCHS[arch_id], registry.get(arch_id)
    cfg_r = dataclasses.replace(spec_r.smoke(), activ_dtype=jnp.float32)
    cfg = dataclasses.replace(spec.smoke(), activ_dtype=torch.float32)
    params, _ = RT.init(jax.random.PRNGKey(0), cfg_r)
    p0 = jax.tree.map(np.asarray, params)
    model = convert.lm_params_from_reference(p0, cfg, device="cpu",
                                             trainable=True)
    opt_r, step_r = RTR.build_train_step(cfg_r, spec_r, STEPS)
    state = (params, opt_r.init(params))
    ds = RTokenDataset(RTokenConfig(cfg_r.vocab, 32, 2))
    opt, step = TR.build_train_step(model, spec, STEPS)
    data = iter(TR.TokenBatches(cfg, TokenDataset(TokenConfig(cfg.vocab, 32,
                                                              2)), "cpu"))
    for i in range(STEPS):
        state, m_r = step_r(state, {k: jnp.asarray(v)
                                    for k, v in ds.next_batch().items()})
        _, m = step(None, next(data))
        for k in ("loss", "ce", "grad_norm"):
            assert abs(float(m[k]) - float(m_r[k])) <= \
                METRIC_RTOL * abs(float(m_r[k])), (i, k)
    kind = spec.optimizer
    moved = jax.tree_util.tree_flatten_with_path(state[0])[0]
    got = jax.tree.leaves(convert.lm_params_to_reference(model))
    for (path, want), g, start in zip(moved, got, jax.tree.leaves(p0)):
        want = np.asarray(want, np.float32)
        dist = np.linalg.norm(want - start)
        assert dist > 0, jax.tree_util.keystr(path)
        assert np.linalg.norm(g - want) <= PARAM_RTOL[kind] * dist, \
            jax.tree_util.keystr(path)


@pytest.mark.parametrize("arch_id", sorted(RARCHS))
def test_the_recipe_follows_the_spec(arch_id):
    spec = registry.get(arch_id)
    model = T.init(spec.smoke(), 0, "cpu", trainable=True)
    opt, _ = TR.build_train_step(model, spec, 40)
    first = opt.state_tree()[0]
    if spec.optimizer == "adafactor":
        assert isinstance(opt, optim.Adafactor)
        assert opt.param_groups[0]["lr"] == 1e-2
        return
    assert isinstance(opt, optim.AdamW)
    want = torch.bfloat16 if spec.opt_state_dtype == "bf16" else torch.float32
    assert first["m"].dtype == first["v"].dtype == want
    lr = opt.param_groups[0]["lr"]
    sched = (optim.wsd_schedule if spec.schedule == "wsd"
             else optim.cosine_schedule)(3e-4, 2, 40)
    assert [lr(s) for s in range(41)] == [sched(s) for s in range(41)]


def test_a_step_frees_the_grads_and_reports_the_references_metrics():
    spec = registry.get("granite-moe-3b-a800m")
    model = T.init(spec.smoke(), 0, "cpu", trainable=True)
    _, step = TR.build_train_step(model, spec, 5)
    batch = next(iter(TR.TokenBatches(model.cfg, TokenDataset(
        TokenConfig(model.cfg.vocab, 16, 2)), "cpu")))
    before = [p.detach().clone() for p in model.parameters()]
    _, m = step(None, batch)
    assert set(m) == {"ce", "load_balance", "router_z", "dropped_frac",
                      "loss", "grad_norm"}
    assert all(p.grad is None for p in model.parameters())
    assert all(not torch.equal(a, p) for a, p in zip(before,
                                                     model.parameters()))
    assert float(m["grad_norm"]) > 0 and not m["loss"].requires_grad


@pytest.mark.parametrize("arch_id", ["qwen2-vl-72b", "whisper-small"])
def test_extras_are_the_same_every_step(arch_id):
    cfg = registry.get(arch_id).smoke()
    it = iter(TR.TokenBatches(cfg, TokenDataset(TokenConfig(cfg.vocab, 16,
                                                            2)), "cpu"))
    a, b = next(it), next(it)
    assert not torch.equal(a["tokens"], b["tokens"])
    extra = "vision_embeds" if cfg.mrope_sections else "encoder_frames"
    assert a[extra].dtype == torch.bfloat16
    assert torch.equal(a[extra], b[extra])
    if cfg.mrope_sections:
        assert torch.equal(a["positions"][0, 2], torch.arange(16,
                                                              dtype=torch.int32))


def test_main_smoke_lowers_ce(capsys):
    history = TR.main(["--arch", "llama3.2-3b", "--smoke", "--device", "cpu"])
    assert [s for s, _ in history] == [0, 5, 10, 15, 20, 25]
    assert history[-1][1]["ce"] < history[0][1]["ce"]
    assert "(improved)" in capsys.readouterr().out


def _train(ckpt_dir, stop: int, total: int = 20):
    """A fresh smoke dbrx (bf16 moments) trained by the loop to ``stop`` of
    a ``total``-step schedule, checkpointing every 10 steps."""
    spec = registry.get("dbrx-132b")
    model = T.init(spec.smoke(), 0, "cpu", trainable=True)
    opt, step = TR.build_train_step(model, spec, total)
    state = {"params": list(model.parameters()), "opt": opt.state_tree()}
    data = TR.TokenBatches(model.cfg, TokenDataset(
        TokenConfig(model.cfg.vocab, 16, 2)), "cpu")
    run(step, state, data, LoopConfig(total_steps=stop, log_every=5,
                                      checkpoint_every=10,
                                      checkpoint_dir=ckpt_dir))
    return [t.clone() for t in flatten(state)], data.state()


def test_resume_at_step_10_equals_the_uninterrupted_run(tmp_path):
    whole, pos = _train(str(tmp_path / "whole"), 20)
    _train(str(tmp_path / "cut"), 10)
    resumed, pos2 = _train(str(tmp_path / "cut"), 20)
    assert pos == pos2 == {"step": 20}
    assert len(whole) == len(resumed)
    for a, b in zip(whole, resumed):
        assert a.dtype == b.dtype and torch.equal(a, b)
