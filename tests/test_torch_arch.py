"""All ten reference architectures on the port, against the reference.

Per architecture (smoke configs, the reference's ``T.init(PRNGKey(0))``
weights carried across by ``convert.lm_params_from_reference``, inputs
from numpy):

  * the reference's six arch checks (``tests/test_arch_smoke.py``) on the
    port's registry and model;
  * ``count_params_cfg`` of every full config equal to the reference's, as
    integers (shapes only, on the ``meta`` device);
  * ``forward`` logits and ``loss_fn`` (CE and the MoE aux terms): at fp32
    within 1e-5 of each row's largest |logit| (sums in another order); in
    bf16 within 8 bf16 ulps of each row's largest |logit| of the reference
    run op by op (``jax.disable_jit()``);
  * 4 ``decode_step``s from a fresh cache under the same contract, the
    caches advanced as the reference's.
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
from repro_torch.configs.registry import ARCHS
from repro_torch.nn import transformer as T

DEV_ULPS = 8  # bf16: a row's largest |logit| sets the ulp
FP32_RTOL = 1e-5


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
    model = convert.lm_params_from_reference(jax.tree.map(np.asarray, params),
                                             cfg_t, device="cpu")
    return cfg_r, params, cfg_t, model


def _batch(cfg, B=2, S=16, seed=1):
    """tokens (+ M-RoPE positions and vision patches, + encoder frames)."""
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


def _row_dev(got, want, fp32: bool):
    """Per row: max |got - want| over the vocabulary in units of the row's
    largest |logit| (fp32) or of one bf16 ulp of it."""
    got = np.asarray(got, np.float32).reshape(-1, want.shape[-1])
    want = np.asarray(want, np.float32).reshape(-1, want.shape[-1])
    top = np.abs(want).max(-1)
    unit = top if fp32 else 2.0 ** (np.floor(np.log2(top)) - 7)
    return np.abs(got - want).max(-1) / unit


def _agree(got, want, fp32: bool):
    dev = _row_dev(got, want, fp32)
    limit = FP32_RTOL if fp32 else DEV_ULPS
    assert dev.max() <= limit, (dev.max(), limit)


# ---------------------------------------------------------------------------
# The reference's arch checks, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id", sorted(RARCHS))
def test_smoke_loss_is_finite_and_mirrors_the_references_leaves(arch_id):
    """The reference's smoke train step, less the gradient (the port
    evaluates the loss; LM training is a later slice): the port's model has
    the reference's leaves, one for one, and a finite loss."""
    cfg = registry.get(arch_id).smoke()
    model = T.init(cfg, 0, "cpu")
    params, logical = RT.init(jax.random.PRNGKey(0), RARCHS[arch_id].smoke())
    n_ref = sum(int(np.prod(np.shape(x))) for x in jax.tree.leaves(params))
    assert T.param_count(model) == n_ref
    assert len(list(model.parameters())) == sum(
        (leaf.shape[0] if np.ndim(leaf) and path_has_blocks else 1)
        for path_has_blocks, leaf in _leaf_layers(params))
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg, S=32).items()}
    loss, metrics = T.loss_fn(model, cfg, b)
    assert bool(torch.isfinite(loss)), arch_id
    assert float(metrics["ce"]) > 0


def _leaf_layers(params):
    """(stacked over layers?, leaf) of the reference's tree: ``blocks`` and
    ``enc_blocks`` leaves hold one layer per leading index."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        yield getattr(path[0], "key", None) in ("blocks", "enc_blocks"), leaf


@pytest.mark.parametrize("arch_id", sorted(RARCHS))
def test_smoke_decode_step(arch_id):
    cfg = registry.get(arch_id).smoke()
    model = T.init(cfg, 0, "cpu")
    B = 2
    cache = T.init_cache(cfg, B, 16, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, 1)))
    pos = (torch.zeros((B, 3, 1), dtype=torch.int32)
           if cfg.mrope_sections is not None else None)
    enc = None
    if cfg.encoder is not None:
        enc = torch.randn((B, cfg.encoder.n_frames, cfg.encoder.d_model),
                          generator=torch.Generator().manual_seed(3)
                          ).to(torch.bfloat16)
    logits, cache2 = T.decode_step(model, cfg, cache, tok, positions=pos,
                                   enc_out=enc)
    assert logits.shape == (B, 1, cfg.vocab)
    assert bool(torch.isfinite(logits).all()), arch_id
    for bi, kind in enumerate(cfg.block_pattern):  # attention caches advanced
        if kind.startswith("attn"):
            assert int(cache2[bi]["self"]["len"][0, 0]) == 1
            break


@pytest.mark.parametrize("arch_id", sorted(RARCHS))
def test_full_config_matches_assignment(arch_id):
    expect = {
        "qwen2-vl-72b": (80, 8192, 64, 8, 29568, 152064),
        "granite-moe-3b-a800m": (32, 1536, 24, 8, 512, 49155),
        "dbrx-132b": (40, 6144, 48, 8, 10752, 100352),
        "llama3.2-3b": (28, 3072, 24, 8, 8192, 128256),
        "minicpm-2b": (40, 2304, 36, 36, 5760, 122753),
        "qwen2.5-32b": (64, 5120, 40, 8, 27648, 152064),
        "starcoder2-3b": (30, 3072, 24, 2, 12288, 49152),
        "xlstm-125m": (12, 768, 4, 4, 0, 50304),
        "whisper-small": (12, 768, 12, 12, 3072, 51865),
        "jamba-1.5-large-398b": (72, 8192, 64, 8, 24576, 65536),
    }[arch_id]
    cfg = ARCHS[arch_id].full()
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
           cfg.vocab)
    assert got == expect, (arch_id, got, expect)
    # every field of both configs equal to the reference's, smoke too
    for fn in ("full", "smoke"):
        a = getattr(RARCHS[arch_id], fn)()
        b = getattr(ARCHS[arch_id], fn)()
        for f in dataclasses.fields(a):
            if f.name in ("param_dtype", "activ_dtype"):
                continue
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if dataclasses.is_dataclass(va):
                va, vb = dataclasses.asdict(va), dataclasses.asdict(vb)
            assert va == vb, (arch_id, fn, f.name)
    spec_r, spec_t = RARCHS[arch_id], ARCHS[arch_id]
    for f in ("family", "sub_quadratic", "optimizer", "schedule",
              "opt_state_dtype", "grad_accum"):
        assert getattr(spec_r, f) == getattr(spec_t, f), (arch_id, f)
    assert spec_t.shapes() == spec_r.shapes()


def test_moe_configs():
    assert ARCHS["granite-moe-3b-a800m"].full().moe.num_experts == 40
    assert ARCHS["granite-moe-3b-a800m"].full().moe.top_k == 8
    assert ARCHS["dbrx-132b"].full().moe.top_k == 4
    assert ARCHS["jamba-1.5-large-398b"].full().moe.top_k == 2


def test_jamba_interleave_ratio():
    pattern = ARCHS["jamba-1.5-large-398b"].full().block_pattern
    attn = sum(1 for k in pattern if k.startswith("attn"))
    mamba = sum(1 for k in pattern if k.startswith("mamba"))
    assert (attn, mamba) == (1, 7)  # 1:7 per assignment
    assert sum(1 for k in pattern if k.endswith("moe")) == len(pattern) // 2


@pytest.mark.parametrize("arch_id", sorted(RARCHS))
def test_param_counts_equal_the_references(arch_id):
    """``count_params_cfg`` from shapes alone (the meta device), equal to the
    reference's as integers, in the reference test's ballpark."""
    approx = {"llama3.2-3b": (2.5e9, 4.5e9), "minicpm-2b": (2e9, 3.5e9),
              "starcoder2-3b": (2.5e9, 4e9), "xlstm-125m": (0.08e9, 0.3e9),
              "whisper-small": (0.2e9, 0.4e9), "qwen2.5-32b": (28e9, 36e9),
              "dbrx-132b": (110e9, 145e9), "qwen2-vl-72b": (65e9, 80e9),
              "jamba-1.5-large-398b": (330e9, 430e9),
              "granite-moe-3b-a800m": (2.5e9, 4e9)}[arch_id]
    n, n_active = T.count_params_cfg(ARCHS[arch_id].full())
    assert (n, n_active) == RT.count_params_cfg(RARCHS[arch_id].full())
    assert approx[0] < n < approx[1] and n_active <= n
    if arch_id == "granite-moe-3b-a800m":
        assert (n, n_active) == (3_374_295_552, 958_376_448)
    if arch_id == "jamba-1.5-large-398b":
        assert n == 398_555_111_424
    abstract = T.abstract_init(ARCHS[arch_id].full())
    assert all(p.device.type == "meta" for p in abstract.parameters())


# ---------------------------------------------------------------------------
# Forward, loss and decode against the reference
# ---------------------------------------------------------------------------

def _forward_both(arch_id, fp32: bool):
    cfg_r, params, cfg_t, model = _pair(arch_id, fp32)
    b = _batch(cfg_r)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    run = (lambda f: f()) if fp32 else (lambda f: _op_by_op(f))
    want, aux_r = run(lambda: RT.forward(
        params, cfg_r, jb["tokens"], positions=jb.get("positions"),
        vision_embeds=jb.get("vision_embeds"),
        encoder_frames=jb.get("encoder_frames")))
    loss_r, m_r = run(lambda: RT.loss_fn(params, cfg_r, jb))
    got, aux = T.forward(model, cfg_t, tb["tokens"],
                         positions=tb.get("positions"),
                         vision_embeds=tb.get("vision_embeds"),
                         encoder_frames=tb.get("encoder_frames"))
    loss, m = T.loss_fn(model, cfg_t, tb)
    return (cfg_r, params, cfg_t, model, b), (want, got), (loss_r, loss), \
        (m_r, m)


def _op_by_op(f):
    with jax.disable_jit():
        return f()


@pytest.mark.parametrize("arch_id", sorted(RARCHS))
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_forward_and_loss_match_the_reference(arch_id, dtype):
    fp32 = dtype == "fp32"
    _, (want, got), (loss_r, loss), (m_r, m) = _forward_both(arch_id, fp32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _agree(got.numpy(), np.asarray(want), fp32)
    rtol = 1e-5 if fp32 else 1e-2  # bf16: the logits' few-ulp moves
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=rtol)
    for k in ("ce", "load_balance", "router_z", "dropped_frac"):
        np.testing.assert_allclose(float(m[k]), float(m_r[k]), rtol=rtol,
                                   atol=1e-7)


@pytest.mark.parametrize("arch_id", sorted(RARCHS))
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_decode_steps_match_the_reference(arch_id, dtype):
    fp32 = dtype == "fp32"
    cfg_r, params, cfg_t, model = _pair(arch_id, fp32)
    B, rng = 3, np.random.default_rng(5)
    cache_r = RT.init_cache(cfg_r, B, 16)
    cache = T.init_cache(cfg_t, B, 16, device="cpu")
    enc = None
    if cfg_r.encoder is not None:
        enc = rng.standard_normal((B, cfg_r.encoder.n_frames,
                                   cfg_r.encoder.d_model)).astype(np.float32)
    run = (lambda f: f()) if fp32 else _op_by_op
    for step in range(4):
        tok = rng.integers(0, cfg_r.vocab, (B, 1)).astype(np.int32)
        pos = (np.full((B, 3, 1), step, np.int32)
               if cfg_r.mrope_sections is not None else None)
        want, cache_r = run(lambda: RT.decode_step(
            params, cfg_r, cache_r, jnp.asarray(tok),
            positions=None if pos is None else jnp.asarray(pos),
            enc_out=None if enc is None
            else jnp.asarray(enc).astype(cfg_r.activ_dtype)))
        got, cache = T.decode_step(
            model, cfg_t, cache, torch.from_numpy(tok),
            positions=None if pos is None else torch.from_numpy(pos),
            enc_out=None if enc is None
            else torch.from_numpy(enc).to(cfg_t.activ_dtype))
        _agree(got.numpy(), np.asarray(want), fp32)
    for per_r, per in zip(cache_r, cache):  # lengths advanced alike
        if "self" in per:
            np.testing.assert_array_equal(per["self"]["len"].numpy(),
                                          np.asarray(per_r["self"]["len"]))
