"""Mellum2-12B-A2.5B's parts of the port on the CPU: the dropless MoE, YaRN,
the sliding window in every attention path, and paged serving through
``LMEngine`` against the benchmark's plain reference
(``perfbench/reference/mellum.py``, which imports nothing of the port).

The reference package has no such architecture, so nothing here compares
with it; the dropping MoE's parity with it stays in
``test_torch_lm_moe_serving.py``."""
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.reference import mellum as ref  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels.flash_decode import ref as fd_ref  # noqa: E402
from repro_torch.nn import layers as L  # noqa: E402
from repro_torch.nn import moe as Moe  # noqa: E402
from repro_torch.nn import transformer as T  # noqa: E402

ARCH = "mellum2-12b-a2.5b"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The dropless MoE
# ---------------------------------------------------------------------------

def _moe(E=8, K=2, d=32, f=16, seed=0, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    cfg = Moe.MoEConfig(d_model=d, d_ff=f, num_experts=E, top_k=K)
    p = {"router": torch.randn(d, E, generator=gen) * d ** -0.5,
         "gate": torch.randn(E, d, f, generator=gen) * d ** -0.5,
         "up": torch.randn(E, d, f, generator=gen) * d ** -0.5,
         "down": torch.randn(E, f, d, generator=gen) * f ** -0.5}
    return cfg, {k: v.to(dtype) for k, v in p.items()}, gen


def _expert_order_sum(p, x, cfg):
    """Each token's output written out: its top-k experts, weights
    normalised, summed one expert at a time in ascending expert order in
    fp32."""
    out = torch.zeros(x.shape[0], x.shape[1], dtype=torch.float32)
    for n in range(x.shape[0]):
        xn = x[n:n + 1].float()
        probs = torch.softmax(xn @ p["router"].float(), -1)[0]
        top_p, top_e = Moe.top_k(probs, cfg.top_k)
        w = top_p / top_p.sum()
        for e in sorted(top_e.tolist()):
            k = top_e.tolist().index(e)
            xe = xn.to(x.dtype)
            h = torch.nn.functional.silu(xe @ p["gate"][e]) \
                * (xe @ p["up"][e])
            out[n] += w[k] * (h @ p["down"][e])[0].float()
    return out.to(x.dtype)


def test_dropless_moe_sums_each_tokens_experts_in_expert_order():
    cfg, p, gen = _moe()
    x = torch.randn(1, 40, 32, generator=gen)
    y, aux = Moe.moe_dropless(p, x, cfg)
    want = _expert_order_sum(p, x[0], cfg)
    torch.testing.assert_close(y[0], want, rtol=1e-5, atol=1e-6)
    assert aux["dropped_frac"] == 0
    assert int(aux["expert_counts"].sum()) == 40 * cfg.top_k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_tokens_output_is_the_same_alone_beside_others_and_padded(dtype):
    """Routing, the grouped products and the combine give a token the same
    output whatever else shares its call: alone, among 63 other rows, and
    in a chunk whose padded tail is left out of routing."""
    cfg, p, gen = _moe(dtype=dtype)
    x = torch.randn(1, 64, 32, generator=gen).to(dtype)
    together, _ = Moe.moe_dropless(p, x, cfg)
    valid = torch.arange(64)[None] < 20
    padded, aux = Moe.moe_dropless(p, x, cfg, valid)
    assert int(aux["expert_counts"].sum()) == 20 * cfg.top_k
    assert torch.equal(padded[0, 20:], torch.zeros_like(padded[0, 20:]))
    for n in (0, 7, 19):
        alone, _ = Moe.moe_dropless(p, x[:, n:n + 1], cfg)
        if dtype == torch.bfloat16:
            assert torch.equal(alone[0, 0], together[0, n])
            assert torch.equal(alone[0, 0], padded[0, n])
        else:  # the CPU's fp32 products block by the group's rows
            torch.testing.assert_close(alone[0, 0], together[0, n],
                                       rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(alone[0, 0], padded[0, n],
                                       rtol=1e-5, atol=1e-6)


def test_no_token_is_dropped_where_the_dropping_moe_drops():
    """Every token routed to one expert: the dropping path (capacity
    ``round(S K 1.25 / E)``) keeps a few of them, the dropless path all."""
    cfg, p, gen = _moe(E=8, K=2)
    p["router"] = torch.zeros_like(p["router"])
    p["router"][:, 3] = 10.0  # expert 3 first, then 0 (ties to the lower)
    x = torch.randn(1, 64, 32, generator=gen).abs()
    y, aux = Moe.moe_dropless(p, x, cfg)
    counts = aux["expert_counts"]
    assert counts[3] == 64 and counts[0] == 64
    torch.testing.assert_close(y[0], _expert_order_sum(p, x[0], cfg),
                               rtol=1e-5, atol=1e-6)
    yd, auxd = Moe.moe(p, x, cfg)
    assert float(auxd["dropped_frac"]) > 0.5
    assert not torch.allclose(yd, y)


def test_grouped_mm_is_each_groups_product():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(30, 16, generator=gen)
    w = torch.randn(4, 16, 8, generator=gen)
    offs = torch.tensor([5, 5, 21, 27], dtype=torch.int32)
    y = Moe.grouped_mm(x, w, offs)
    for e, (a, b) in enumerate([(0, 5), (5, 5), (5, 21), (21, 27)]):
        torch.testing.assert_close(y[a:b], x[a:b] @ w[e])


def test_moe_stats_record_experts_touched_and_the_largest_group():
    stats = Moe.MoEStats(4, "cpu")
    for counts in ([0, 3, 1, 0], [2, 2, 2, 2], [0, 0, 5, 0], [1, 0, 0, 0],
                   [0, 7, 0, 0]):
        stats.record(torch.tensor(counts))
    assert stats.calls == 5
    assert stats.rows(1, 5).tolist() == [[4, 2], [1, 5], [1, 1], [1, 7]]
    with pytest.raises(ValueError):
        stats.rows(0, 2)  # call 0 is no longer kept


# ---------------------------------------------------------------------------
# YaRN
# ---------------------------------------------------------------------------

def test_yarn_at_the_published_values():
    cfg = registry.get(ARCH).full()
    y = cfg.yarn
    assert y.correction_range(128, 5e5) == (18, 35)
    assert y.mscale == pytest.approx(1.2772588722239782)
    assert y.mscale == pytest.approx(0.1 * math.log(16) + 1, rel=1e-12)
    inv = 5e5 ** (-np.arange(0, 128, 2) / 128)
    r = np.clip((np.arange(64) - 18) / (35 - 18), 0, 1)
    want = inv * (1 - r) + inv / 16 * r
    got = L.rope_freqs(128, 5e5, yarn=y).double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(L.rope_freqs(128, 5e5).double().numpy(), inv,
                               rtol=1e-6)
    ref_inv, ref_m = ref.inv_freq(128, {
        "rope_type": "yarn", "rope_theta": 500000, "factor": 16,
        "original_max_position_embeddings": 8192, "beta_fast": 32,
        "beta_slow": 1, "attention_factor": 1.2772588722239782})
    np.testing.assert_allclose(ref_inv.numpy(), want, rtol=1e-12)
    assert ref_m == y.mscale


def test_yarn_scales_a_score_by_the_attention_factors_square():
    y = registry.get(ARCH).full().yarn
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(1, 5, 2, 128, generator=gen)
    pos = torch.arange(5)[None]
    a = L.apply_rope(q, pos, 5e5, y)
    b = L.apply_rope(q, pos, 5e5, dataclasses.replace(y, attention_factor=1.0))
    torch.testing.assert_close(a, b * y.mscale)
    # the full layers' RoPE turns slower than the sliding layers' past
    # the ramp's end
    assert L.rope_freqs(128, 5e5, yarn=y)[40] < L.rope_freqs(128, 5e5)[40]
    cfg = registry.get(ARCH).full()
    assert [cfg.attn_cfg(layer=i).window for i in range(8)] == \
        [1024, 1024, 1024, None] * 2
    assert cfg.attn_cfg(layer=3).yarn == y and cfg.attn_cfg(layer=2).yarn is None


# ---------------------------------------------------------------------------
# The sliding window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_windowed_flash_decode_is_a_masked_dense_softmax(kv_dtype):
    """``flash_decode_plain`` with a window of 13 (not a multiple of the
    block of 8) against one dense softmax over each row's last 13
    positions, rows shorter than, at and past the window."""
    gen = torch.Generator().manual_seed(7)
    B, G, rep, dh, bs, W, window = 6, 2, 3, 16, 8, 6, 13
    q = torch.randn(B, G, rep, dh, generator=gen)
    k = torch.randn(B * W + 1, bs, G, dh, generator=gen)
    v = torch.randn(B * W + 1, bs, G, dh, generator=gen)
    if kv_dtype == "int8":
        (kq, ks), (vq, vs) = L._quant_kv(k), L._quant_kv(v)
        pool = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        kf, vf = kq.float() * ks, vq.float() * vs
    else:
        pool = {"k": k.bfloat16(), "v": v.bfloat16()}
        kf, vf = pool["k"].float(), pool["v"].float()
    table = torch.randperm(B * W, generator=gen).reshape(B, W).int()
    lens = torch.tensor([0, 5, 12, 13, 14, 48], dtype=torch.int32)
    got = fd_ref.flash_decode_plain(q, pool["k"], pool["v"], table, lens,
                                    pool.get("k_scale"), pool.get("v_scale"),
                                    window)
    for b, n in enumerate(lens.tolist()):
        if n == 0:
            assert torch.equal(got[b], torch.zeros_like(got[b]))
            continue
        keys = kf[table[b].long()].reshape(W * bs, G, dh)[max(0, n - window):n]
        vals = vf[table[b].long()].reshape(W * bs, G, dh)[max(0, n - window):n]
        s = torch.einsum("grd,kgd->grk", q[b], keys)
        want = torch.einsum("grk,kgd->grd", torch.softmax(s, -1), vals)
        torch.testing.assert_close(got[b], want, rtol=1e-5, atol=1e-6)
    full = fd_ref.flash_decode_plain(q, pool["k"], pool["v"], table, lens,
                                     pool.get("k_scale"), pool.get("v_scale"))
    assert torch.equal(full[:4], got[:4])  # within the window: no change
    assert not torch.allclose(full[4:], got[4:])


def test_the_split_arithmetic_covers_the_window():
    from repro_torch.kernels.flash_decode import kernel as k

    for length, window, splits, span in ((0, 1024, 4, 32), (700, 1024, 4, 32),
                                         (4096, 1024, 4, 32),
                                         (3001, 1000, 8, 8), (17, 0, 2, 8)):
        parts = [k.split_range(length, splits, r, span, window)
                 for r in range(splits)]
        lo = max(0, length - window) if window else 0
        covered = [t for a, b in parts for t in range(a, b)]
        assert covered == list(range(lo, length))


def test_full_sequence_attention_masks_the_window():
    cfg = registry.get(ARCH).smoke()
    model = T.init(dataclasses.replace(cfg, activ_dtype=torch.float32), 0,
                   device="cpu")
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(1, 50, cfg.d_model, generator=gen)
    p = model.blocks[0]["attn"]
    acfg = cfg.attn_cfg(layer=0)
    assert acfg.window == cfg.sliding_window == 20
    out = L.attention(p, x, acfg, torch.arange(50)[None])
    # a query 20 or more positions on no longer sees position 0
    x2 = x.clone()
    x2[0, 0] += 1.0
    out2 = L.attention(p, x2, acfg, torch.arange(50)[None])
    assert torch.equal(out[0, 20:], out2[0, 20:])
    assert not torch.equal(out[0, 19], out2[0, 19])
    full = L.attention(p, x2, dataclasses.replace(acfg, window=None),
                       torch.arange(50)[None])
    assert not torch.equal(full[0, 20:], out2[0, 20:])


# ---------------------------------------------------------------------------
# The model against the plain reference
# ---------------------------------------------------------------------------

def _ref_config(cfg) -> dict:
    """The reference's configuration (the published keys) of a port
    config."""
    kinds = {"sliding": "sliding_attention", "full": "full_attention"}
    y = cfg.yarn
    return {
        "num_hidden_layers": cfg.n_layers, "hidden_size": cfg.d_model,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
        "vocab_size": cfg.vocab, "rms_norm_eps": 1e-6,
        "num_experts": cfg.moe.num_experts,
        "num_experts_per_tok": cfg.moe.top_k,
        "moe_intermediate_size": cfg.moe.d_ff,
        "sliding_window": cfg.sliding_window,
        "layer_types": [kinds[cfg.attn_kind(i)] for i in range(cfg.n_layers)],
        "rope_parameters": {
            "sliding_attention": {"rope_type": "default",
                                  "rope_theta": cfg.rope_theta},
            "full_attention": {
                "rope_type": "yarn", "rope_theta": cfg.rope_theta,
                "factor": y.factor,
                "original_max_position_embeddings":
                    y.original_max_position_embeddings,
                "beta_fast": y.beta_fast, "beta_slow": y.beta_slow,
                "attention_factor": y.attention_factor}}}


def _ref_weights(model) -> dict:
    return {"embed": model.embed, "head": model.lm_head,
            "final_norm": model.final_ln["scale"],
            "blocks": [{"norm1": b["ln1"]["scale"], "norm2": b["ln2"]["scale"],
                        **{f"{n}_w": b["attn"][n]["w"]
                           for n in ("q", "k", "v", "o")},
                        **{n: b["moe"][n]
                           for n in ("router", "gate", "up", "down")}}
                       for b in model.blocks]}


@pytest.fixture(scope="module")
def fp32_model():
    cfg = dataclasses.replace(registry.get(ARCH).smoke(),
                              activ_dtype=torch.float32)
    return cfg, T.init(cfg, 0, device="cpu")


def test_forward_is_the_reference_in_fp32(fp32_model):
    """The full-sequence forward (window, YaRN, dropless MoE) against the
    reference at 1e-5 of each row's largest |logit|: only the order of fp32
    sums and the port's fp32 RoPE angles differ."""
    cfg, model = fp32_model
    tokens = torch.randint(0, cfg.vocab, (60,),
                           generator=torch.Generator().manual_seed(4))
    got, _ = T.forward(model, cfg, tokens[None])
    with torch.no_grad():
        h = ref.hidden(_ref_weights(model), _ref_config(cfg), [tokens])[0]
        want = h @ model.lm_head.float()
    scale = want.abs().amax(-1, keepdim=True)
    assert ((got[0] - want).abs() / scale).max() < 1e-5
    for fault in ("window_off", "yarn_off", "skip_layer"):
        with torch.no_grad():
            bad = ref.hidden(_ref_weights(model), _ref_config(cfg), [tokens],
                             fault=fault)[0] @ model.lm_head.float()
        assert ((got[0] - bad).abs() / scale).max() > 0.05, fault


def test_paged_serving_is_the_reference(fp32_model):
    """Chunked prefill, then paged decode through ``LMEngine`` (block 8,
    window 20 not a multiple of it; prompts of 45 and 23 tokens, past the
    window), against the reference fed the prompt and the program's own
    tokens.  The pool is bf16 whatever the activations' type, so the
    reference rounds K and V to bf16 (``bf16_kv``); the port's fp32 RoPE
    angles and sums in another order then flip the bf16 rounding of a few K
    and V entries, which moves a logit by up to ~3e-4 of the row's largest
    |logit| at these widths (the full forward agrees to 1e-6, above): the
    bound is 1e-3, against ~5e-3 with K/V left in fp32 and 0.3 or more with
    the window or YaRN off."""
    from repro_torch.lm.paging import PagedConfig
    from repro_torch.runtime.lm import LMEngine

    cfg, model = fp32_model
    eng = LMEngine(cfg, model, slots=2, max_len=96, decode_per_step=1,
                   device="cpu", paged=PagedConfig(block_size=8,
                                                   prefill_chunk=16))
    seen = {}
    add = eng.serve.add_request

    def add_request(slot, prompt, sampling=None):
        seen[slot] = [add(slot, prompt, sampling=sampling)[0]]
        return seen[slot][0]

    eng.serve.add_request = add_request
    toks = torch.randint(0, cfg.vocab, (80,),
                         generator=torch.Generator().manual_seed(5)).numpy()
    prompts = [toks[:45], toks[50:73]]
    ids = [eng.submit(p, max_new_tokens=20) for p in prompts]
    done = {}
    while len(done) < 2:
        out = eng.step()
        for s in range(2):
            seen[s].append(eng.serve.last_logits[s].clone())
        done.update({r.id: r for r in out})
    w, c = _ref_weights(model), _ref_config(cfg)
    for slot, (rid, p) in enumerate(zip(ids, prompts)):
        new = done[rid].tokens
        got = torch.stack(seen[slot][:1 + len(new)])  # positions P-2 ..
        full = torch.as_tensor(np.concatenate([p, new]), dtype=torch.int64)
        want = {}
        for fmt, fault in (("bf16_kv", None), (None, None),
                           ("bf16_kv", "window_off"),
                           ("bf16_kv", "yarn_off")):
            with torch.no_grad():
                h = ref.hidden(w, c, [full], fmt, fault)[0]
            want[fmt, fault] = h[len(p) - 2:len(p) - 1 + len(new)] \
                @ model.lm_head.float()
        sound = want["bf16_kv", None]
        scale = sound.abs().amax(-1, keepdim=True)

        def err(x):
            return ((got - x).abs() / scale).max().item()

        assert err(sound) < 1e-3
        assert err(want[None, None]) > 3 * err(sound)
        assert err(want["bf16_kv", "window_off"]) > 0.1
        assert err(want["bf16_kv", "yarn_off"]) > 0.1
        assert got[1:].argmax(-1).tolist() == new


def test_kv_step_bytes_counts_a_sliding_layer_at_its_window():
    """``ServeEngine._kv_step_bytes``: starcoder2-3b's count as before (every
    layer's blocks up to each row's length); a sliding layer's only the
    blocks its window reaches."""
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.lm.paging import PagedConfig

    def engine(cfg, lens):
        model = T.init(cfg, 0, device="cpu")
        eng = ServeEngine(cfg, model, 3, 96, device="cpu",
                          paged=PagedConfig(block_size=8, prefill_chunk=16))
        eng.lens = np.asarray(lens, np.int64)
        return eng

    lens = [0, 30, 70]
    star = registry.get("starcoder2-3b").smoke()
    eng = engine(star, lens)
    per_tok = 2 * star.n_kv_heads * star.head_dim * 2
    old = sum(-(-(n + 1) // 8) * 8 for n in lens) * per_tok * star.n_layers
    assert eng._kv_step_bytes() == old
    mel = registry.get(ARCH).smoke()  # window 20, 3 sliding : 1 full
    eng = engine(mel, lens)
    per_tok = 2 * mel.n_kv_heads * mel.head_dim * 2
    full = sum(n // 8 + 1 for n in lens)
    # row 70: positions 51..70, blocks 6..8; row 30: 11..30, blocks 1..3
    sliding = 1 + 3 + 3
    assert eng._kv_step_bytes() == (3 * sliding + full) * 8 * per_tok


def test_a_smoke_training_step_has_a_finite_loss_and_gradients():
    """Under autograd the grouped products run one product a group: the
    loss and every gradient finite, the experts' too."""
    cfg = registry.get(ARCH).smoke()
    model = T.init(cfg, 0, device="cpu", trainable=True)
    tokens = torch.randint(0, cfg.vocab, (2, 48),
                           generator=torch.Generator().manual_seed(6))
    loss, parts = T.loss_fn(model, cfg, {"tokens": tokens})
    loss.backward()
    assert torch.isfinite(loss) and float(parts["load_balance"].detach()) > 0
    grads = [p.grad for p in model.parameters()]
    assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads)
    assert model.blocks[0]["moe"]["down"].grad.abs().sum() > 0


def test_paging_takes_the_attention_kinds_it_knows():
    from repro_torch.lm import model as lm_model

    cfg = registry.get(ARCH).smoke()
    assert lm_model.paging_unsupported_reason(cfg) is None
    assert "unknown attention kinds" in lm_model.paging_unsupported_reason(
        dataclasses.replace(cfg, attn_pattern=("local", "full")))
    assert "sliding_window" in lm_model.paging_unsupported_reason(
        dataclasses.replace(cfg, sliding_window=None))
