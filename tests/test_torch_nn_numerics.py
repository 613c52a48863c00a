"""The port's NN substrate (``repro_torch.nn``: attention, M-RoPE, Mamba,
xLSTM, MoE) against naive references and against the reference package.

The first group ports every check of ``tests/test_nn_numerics.py`` to the
port's functions, at the reference's shapes and tolerances.  The second
holds each function against its reference counterpart on the same inputs
(numpy-seeded) and the same parameters (the reference's ``init_*`` drawn
from a ``jax.random`` key, carried across as numpy):

  * ``flash_attention``: fp32, rtol 1e-5 (sums in another order);
  * ``moe``: at fp32, ``top_e``, ``slot`` and ``keep`` equal and outputs
    and aux within rtol 1e-5; in bf16, equal to the reference run op by op
    (``jax.disable_jit()``), on a batch that drops tokens, at decode (rows
    folded into one routing group) and with tied router probabilities;
  * ``mamba`` chunked and decode: fp32, rtol 1e-5 / atol 1e-5 (the chunk's
    associative scan multiplies in the reference's order; the state's
    read-out sums over N in another);
  * ``mlstm`` / ``slstm``: fp32, rtol 1e-6 / atol 1e-6;
  * ``apply_mrope``: fp32, rtol 1e-6 / atol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import layers as RL
from repro.nn import mamba as RMb
from repro.nn import moe as RMoe
from repro.nn import xlstm as RXl
from repro_torch.nn import layers as L
from repro_torch.nn import mamba as Mb
from repro_torch.nn import moe as Moe
from repro_torch.nn import xlstm as Xl


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _normal(seed, shape, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _params(tree, dtype=torch.float32, keep_fp32=("A_log",)):
    """A reference parameter dict (jax leaves) as torch tensors."""
    return {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.float32 if k in keep_fp32 else dtype) for k, v in tree.items()}


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _cfg(obj, **kw):
    """The port's twin of a reference config dataclass."""
    mod = {RMoe.MoEConfig: Moe.MoEConfig, RMb.MambaConfig: Mb.MambaConfig,
           RXl.XLSTMConfig: Xl.XLSTMConfig}[type(obj)]
    return mod(**{**dataclasses.asdict(obj), **kw})


# ---------------------------------------------------------------------------
# The reference test's checks, on the port
# ---------------------------------------------------------------------------

def naive_attention(q, k, v, causal):
    B, Sq, H, dh = q.shape
    rep = H // k.shape[2]
    kf = torch.repeat_interleave(k, rep, 2)
    vf = torch.repeat_interleave(v, rep, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q * dh ** -0.5, kf)
    if causal:
        mask = torch.tril(torch.ones((Sq, k.shape[1]), dtype=torch.bool))
        s = torch.where(mask[None, None], s, torch.tensor(-1e30))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vf)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,G,S,block", [(4, 4, 64, 16), (8, 2, 96, 32),
                                         (6, 3, 50, 64)])
def test_flash_matches_naive(causal, H, G, S, block):
    dh = 16
    q = _t(_normal(H * S, (2, S, H, dh)))
    k = _t(_normal(H * S + 1, (2, S, G, dh)))
    v = _t(_normal(H * S + 2, (2, S, G, dh)))
    out = L.flash_attention(q, k, v, causal=causal, block=block)
    torch.testing.assert_close(out, naive_attention(q, k, v, causal),
                               atol=2e-5, rtol=1e-4)


def test_decode_matches_prefill():
    """Per-token decode over a cache reproduces the full forward."""
    cfg = L.AttnConfig(d_model=64, n_heads=4, n_kv_heads=2)
    p_r, _ = RL.init_attention(jax.random.PRNGKey(0), RL.AttnConfig(64, 4, 2))
    p = {k: _params(v) for k, v in p_r.items()}
    S, B = 12, 2
    x = _t(_normal(1, (B, S, 64)))
    pos = torch.arange(S)[None].expand(B, S)
    full = L.attention(p, x, cfg, pos)
    cache = L.init_kv_cache(B, S, cfg, dtype=torch.float32)
    outs = [L.attention_decode(p, x[:, t:t + 1], cache, cfg,
                               pos[:, t:t + 1])[0] for t in range(S)]
    torch.testing.assert_close(torch.cat(outs, 1), full, atol=2e-4,
                               rtol=1e-3)


def test_mrope_sections_rotate_independently():
    x = _t(_normal(0, (1, 8, 2, 16)))
    pos3 = torch.stack([torch.arange(8) * m for m in (1, 2, 3)])[None]
    out = L.apply_mrope(x, pos3, sections=(3, 3, 2))
    out0 = L.apply_mrope(x, torch.zeros_like(pos3), sections=(3, 3, 2))
    torch.testing.assert_close(out0, x, atol=1e-6, rtol=0)  # zero: identity
    assert not torch.allclose(out, x)


def _mamba_setup(chunk, d=16, state=4):
    cfg_r = RMb.MambaConfig(d_model=d, expand=2, d_state=state, chunk=chunk)
    p_r, _ = RMb.init_mamba(jax.random.PRNGKey(0), cfg_r)
    return cfg_r, p_r, _cfg(cfg_r), _params(p_r)


def test_mamba_chunked_matches_naive_recurrence():
    _, _, cfg, p = _mamba_setup(chunk=8)
    B, S = 2, 37  # deliberately not a chunk multiple
    x = _t(_normal(1, (B, S, 16)))
    y, _ = Mb.mamba(p, x, cfg)
    xin, z = torch.chunk(x @ p["in_proj"], 2, -1)
    xc = torch.cat([torch.zeros((B, cfg.d_conv - 1, cfg.d_inner)), xin], 1)
    conv = sum(xc[:, i:i + S] * p["conv_w"][i]
               for i in range(cfg.d_conv)) + p["conv_b"]
    u = torch.nn.functional.silu(conv)
    dA, dBx, Cm = Mb._ssm_inputs(p, u, cfg)
    h = torch.zeros((B, cfg.d_inner, cfg.d_state))
    ys = []
    for t in range(S):
        h = dA[:, t] * h + dBx[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    y_ref = (torch.stack(ys, 1) + u * p["D"]) * torch.nn.functional.silu(z)
    torch.testing.assert_close(y, y_ref @ p["out_proj"], atol=1e-4,
                               rtol=1e-3)


def test_mamba_decode_continues_prefill():
    _, _, cfg, p = _mamba_setup(chunk=4)
    B, S = 1, 12
    x = _t(_normal(1, (B, S + 1, 16)))
    y_full, _ = Mb.mamba(p, x, cfg)
    st = Mb.init_mamba_state(B, cfg, dtype=torch.float32)
    ys = []
    for t in range(S + 1):
        y_t, st = Mb.mamba(p, x[:, t:t + 1], cfg, st)
        ys.append(y_t)
    torch.testing.assert_close(torch.cat(ys, 1), y_full, atol=1e-4,
                               rtol=1e-3)


def _xlstm_setup(kind, n_heads=4, chunk=64, key=0):
    cfg_r = RXl.XLSTMConfig(d_model=16, n_heads=n_heads, chunk=chunk)
    init = RXl.init_mlstm if kind == "mlstm" else RXl.init_slstm
    p_r, _ = init(jax.random.PRNGKey(key), cfg_r)
    return cfg_r, p_r, _cfg(cfg_r), _params(p_r)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_decode_matches_scan(kind):
    """The reference's two checks (mLSTM with 2 heads, sLSTM), one token at
    a time against the full scan, and mLSTM's final memory."""
    _, _, cfg, p = _xlstm_setup(kind, n_heads=2 if kind == "mlstm" else 4)
    fn = Xl.mlstm if kind == "mlstm" else Xl.slstm
    B, S = 2, 9
    x = _t(_normal(1, (B, S, 16)))
    y_full, st_full = fn(p, x, cfg)
    st, ys = None, []
    for t in range(S):
        y_t, st = fn(p, x[:, t:t + 1], cfg, st)
        ys.append(y_t)
    torch.testing.assert_close(torch.cat(ys, 1), y_full, atol=1e-4,
                               rtol=1e-3)
    if kind == "mlstm":
        torch.testing.assert_close(st["C"], st_full["C"], atol=1e-4,
                                   rtol=1e-3)


def naive_moe(p, x, cfg):
    """Dense reference: every expert on every token, weighted by router."""
    probs = torch.softmax(x @ p["router"], -1)
    top_p, top_e = torch.topk(probs, cfg.top_k)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    h = torch.nn.functional.silu(torch.einsum("bsd,edf->bsef", x, p["gate"])) \
        * torch.einsum("bsd,edf->bsef", x, p["up"])
    out_e = torch.einsum("bsef,efd->bsed", h, p["down"])
    w = torch.zeros(probs.shape).scatter(-1, top_e, top_p)
    return torch.einsum("bse,bsed->bsd", w, out_e)


def _moe_setup(d, f, E, K, cf, key=0):
    cfg_r = RMoe.MoEConfig(d_model=d, d_ff=f, num_experts=E, top_k=K,
                           capacity_factor=cf)
    p_r, _ = RMoe.init_moe(jax.random.PRNGKey(key), cfg_r)
    return cfg_r, p_r, _cfg(cfg_r), _params(p_r)


def test_moe_matches_dense_reference_with_ample_capacity():
    _, _, cfg, p = _moe_setup(16, 32, 4, 2, 4.0)  # no drops
    x = _t(_normal(1, (2, 24, 16)))
    y, aux = Moe.moe(p, x, cfg)
    assert float(aux["dropped_frac"]) == 0.0
    torch.testing.assert_close(y, naive_moe(p, x, cfg), atol=1e-4, rtol=1e-3)


def test_moe_drops_overflow_gracefully():
    _, _, cfg, p = _moe_setup(8, 16, 4, 2, 0.25)
    y, aux = Moe.moe(p, _t(_normal(1, (2, 16, 8))), cfg)
    assert 0.0 < float(aux["dropped_frac"]) < 1.0
    assert bool(torch.isfinite(y).all())


def test_xlstm_chunked_scan_matches_plain():
    """The chunk length does not change the numbers (bit for bit)."""
    x = _t(_normal(1, (2, 32, 16)))
    for kind, key in (("mlstm", 0), ("slstm", 2)):
        _, _, cfg, p = _xlstm_setup(kind, n_heads=2, chunk=8, key=key)
        fn = Xl.mlstm if kind == "mlstm" else Xl.slstm
        yc, _ = fn(p, x, cfg)
        yu, _ = fn(p, x, dataclasses.replace(cfg, chunk=1))
        assert torch.equal(yc, yu)


# ---------------------------------------------------------------------------
# Parity with the reference package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,G,Sq,Sk,block,offset", [
    (4, 4, 64, 64, 16, 0), (8, 2, 50, 50, 64, 0), (6, 3, 96, 96, 32, 0),
    (4, 2, 8, 40, 16, 32), (12, 12, 5, 1500, 512, 0)])
def test_flash_attention_matches_the_reference(causal, H, G, Sq, Sk, block,
                                               offset):
    dh = 16
    q, k, v = (_normal(s, shape) for s, shape in (
        (1, (2, Sq, H, dh)), (2, (2, Sk, G, dh)), (3, (2, Sk, G, dh))))
    want = np.asarray(RL.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal,
                                         block=block, q_offset=offset))
    got = L.flash_attention(_t(q), _t(k), _t(v), causal=causal, block=block,
                            q_offset=offset)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sections,dh", [((3, 3, 2), 16), ((16, 24, 24), 128),
                                         ((2, 3, 3), 16), ((2, 2, 2), 16),
                                         ((4, 4, 4), 16)])
def test_apply_mrope_matches_the_reference(sections, dh):
    x = _normal(4, (2, 7, 3, dh))
    pos3 = np.random.default_rng(5).integers(0, 4096, (2, 3, 7)).astype(
        np.int32)
    want = np.asarray(RL.apply_mrope(jnp.asarray(x), jnp.asarray(pos3),
                                     sections, theta=1e6))
    got = L.apply_mrope(_t(x), torch.from_numpy(pos3), sections, theta=1e6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _route_both(cfg_r, p_r, cfg, p, x):
    """top_e, slot, keep and the outputs of both packages' moe."""
    logits = (jnp.asarray(x) @ p_r["router"]).astype(jnp.float32)
    top_p, top_e = jax.lax.top_k(jax.nn.softmax(logits, -1), cfg.top_k)
    top_p = top_p / (jnp.sum(top_p, -1, keepdims=True) + 1e-9)
    B, S = x.shape[:2]
    fold = B if (S == 1 and B > 1) else 1
    cap = int(max(1, round(S * fold * cfg.top_k * cfg.capacity_factor
                           / cfg.num_experts)))
    _, _, slot_r, _, keep_r = RMoe._route_local(
        jnp.asarray(x), top_e, top_p, E=cfg.num_experts, K=cfg.top_k,
        cap=cap, fold=fold)
    xt = _t(x)
    probs = Moe.softmax((xt @ p["router"]).float())
    tp, te = Moe.top_k(probs, cfg.top_k)
    tp = tp / (tp.sum(-1, keepdim=True) + 1e-9)
    _, slot, _, keep, _ = Moe._route_local(
        xt, te, tp, E=cfg.num_experts, K=cfg.top_k, cap=cap, fold=fold)
    return ((np.asarray(top_e), te.numpy()), (np.asarray(slot_r),
                                               slot.numpy()),
            (np.asarray(keep_r), keep.numpy()))


@pytest.mark.parametrize("B,S,E,K,cf", [
    (2, 24, 4, 2, 4.0),  # ample capacity
    (2, 16, 4, 2, 0.25),  # drops
    (8, 1, 40, 8, 1.25),  # decode: 8 rows folded into one routing group
    (3, 1, 4, 2, 1.25),  # decode, drops
    (1, 33, 16, 4, 1.25)])
def test_moe_matches_the_reference_at_fp32(B, S, E, K, cf):
    cfg_r, p_r, cfg, p = _moe_setup(16, 32, E, K, cf, key=B * S)
    x = _normal(B + S, (B, S, 16))
    for a, b in _route_both(cfg_r, p_r, cfg, p, x):
        np.testing.assert_array_equal(b, a)  # top_e, slot, keep
    y_r, aux_r = RMoe.moe(p_r, jnp.asarray(x), cfg_r)
    y, aux = Moe.moe(p, _t(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=1e-5,
                               atol=1e-6)
    for name in ("load_balance", "router_z", "dropped_frac"):
        np.testing.assert_allclose(float(aux[name]), float(aux_r[name]),
                                   rtol=1e-5)


@pytest.mark.parametrize("case", ["drops", "decode", "ties", "granite"])
def test_moe_in_bf16_equals_the_reference_run_op_by_op(case):
    """bf16 activations and weights: the outputs and dropped share equal to
    the reference's op by op, bit for bit: a batch that drops tokens, a
    decode batch (one routing group of 6 rows sharing a capacity of 1 an
    expert), router
    probabilities tied (two experts' router columns equal, so the top-k
    breaks ties by index), and the Granite smoke layer at decode."""
    d, f, E, K, cf, B, S = {"drops": (16, 32, 4, 2, 0.5, 2, 16),
                            "decode": (16, 32, 8, 2, 0.5, 6, 1),
                            "ties": (16, 32, 8, 3, 1.25, 2, 12),
                            "granite": (64, 64, 4, 2, 1.25, 8, 1)}[case]
    cfg_r, p_r, cfg, _ = _moe_setup(d, f, E, K, cf, key=E)
    if case == "ties":
        r = np.array(p_r["router"])
        r[:, 1], r[:, 5] = r[:, 0], r[:, 4]
        p_r = {**p_r, "router": jnp.asarray(r)}
    p = _params(p_r, torch.bfloat16)
    x = _normal(7, (B, S, d))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    with jax.disable_jit():
        y_r, aux_r = RMoe.moe(p_r, xb, cfg_r)
    y, aux = Moe.moe(p, torch.from_numpy(x).to(torch.bfloat16), cfg)
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(y_r.astype(jnp.float32)))
    assert float(aux["dropped_frac"]) == float(aux_r["dropped_frac"])
    if case in ("drops", "decode"):
        assert float(aux["dropped_frac"]) > 0
    if case == "ties":
        logits = (torch.from_numpy(x).to(torch.bfloat16) @ p["router"]).float()
        assert torch.equal(logits[..., 0], logits[..., 1])


@pytest.mark.parametrize("S,chunk", [(37, 8), (64, 16), (5, 64), (1, 4)])
def test_mamba_matches_the_reference(S, chunk):
    cfg_r, p_r, cfg, p = _mamba_setup(chunk=chunk, d=32, state=8)
    x = _normal(S, (2, S, 32))
    y_r, st_r = RMb.mamba(p_r, jnp.asarray(x), cfg_r)
    y, st = Mb.mamba(p, _t(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(st["conv"].numpy(), np.asarray(st_r["conv"]))
    assert st["ssm"] is None and st_r["ssm"] is None


def test_mamba_decode_matches_the_reference():
    cfg_r, p_r, cfg, p = _mamba_setup(chunk=4, d=32, state=8)
    x = _normal(9, (3, 10, 32))
    st_r = RMb.init_mamba_state(3, cfg_r, dtype=jnp.float32)
    st = Mb.init_mamba_state(3, cfg, dtype=torch.float32)
    for t in range(10):
        y_r, st_r = RMb.mamba(p_r, jnp.asarray(x[:, t:t + 1]), cfg_r, st_r)
        y, st = Mb.mamba(p, _t(x[:, t:t + 1]), cfg, st)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(st["ssm"].numpy(), np.asarray(st_r["ssm"]),
                               rtol=1e-5, atol=1e-5)


def test_associative_scan_is_the_references_order():
    """The chunk scan's products are the reference's bit for bit (elementwise
    IEEE products and sums in the same tree)."""
    a, b = _normal(1, (2, 37, 3)), _normal(2, (2, 37, 3))

    def combine(e1, e2):
        return e2[0] * e1[0], e2[0] * e1[1] + e2[1]

    ra, rb = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                jnp.asarray(b)), axis=1)
    ta, tb = Mb.associative_scan(_t(a), _t(b))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(rb))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("S", [1, 9, 32])
def test_xlstm_matches_the_reference(kind, S):
    cfg_r, p_r, cfg, p = _xlstm_setup(kind, n_heads=2, chunk=8)
    ref_fn = RXl.mlstm if kind == "mlstm" else RXl.slstm
    fn = Xl.mlstm if kind == "mlstm" else Xl.slstm
    x = _normal(S, (2, S, 16))
    y_r, st_r = ref_fn(p_r, jnp.asarray(x), cfg_r)
    y, st = fn(p, _t(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=1e-6,
                               atol=1e-6)
    for k in st_r:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(st_r[k]),
                                   rtol=1e-6, atol=1e-6)
    # a decode step from that state
    x1 = _normal(S + 100, (2, 1, 16))
    y_r, _ = ref_fn(p_r, jnp.asarray(x1), cfg_r, st_r)
    y, _ = fn(p, _t(x1), cfg, st)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=1e-6,
                               atol=1e-6)
