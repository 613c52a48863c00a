"""The port's transformer layers (``repro_torch.nn.layers``) against the
reference's (``repro.nn.layers``) on the same arrays.

Tolerances, and why:

  * fp32 (``activ_dtype=float32``): within 1e-6 — the same formulas, with
    fp32 transcendentals and sums that may differ in the last bit;
  * bf16: norms, dense products, SwiGLU and GELU bit for bit (the port
    rounds every step to bf16 where the reference's JAX does); RoPE within
    one bf16 ulp (an fp32 sin/cos that differs in the last bit can move a
    rounding);
  * ``_quant_kv`` bit for bit: the same ``amax / 127 + 1e-9`` scale and
    round-half-to-even on both sides;
  * attention against a KV pool or cache: the new KV bit for bit, the
    output within one bf16 ulp (fp32 softmax sums in another order before
    the bf16 cast).

The reference's functions run as its own tests call them (eagerly, the
Pallas decode kernel in interpret mode).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import layers as RL
from repro_torch.nn import layers as PL

D, H, G, DH = 64, 4, 2, 16
BF16_ULP = 2.0 ** -8  # relative spacing of bf16 at its coarsest


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j(a, dtype):
    return jnp.asarray(a).astype(dtype)


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _dense_params(rng, names_shapes):
    return {n: {"w": (rng.standard_normal(s) / np.sqrt(s[0])).astype(
        np.float32)} for n, s in names_shapes}


def _cast(tree, f):
    return {k: _cast(v, f) if isinstance(v, dict) else f(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("jd,td", DTYPES)
def test_rmsnorm_and_layernorm(jd, td):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, D)).astype(np.float32) * 3
    scale = rng.standard_normal(D).astype(np.float32)
    bias = rng.standard_normal(D).astype(np.float32)
    got = PL.rmsnorm({"scale": torch.from_numpy(scale)}, _t(x, td))
    want = RL.rmsnorm({"scale": jnp.asarray(scale)}, _j(x, jd))
    assert got.dtype == td
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    p_t = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    p_j = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    np.testing.assert_allclose(_np(PL.layernorm(p_t, _t(x, td))),
                               _np(RL.layernorm(p_j, _j(x, jd))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("jd,td", DTYPES)
def test_apply_rope(jd, td):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, H, DH)).astype(np.float32)
    pos = (np.arange(9)[None] * np.array([[3], [61]])).astype(np.int32)
    np.testing.assert_array_equal(_np(PL.rope_freqs(DH, 5e5)),
                                  _np(RL.rope_freqs(DH, 5e5)))
    got = _np(PL.apply_rope(_t(x, td), torch.from_numpy(pos), 5e5))
    want = _np(RL.apply_rope(_j(x, jd), jnp.asarray(pos), 5e5))
    if td == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=0)


@pytest.mark.parametrize("jd,td", DTYPES)
def test_qkv_projections_and_rope(jd, td):
    rng = np.random.default_rng(2)
    p = _dense_params(rng, (("q", (D, H * DH)), ("k", (D, G * DH)),
                            ("v", (D, G * DH)), ("o", (H * DH, D))))
    x = rng.standard_normal((3, 4, D)).astype(np.float32)
    pos = np.arange(12, dtype=np.int32).reshape(3, 4) * 5
    rcfg = RL.AttnConfig(D, H, G, DH, rope_theta=5e5)
    pcfg = PL.AttnConfig(D, H, G, DH, rope_theta=5e5)
    want = RL._qkv(_cast(p, lambda a: _j(a, jd)), _j(x, jd), rcfg,
                   jnp.asarray(pos))
    got = PL._qkv(_cast(p, lambda a: _t(a, td)), _t(x, td), pcfg,
                  torch.from_numpy(pos))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if td == torch.float32:
            np.testing.assert_allclose(_np(g), _np(w), rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_allclose(_np(g), _np(w), rtol=BF16_ULP, atol=0)
    # v carries no rotation: a bf16 product, bit for bit
    np.testing.assert_array_equal(_np(got[2]), _np(want[2]))


@pytest.mark.parametrize("jd,td", DTYPES)
def test_swiglu_and_gelu_mlp(jd, td):
    rng = np.random.default_rng(3)
    p = _dense_params(rng, (("gate", (D, 128)), ("up", (D, 128)),
                            ("down", (128, D))))
    x = rng.standard_normal((2, 5, D)).astype(np.float32) * 2
    got = _np(PL.swiglu(_cast(p, lambda a: _t(a, td)), _t(x, td)))
    want = _np(RL.swiglu(_cast(p, lambda a: _j(a, jd)), _j(x, jd)))
    bias = rng.standard_normal(128 + D).astype(np.float32)
    pg = {"up": {**p["up"], "b": bias[:128]},
          "down": {**p["down"], "b": bias[128:]}}
    got_g = _np(PL.gelu_mlp(_cast(pg, lambda a: _t(a, td)), _t(x, td)))
    want_g = _np(RL.gelu_mlp(_cast(pg, lambda a: _j(a, jd)), _j(x, jd)))
    if td == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_g, want_g, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_g, want_g)


@pytest.mark.parametrize("jd,td", DTYPES)
def test_quant_kv_bitwise(jd, td):
    rng = np.random.default_rng(4)
    t = rng.standard_normal((64, G, DH)).astype(np.float32) * 3
    t[0] = 0.0  # an all-zero row: scale 1e-9, values 0
    t[1, 0, 0] = 127 * 0.5 / 127  # values on a rounding boundary
    qj, sj = RL._quant_kv(_j(t, jd))
    qt, st = PL._quant_kv(_t(t, td))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def _pool_pair(rng, nbp, bs, int8):
    k = rng.standard_normal((nbp, bs, G, DH)).astype(np.float32)
    v = rng.standard_normal((nbp, bs, G, DH)).astype(np.float32)
    if int8:
        (kq, ks), (vq, vs) = RL._quant_kv(jnp.asarray(k)), RL._quant_kv(
            jnp.asarray(v))
        pj = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        pt = {n: torch.from_numpy(np.array(a)) for n, a in pj.items()}
    else:
        pj = {"k": _j(k, jnp.bfloat16), "v": _j(v, jnp.bfloat16)}
        pt = {"k": _t(k, torch.bfloat16), "v": _t(v, torch.bfloat16)}
    return pj, pt


@pytest.mark.parametrize("int8", [False, True])
def test_pool_write(int8):
    rng = np.random.default_rng(5)
    pj, pt = _pool_pair(rng, 7, 4, int8)
    k = rng.standard_normal((5, G, DH)).astype(np.float32)
    v = rng.standard_normal((5, G, DH)).astype(np.float32)
    phys = np.array([0, 3, 6, 6, 2], np.int32)  # two rows to the trash block
    off = np.array([1, 0, 3, 3, 2], np.int32)
    want = RL._pool_write(pj, jnp.asarray(phys), jnp.asarray(off),
                          _j(k, jnp.bfloat16), _j(v, jnp.bfloat16))
    got = PL._pool_write(pt, torch.from_numpy(phys), torch.from_numpy(off),
                         _t(k, torch.bfloat16), _t(v, torch.bfloat16))
    assert got is pt  # written in place
    live = [0, 1, 2, 3, 4, 5]  # the trash block's content is unspecified
    for name in pj:
        np.testing.assert_array_equal(_np(got[name])[live],
                                      _np(want[name])[live], err_msg=name)


def _attn_params(rng):
    p = _dense_params(rng, (("q", (D, H * DH)), ("k", (D, G * DH)),
                            ("v", (D, G * DH)), ("o", (H * DH, D))))
    return (_cast(p, lambda a: _j(a, jnp.bfloat16)),
            _cast(p, lambda a: _t(a, torch.bfloat16)))


@pytest.mark.parametrize("int8", [False, True])
def test_attention_decode_paged(int8):
    rng = np.random.default_rng(6)
    bs, W, B = 4, 3, 3
    pj, pt = _pool_pair(rng, B * W + 1, bs, int8)
    aj, at = _attn_params(rng)
    x = rng.standard_normal((B, 1, D)).astype(np.float32)
    table = np.arange(B * W, dtype=np.int32).reshape(B, W)
    lens = np.array([0, 5, 11], np.int32)
    active = np.array([True, False, True])
    cfg_r = RL.AttnConfig(D, H, G, DH, rope_theta=5e5)
    cfg_p = PL.AttnConfig(D, H, G, DH, rope_theta=5e5)
    out_j, pool_j = RL.attention_decode_paged(
        aj, _j(x, jnp.bfloat16), pj, cfg_r, jnp.asarray(table),
        jnp.asarray(lens), jnp.asarray(active), interpret=True)
    out_t, pool_t = PL.attention_decode_paged(
        at, _t(x, torch.bfloat16), pt, cfg_p, torch.from_numpy(table),
        torch.from_numpy(lens), torch.from_numpy(active))
    live = list(range(B * W))
    for name in pool_j:
        np.testing.assert_array_equal(_np(pool_t[name])[live],
                                      _np(pool_j[name])[live], err_msg=name)
    rows = active  # an inactive row's output is garbage the caller ignores
    np.testing.assert_allclose(_np(out_t)[rows], _np(out_j)[rows],
                               rtol=BF16_ULP, atol=1e-6)


@pytest.mark.parametrize("int8", [False, True])
def test_attention_prefill_paged(int8):
    rng = np.random.default_rng(7)
    bs, W, C = 4, 4, 6
    pj, pt = _pool_pair(rng, W + 2, bs, int8)
    aj, at = _attn_params(rng)
    x = rng.standard_normal((1, C, D)).astype(np.float32)
    row_table = np.array([3, 0, 4, 1], np.int32)
    cfg_r = RL.AttnConfig(D, H, G, DH, rope_theta=5e5)
    cfg_p = PL.AttnConfig(D, H, G, DH, rope_theta=5e5)
    for len0, count in ((0, 6), (6, 4)):
        out_j, pj = RL.attention_prefill_paged(
            aj, _j(x, jnp.bfloat16), pj, cfg_r, jnp.asarray(row_table),
            jnp.int32(len0), jnp.int32(count))
        out_t, pt = PL.attention_prefill_paged(
            at, _t(x, torch.bfloat16), pt, cfg_p,
            torch.from_numpy(row_table), len0, count)
        live = list(range(W + 1))
        for name in pj:
            np.testing.assert_array_equal(_np(pt[name])[live],
                                          _np(pj[name])[live], err_msg=name)
        np.testing.assert_allclose(_np(out_t)[:, :count],
                                   _np(out_j)[:, :count], rtol=BF16_ULP,
                                   atol=1e-6)


@pytest.mark.parametrize("int8", [False, True])
def test_attention_decode_contiguous(int8):
    rng = np.random.default_rng(8)
    B, S = 3, 12
    aj, at = _attn_params(rng)
    cfg_r = RL.AttnConfig(D, H, G, DH, rope_theta=5e5)
    cfg_p = PL.AttnConfig(D, H, G, DH, rope_theta=5e5)
    cj = RL.init_kv_cache(B, S, cfg_r, jnp.int8 if int8 else jnp.bfloat16)
    ct = PL.init_kv_cache(B, S, cfg_p, torch.int8 if int8 else torch.bfloat16)
    for step in range(4):
        x = rng.standard_normal((B, 1, D)).astype(np.float32)
        pos = np.array(cj["len"])[:, None]
        out_j, cj = RL.attention_decode(aj, _j(x, jnp.bfloat16), cj, cfg_r,
                                        jnp.asarray(pos))
        out_t, ct = PL.attention_decode(at, _t(x, torch.bfloat16), ct, cfg_p,
                                        torch.from_numpy(pos))
        for name in cj:
            np.testing.assert_array_equal(_np(ct[name]), _np(cj[name]),
                                          err_msg=f"{name} at step {step}")
        np.testing.assert_allclose(_np(out_t), _np(out_j), rtol=BF16_ULP,
                                   atol=1e-6)
    # rows not active keep their cache and length
    before = {k: v.clone() for k, v in ct.items()}
    x = _t(rng.standard_normal((B, 1, D)), torch.bfloat16)
    PL.attention_decode(at, x, ct, cfg_p, ct["len"][:, None],
                        torch.tensor([False, True, False]))
    step = torch.tensor([0, 1, 0], dtype=torch.int32)
    assert torch.equal(ct["len"], before["len"] + step)
    for name in ("k", "v"):
        assert torch.equal(ct[name][[0, 2]], before[name][[0, 2]])
