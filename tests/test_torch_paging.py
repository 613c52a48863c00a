"""Paged LM serving: the port's ``BlockTablePool`` and ``ServeEngine`` against
the reference's, on the reference's smoke config (``llama3.2-smoke``: 2
layers, d = 64, 4 heads, 2 KV heads, dh = 16, vocab 512) with the
reference's ``T.init(PRNGKey(0))`` weights converted by
``convert.lm_params_from_reference``.

Contracts:

  * host bookkeeping (block tables, dispatch counts, ``kv_bytes_touched``,
    parking) equal;
  * greedy token streams equal, except at a near tie.  The reference's
    ServeEngine runs jitted, and XLA's fused RoPE computes sin/cos
    differently from the same ops run one by one (1.3e-5 apart at fp32),
    which moves its bf16 logits by up to 2 ulps; run op by op, the
    reference gives the port's logits bit for bit
    (``tests/test_torch_serve_exact.py``).  So against the jitted
    reference a stream may leave only at a step where the reference's top
    two logits lie within 2 bf16 ulps and the port picked one of them
    (:func:`_assert_streams_agree`); with the bf16 pool the 1-token
    prompt's stream does, at decode step 3, at a gap of 1 ulp (ROADMAP
    Queue C);
  * last-prefill logits within 4 bf16 ulps of the largest logit (measured:
    under 2);
  * within the port: the paged stream equals the contiguous one, and the
    stream does not depend on the block size.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS
from repro.launch.serve import ServeEngine as RServe
from repro.lm.paging import BlockTablePool as RPool
from repro.lm.paging import PagedConfig as RPaged
from repro.nn import transformer as RT
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.kernels.flash_decode import ops as fd
from repro_torch.launch.serve import ServeEngine
from repro_torch.lm import model as lm_model
from repro_torch.lm.paging import BlockTablePool, PagedConfig


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smoke():
    """(reference cfg, reference params, port cfg, port model) per KV dtype."""
    cfg_r = ARCHS["llama3.2-3b"].smoke()
    params_r, _ = RT.init(jax.random.PRNGKey(0), cfg_r)
    cfg_t = registry.get("llama3.2-3b").smoke()
    model = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, params_r), cfg_t, device="cpu")
    out = {}
    for kv in ("bf16", "int8"):
        out[kv] = (dataclasses.replace(cfg_r, kv_cache_dtype=kv), params_r,
                   dataclasses.replace(cfg_t, kv_cache_dtype=kv), model)
    return out


def _prompt(seed, n, vocab=512):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (n,), 0,
                                         vocab))


def _bf16_ulp(x) -> float:
    return 2.0 ** (np.floor(np.log2(np.abs(x))) - 7)


class _LogitTap:
    """Records the reference ServeEngine's per-step logits [slots, V]."""

    def __init__(self, eng):
        self.steps = []
        name = "_decode_paged" if eng.paged is not None else "_decode"
        inner = getattr(eng, name)

        def tapped(*args):
            logits, state = inner(*args)
            self.steps.append(np.asarray(logits[:, -1]))
            return logits, state

        setattr(eng, name, tapped)


def _assert_streams_agree(want_gen, got_gen, logits, first, slots):
    """Streams equal up to a near tie of the reference run (see module doc).
    ``logits[t]`` are the reference's logits at step t, which produced
    token ``first + t`` of every stream.  Returns the diverging slots."""
    diverged = []
    for s in slots:
        want, got = want_gen[s], got_gen[s]
        assert len(want) == len(got), s
        bad = [i for i in range(len(want)) if want[i] != got[i]]
        if not bad:
            continue
        i = bad[0]
        lg = logits[i - first][s]
        top2 = np.sort(lg)[-2:]
        gap = top2[1] - top2[0]
        assert gap <= 2 * _bf16_ulp(top2[1]), (
            f"slot {s} leaves the reference at token {i} without a near "
            f"tie: top-2 gap {gap}")
        assert lg[got[i]] >= top2[1] - 2 * _bf16_ulp(top2[1]), s
        diverged.append(s)
    return diverged


# -- PagedConfig / BlockTablePool -------------------------------------------

def test_paged_config_validation():
    for kw, what in ((dict(block_size=0), "block_size"),
                     (dict(prefill_chunk=0), "prefill_chunk"),
                     (dict(num_blocks=0), "num_blocks"),
                     (dict(max_blocks_per_slot=0), "max_blocks_per_slot")):
        with pytest.raises(ValueError, match=what):
            PagedConfig(**kw)
    with pytest.raises(TypeError, match="PagedConfig"):
        ServeEngine(None, None, 1, 8, paged=True, device="cpu")
    assert not hasattr(PagedConfig(), "interpret")
    p = PagedConfig(block_size=8)
    r = RPaged(block_size=8)
    for slots, max_len in ((4, 32), (3, 33), (1, 7)):
        assert p.resolve_num_blocks(slots, max_len) == \
            r.resolve_num_blocks(slots, max_len)
        assert p.resolve_table_width(slots, max_len) == \
            r.resolve_table_width(slots, max_len)


def _drive_pool(cls):
    """tests/test_paging.py's allocation sequences; the tables after each."""
    out = []
    pool = cls(num_blocks=4, block_size=4, slots=2, table_width=3)
    out += [pool.trash, pool.free_blocks, pool.ensure(0, 5),
            pool.ensure(1, 4), pool.table().tolist(), pool.ensure(1, 13),
            pool.ensure(1, 8), pool.ensure(0, 12), pool.release(0),
            pool.free_blocks, pool.ensure(1, 12), pool.capacity(1),
            pool.table().tolist()]
    pool = cls(num_blocks=6, block_size=4, slots=3, table_width=2)
    for s in range(3):
        out.append(pool.ensure(s, 8))
    pool.resize(2, carry=[1])
    out += [pool.slots, pool.rows, pool.free_blocks, pool.table().tolist()]
    with pytest.raises(ValueError, match="cannot carry"):
        pool.resize(1, carry=[0, 1])
    pool.reset()
    out += [pool.free_blocks, pool.table().tolist(), pool.slot_capacity]
    return out


def test_block_table_pool_equals_the_reference():
    got, want = _drive_pool(BlockTablePool), _drive_pool(RPool)
    assert got == want
    assert got[4] == [[0, 1, 4], [2, 4, 4]]  # deterministic ids, trash-padded


# -- the port's ServeEngine against the reference's ---------------------------

def _pair(smoke, kv, slots, max_len, paged_kw):
    cfg_r, params_r, cfg_t, model = smoke[kv]
    ref = RServe(cfg_r, params_r, slots, max_len,
                 paged=None if paged_kw is None else RPaged(**paged_kw))
    eng = ServeEngine(
        cfg_t, model, slots, max_len, device="cpu",
        paged=None if paged_kw is None else PagedConfig(**paged_kw))
    return ref, eng


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_serving_matches_the_reference(smoke, kv):
    ref, eng = _pair(smoke, kv, 3, 32, dict(block_size=8, prefill_chunk=4))
    tap = _LogitTap(ref)
    # mixed lengths: 1-token (nothing to prefill), off/at chunk boundary
    for s, n in enumerate((1, 5, 9)):
        p = _prompt(s + 1, n)
        lr = ref.add_request(s, jnp.asarray(p))
        lp = eng.add_request(s, p)
        if lr is None:
            assert lp is None
        else:
            lr = np.asarray(lr)
            tol = 4 * _bf16_ulp(np.abs(lr).max())
            np.testing.assert_allclose(lp.numpy(), lr, rtol=0, atol=tol)
    for _ in range(6):
        ref.step()
        eng.step()
    _assert_streams_agree(ref.generated, eng.generated, tap.steps, 1,
                          range(3))
    assert eng.prefill_dispatches == ref.prefill_dispatches == 3
    assert eng.decode_dispatches == ref.decode_dispatches == 6
    assert eng.kv_bytes_touched == ref.kv_bytes_touched > 0
    np.testing.assert_array_equal(eng.lens, ref.lens)
    np.testing.assert_array_equal(eng.blocks.table(), ref.blocks.table())


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_stream_equals_contiguous_stream(smoke, kv):
    """Within the port, bit for bit: chunked prefill and the flash path
    against one-token prefill and the dense cache."""
    _, _, cfg_t, model = smoke[kv]
    contig = ServeEngine(cfg_t, model, 3, 32, device="cpu")
    paged = ServeEngine(cfg_t, model, 3, 32, device="cpu",
                        paged=PagedConfig(block_size=8, prefill_chunk=4))
    for s, n in enumerate((1, 5, 9)):
        p = _prompt(s + 1, n)
        lc, lp = contig.add_request(s, p), paged.add_request(s, p)
        if lc is not None:
            torch.testing.assert_close(lp, lc, rtol=0, atol=0)
    for _ in range(6):
        contig.step()
        paged.step()
    assert paged.generated == contig.generated
    assert contig.prefill_dispatches == 12 and paged.prefill_dispatches == 3


def test_greedy_stream_stable_across_block_sizes(smoke):
    _, _, cfg_t, model = smoke["bf16"]
    streams = []
    for bs, chunk in ((4, 3), (8, 4), (16, 8)):
        eng = ServeEngine(cfg_t, model, 2, 32, device="cpu",
                          paged=PagedConfig(block_size=bs,
                                            prefill_chunk=chunk))
        eng.add_request(0, _prompt(2, 6))
        eng.add_request(1, _prompt(3, 9))
        for _ in range(6):
            eng.step()
        streams.append([list(eng.generated[s]) for s in range(2)])
    assert streams[0] == streams[1] == streams[2]


def test_flash_decode_dispatches_per_decode_step_equal_attention_layers(smoke):
    """The port's form of the reference's "one pallas_call per decode
    dispatch": every decode step makes one flash_decode call per attention
    layer (counted by the plain version on the CPU, by ``ops.launches`` on
    the card), and prefill makes none."""
    _, _, cfg_t, model = smoke["bf16"]
    eng = ServeEngine(cfg_t, model, 2, 32, device="cpu",
                      paged=PagedConfig(block_size=8))
    calls = fd.plain_calls
    eng.add_request(0, _prompt(4, 10))
    eng.add_request(1, _prompt(5, 3))
    assert fd.plain_calls == calls
    for _ in range(5):
        eng.step()
    n_attn = sum(k.startswith("attn") for k in cfg_t.block_pattern) \
        * cfg_t.n_periods
    assert n_attn == cfg_t.n_layers == 2
    assert fd.plain_calls - calls == n_attn * eng.decode_dispatches == 10
    dense = ServeEngine(cfg_t, model, 2, 32, device="cpu",
                        paged=PagedConfig(block_size=8, use_flash=False))
    dense.add_request(0, _prompt(4, 10))
    calls = fd.plain_calls
    dense.step()
    assert fd.plain_calls == calls  # use_flash=False: the dense path


def test_pool_exhaustion_parks_like_the_reference(smoke):
    kw = dict(block_size=4, num_blocks=3, max_blocks_per_slot=3)
    ref, eng = _pair(smoke, "bf16", 2, 32, kw)
    tap = _LogitTap(ref)
    for e in (ref, eng):
        e.add_request(0, _prompt(6, 4) if e is eng else jnp.asarray(
            _prompt(6, 4)))
        e.add_request(1, _prompt(7, 5) if e is eng else jnp.asarray(
            _prompt(7, 5)))
    assert eng.blocks.free_blocks == ref.blocks.free_blocks == 0
    for _ in range(3):
        ref.step()
        eng.step()
    assert not eng.active[0] and eng.overflowed[0]
    assert eng.active[1] and not eng.overflowed[1]
    for e in (ref, eng):
        e.release_slot(0)
    assert eng.blocks.free_blocks == ref.blocks.free_blocks == 1
    for _ in range(4):  # len 7 -> 8 crosses into a 3rd block
        assert ref.step() is not None
        assert eng.step() is not None
    np.testing.assert_array_equal(eng.overflowed, ref.overflowed)
    np.testing.assert_array_equal(eng.active, ref.active)
    np.testing.assert_array_equal(eng.lens, ref.lens)
    assert eng.lens[1] == 11
    _assert_streams_agree(ref.generated, eng.generated, tap.steps, 1, [1])
    assert len(eng.generated[0]) == len(ref.generated[0])


def test_slot_capacity_exceeds_max_len_when_pool_allows(smoke):
    _, _, cfg_t, model = smoke["bf16"]
    eng = ServeEngine(cfg_t, model, 1, 8, device="cpu",
                      paged=PagedConfig(block_size=8, num_blocks=4,
                                        max_blocks_per_slot=4))
    assert eng.slot_capacity == 32  # pool-limited, not max_len=8
    eng.add_request(0, _prompt(8, 12))  # > max_len admits fine
    for _ in range(4):
        assert eng.step() is not None
    assert eng.lens[0] == 15 and not eng.overflowed[0]
    with pytest.raises(ValueError, match="exceeds the cache capacity"):
        eng.add_request(0, _prompt(8, 33))


def test_kv_bytes_metric_scales_with_live_blocks(smoke):
    ref_p, eng_p = _pair(smoke, "bf16", 2, 64, dict(block_size=8))
    ref_c, eng_c = _pair(smoke, "bf16", 2, 64, None)
    p = _prompt(43, 5)
    for e in (eng_p, eng_c):
        e.add_request(0, p)
        e.step()
    for e in (ref_p, ref_c):
        e.add_request(0, jnp.asarray(p))
        e.step()
    assert eng_p.kv_bytes_touched == ref_p.kv_bytes_touched
    assert eng_c.kv_bytes_touched == ref_c.kv_bytes_touched
    assert 0 < eng_p.kv_bytes_touched < eng_c.kv_bytes_touched


def test_paging_rejects_unsupported_stacks():
    cfg = dataclasses.replace(registry.get("llama3.2-3b").smoke(),
                              block_pattern=("mamba_mlp",))
    with pytest.raises(ValueError, match="attention-only"):
        lm_model.check_paging_supported(cfg)
    with pytest.raises(ValueError, match="M-RoPE"):
        lm_model.check_paging_supported(registry.get("qwen2-vl-72b").smoke())
    moe = registry.get("granite-moe-3b-a800m").smoke()
    lm_model.check_paging_supported(moe)  # pageable, as in the reference
    pool = lm_model.init_pool(moe, 4, 8, device="cpu")
    G, dh = moe.n_kv_heads, moe.head_dim
    assert pool["k"].shape == (moe.n_layers, 5, 8, G, dh)  # + trash block
