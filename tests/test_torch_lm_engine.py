"""The port's ``LMEngine`` (``repro_torch.runtime``) and the ``lm_decode``
spec against the reference's, on the reference's smoke config with its
``T.init(PRNGKey(0))`` weights (``convert.lm_params_from_reference``).

Contracts:

  * request bookkeeping (admission, queue, slots, dispatch counters and the
    snapshot schema) equal to the reference's;
  * tokens of these prompts equal to the reference's, and bit-equal across
    a paged ``resize``, ``recover`` and ``preempt`` within the port;
  * ``decode_per_step`` and the ``lm_decode`` cost ops (every field: names,
    kinds, shapes, dependencies) equal, for the smoke and the full Llama 3.2 3B
    config — host code, no weights;
  * sampling: the port draws from Philox, not ``jax.random``, so a sampled
    stream is held statistically: deterministic in (seed, position), top-k
    respected, and token frequencies within a chi-square band of
    ``softmax(logits / T)``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.runtime as rrt
from repro.cogsim import model as rhw
from repro.configs.registry import ARCHS
from repro.engine import engine as reng
from repro.engine import registry as rreg
from repro.lm.paging import PagedConfig as RPaged
from repro.nn import transformer as RT
from repro_torch import convert
from repro_torch import runtime as rt
from repro_torch.cogsim import model as thw
from repro_torch.configs import registry
from repro_torch.engine import engine as teng
from repro_torch.engine import registry as treg
from repro_torch.launch.serve import ServeEngine
from repro_torch.lm import sampling as smp
from repro_torch.lm.paging import PagedConfig
from repro_torch.lm.sampling import SamplingSpec


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smoke():
    cfg_r = ARCHS["llama3.2-3b"].smoke()
    params_r, _ = RT.init(jax.random.PRNGKey(0), cfg_r)
    cfg_t = registry.get("llama3.2-3b").smoke()
    model = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, params_r), cfg_t, device="cpu")
    return cfg_r, params_r, cfg_t, model


def _prompt(seed, n, vocab=512):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (n,), 0,
                                         vocab))


def _engines(smoke, **kw):
    cfg_r, params_r, cfg_t, model = smoke
    pk = kw.pop("paged", None)
    ref = rrt.LMEngine(cfg_r, params_r, **kw,
                       paged=None if pk is None else RPaged(**pk))
    eng = rt.LMEngine(cfg_t, model, **kw, device="cpu",
                      paged=None if pk is None else PagedConfig(**pk))
    return ref, eng


def _submit_all(eng, lens=(4, 5, 6), mnt=8):
    return [eng.submit(_prompt(20 + i, n), max_new_tokens=mnt)
            for i, n in enumerate(lens)]


def _tokens(done):
    return {r.id: r.tokens for r in done}


# -- request layer against the reference -------------------------------------

def test_admission_deferred_until_the_pool_frees(smoke):
    ref, eng = _engines(smoke, slots=2, max_len=32, decode_per_step=2,
                        paged=dict(block_size=4, num_blocks=3,
                                   max_blocks_per_slot=3))
    ids = {}
    for e in (ref, eng):
        a = e.submit(_prompt(9, 8), max_new_tokens=6)  # 2 blocks
        b = e.submit(_prompt(10, 8), max_new_tokens=6)  # must wait
        e.step()
        assert e._owner[0] is not None and e._owner[0].id == a
        assert e._owner[1] is None and len(e._queue) == 1  # b deferred
        ids[e] = (a, b)
    got, want = _tokens(eng.drain()), _tokens(ref.drain())
    assert set(got) == set(ids[eng]) and got == want
    s_t, s_r = eng.snapshot(), ref.snapshot()
    assert set(s_t) == set(s_r)
    for key in ("steps", "completed", "tokens_total", "prefill_dispatches",
                "decode_dispatches", "kv_bytes_touched", "decode_per_step"):
        assert s_t[key] == s_r[key], key


@pytest.mark.parametrize("new_slots", [2, 4])
def test_paged_resize_carries_bit_equal(smoke, new_slots):
    """Shrink (the displaced request replays) and grow (the queued request
    gets a slot): tokens equal to an undisturbed run and to the
    reference's resized run."""
    kw = dict(slots=3, max_len=32, decode_per_step=2,
              paged=dict(block_size=8, prefill_chunk=4))
    ref, eng = _engines(smoke, **kw)
    _, still = _engines(smoke, **kw)
    for e in (ref, eng, still):
        _submit_all(e, lens=(4, 5, 6, 7))
        e.step()
    for e in (ref, eng):
        e.resize(new_slots)
        assert e.resizes_total == 1 and e.slots == new_slots
    got = _tokens(eng.drain())
    assert got == _tokens(still.drain())
    assert got == _tokens(ref.drain())
    assert eng.serve.prefill_dispatches == ref.serve.prefill_dispatches


def test_contiguous_resize_replays_bit_equal(smoke):
    ref, eng = _engines(smoke, slots=3, max_len=32, decode_per_step=2)
    _, still = _engines(smoke, slots=3, max_len=32, decode_per_step=2)
    for e in (ref, eng, still):
        _submit_all(e)
        e.step()
    eng.resize(2)  # contiguous cannot carry: every live request replays
    ref.resize(2)
    got = _tokens(eng.drain())
    assert got == _tokens(still.drain()) == _tokens(ref.drain())


def test_recover_preempt_and_cancel_replay_bit_equal(smoke):
    kw = dict(slots=2, max_len=32, decode_per_step=2,
              paged=dict(block_size=8, prefill_chunk=4))
    _, eng = _engines(smoke, **kw)
    _, still = _engines(smoke, **kw)
    for e in (eng, still):
        _submit_all(e)
        e.step()
    assert eng.recover() == 2  # both live requests replay
    eng.step()
    live = next(r.id for r in eng._owner if r is not None)
    assert eng.preempt(live) == 1 and eng.preempt(live) == 0
    got = _tokens(eng.drain())
    assert got == _tokens(still.drain())
    assert eng.recoveries_total == 1
    extra = eng.submit(_prompt(3, 4))
    assert eng.cancel(extra) and not eng.cancel(extra)
    assert eng.in_flight == 0


def test_paged_switch_from_the_environment(smoke, monkeypatch):
    _, _, cfg_t, model = smoke
    monkeypatch.setenv("REPRO_LM_PAGED", "1")
    assert rt.LMEngine(cfg_t, model, slots=1, max_len=16,
                       device="cpu").paged == PagedConfig()
    monkeypatch.delenv("REPRO_LM_PAGED")
    assert rt.LMEngine(cfg_t, model, slots=1, max_len=16,
                       device="cpu").paged is None


# -- the lm_decode spec and the decode burst (host code) ---------------------

def _op_view(ops):
    """Every field of every op: name, kind, dims, deps, batch, symbolic,
    collective, weight residency."""
    return [dataclasses.astuple(o) for o in ops]


@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_lm_decode_spec_and_burst_equal_the_reference(which, kv):
    cfg_r = getattr(ARCHS["llama3.2-3b"], which)()
    cfg_t = getattr(registry.get("llama3.2-3b"), which)()
    cfg_r = dataclasses.replace(cfg_r, kv_cache_dtype=kv)
    cfg_t = dataclasses.replace(cfg_t, kv_cache_dtype=kv)
    for slots, prompt_len, max_len, kv_block in ((4, 16, 128, None),
                                                 (32, 288, 545, 16),
                                                 (3, 5, 32, 8)):
        kw = dict(batch=slots, prompt_len=prompt_len, max_len=max_len,
                  kv_block=kv_block)
        sr = rreg.build("lm_decode", None, cfg=cfg_r, **kw)
        st = treg.build("lm_decode", None, cfg=cfg_t, **kw)
        for a, b in zip(st.graph.stages, sr.graph.stages):
            assert (a.name, a.symbolic) == (b.name, b.symbolic)
            assert _op_view(a.cost_ops) == _op_view(b.cost_ops)
        assert _op_view(teng.step_unit_ops(st, slots)) == \
            _op_view(reng.step_unit_ops(sr, slots))
        assert teng.derive_sweeps_per_step(st, slots, thw.COGSYS) == \
            reng.derive_sweeps_per_step(sr, slots, rhw.COGSYS)


def test_engine_decode_per_step_equals_the_reference(smoke):
    for kw in (dict(slots=3, max_len=32, paged=dict(block_size=8)),
               dict(slots=8, max_len=64), dict(slots=2, max_len=16,
                                               prompt_len_hint=5)):
        ref, eng = _engines(smoke, **kw)
        assert eng.decode_per_step == ref.decode_per_step
        assert eng.step_cost_s() == pytest.approx(ref.step_cost_s(),
                                                  rel=1e-12)


# -- sampling ----------------------------------------------------------------

def test_sampling_spec_validation():
    with pytest.raises(ValueError, match="temperature"):
        SamplingSpec(temperature=0.0)
    with pytest.raises(ValueError, match="top_k"):
        SamplingSpec(top_k=0)


def test_step_sampler_footguns_die_loudly(smoke):
    _, _, cfg_t, model = smoke
    eng = ServeEngine(cfg_t, model, 1, 16, device="cpu")
    eng.add_request(0, _prompt(40, 4))
    with pytest.raises(ValueError, match="PRNG key"):
        eng.step(sampler="categorical")
    with pytest.raises(ValueError, match="temperature"):
        eng.step(sampler="categorical", temperature=0.0, key=0)
    with pytest.raises(TypeError, match="SamplingSpec"):
        eng.add_request(0, _prompt(40, 4), sampling={"temperature": 1.0})
    with pytest.raises(TypeError, match="SamplingSpec"):
        rt.LMEngine(cfg_t, model, slots=1, max_len=16, device="cpu").submit(
            _prompt(40, 4), sampling=0.7)
    nxt = eng.step(sampler="categorical", temperature=1.3, key=5)
    assert nxt is not None and 0 <= int(nxt[0]) < cfg_t.vocab
    gen = torch.Generator().manual_seed(5)
    assert eng.step(sampler="categorical", key=gen) is not None


def test_sampled_stream_deterministic_across_engines_and_resize(smoke):
    """Same request + seed -> same tokens, whatever the slot count, paging,
    burst size or a resize that displaces it."""
    _, _, cfg_t, model = smoke
    spec = SamplingSpec(temperature=0.8, top_k=16, seed=42)
    p = _prompt(41, 4)
    outs = []
    for kw in (dict(slots=2, decode_per_step=2,
                    paged=PagedConfig(block_size=8)),
               dict(slots=1, decode_per_step=3),
               dict(slots=3, decode_per_step=1,
                    paged=PagedConfig(block_size=4))):
        eng = rt.LMEngine(cfg_t, model, max_len=32, device="cpu", **kw)
        eng.submit(_prompt(30, 5), max_new_tokens=6, sampling=spec)
        rid = eng.submit(p, max_new_tokens=6, sampling=spec)
        eng.step()
        if kw["slots"] == 2:
            eng.resize(1)  # the second request is displaced and replays
        outs.append(_tokens(eng.drain())[rid])
    assert outs[0] == outs[1] == outs[2]
    assert len(outs[0]) == 6


def test_sample_token_respects_top_k():
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal(
        64).astype(np.float32))
    top = set(torch.topk(logits, 5).indices.tolist())
    for seed in range(20):
        spec = SamplingSpec(temperature=3.0, top_k=5, seed=seed)
        for pos in range(10):
            assert smp.sample_token(logits, spec, pos) in top
    spec = SamplingSpec(temperature=3.0, top_k=1, seed=1)
    assert smp.sample_token(logits, spec, 0) == int(torch.argmax(logits))


def test_sample_frequencies_match_softmax():
    """20000 draws over 200 seeds x 100 positions: a chi-square statistic
    against softmax(logits / T) below 29.9, the 1e-4 upper quantile at 7
    degrees of freedom (a correct sampler fails it once in 10^4 runs; the
    draw is seeded, so this run's statistic is fixed)."""
    logits = torch.tensor([1.0, 0.5, 0.0, -0.5, 2.0, 0.3, -1.0, 1.2])
    T = 0.7
    p = torch.softmax(logits / T, dim=0).numpy()
    pos = torch.arange(100)
    counts = np.zeros(8)
    for seed in range(200):
        g = smp.gumbel(seed, pos, smp.POSITION_STREAM, 8)
        draws = torch.argmax((logits / T).double() + g, dim=-1)
        counts += np.bincount(draws.numpy(), minlength=8)
        if seed < 3:  # the vectorised draw is sample_token's own
            spec = SamplingSpec(temperature=T, seed=seed)
            assert [smp.sample_token(logits, spec, int(i))
                    for i in pos[:10]] == draws[:10].tolist()
    n = counts.sum()
    chi2 = float(((counts - n * p) ** 2 / (n * p)).sum())
    assert chi2 < 29.9, (chi2, counts / n, p)


# -- entry points ------------------------------------------------------------

def test_entry_points_default_to_cuda(smoke):
    """Every LM entry point runs on the card unless asked for the CPU; on a
    machine without one, the default raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    from repro_torch.lm import model as lm_model
    from repro_torch.nn import transformer as T

    _, _, cfg_t, model = smoke
    for call in (lambda: T.init(cfg_t, 0),
                 lambda: T.init_cache(cfg_t, 2, 8),
                 lambda: lm_model.init_pool(cfg_t, 4, 8),
                 lambda: convert.lm_params_from_reference({}, cfg_t),
                 lambda: ServeEngine(cfg_t, model, 1, 8),
                 lambda: rt.LMEngine(cfg_t, model, slots=1, max_len=8)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_serve_main_on_the_cpu(caplog):
    from repro_torch.launch import serve

    with caplog.at_level("INFO", logger=serve.log.name):
        serve.main(["--arch", "llama3.2-3b", "--smoke", "--paged",
                    "--device", "cpu", "--batch", "2", "--prompt-len", "5",
                    "--gen", "3"])
    text = caplog.text
    assert "llama3.2-smoke" in text and "(2 dispatches)" in text
    assert "decode 3 steps x 2 slots" in text
    with pytest.raises(KeyError, match="qwen2.5-32b"):  # names the known
        registry.get("no-such-arch")


@pytest.mark.parametrize("arch_id", ["granite-moe-3b-a800m",
                                     "jamba-1.5-large-398b",
                                     "qwen2-vl-72b"])
def test_moe_mamba_and_mrope_configs_build_and_match_the_reference(arch_id):
    """The three kinds the port once refused (an ``attn_moe`` stack, a
    Mamba hybrid, M-RoPE with a vision prefix) build from the registry and
    give the reference's logits at fp32 (rtol 1e-5 of each row's largest
    |logit|: fp32 sums in another order)."""
    from repro_torch.nn import transformer as T

    cfg_r = dataclasses.replace(ARCHS[arch_id].smoke(),
                                activ_dtype=jax.numpy.float32)
    cfg_t = dataclasses.replace(registry.get(arch_id).smoke(),
                                activ_dtype=torch.float32)
    params_r, _ = RT.init(jax.random.PRNGKey(0), cfg_r)
    model = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, params_r), cfg_t, device="cpu")
    assert T.param_count(model) == RT.param_count(params_r)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg_r.vocab, (2, 12)).astype(np.int32)
    kw = {}
    if cfg_r.mrope_sections is not None:
        kw["positions"] = np.stack([np.arange(12) * m for m in (1, 2, 3)]
                                   )[None].repeat(2, 0).astype(np.int32)
        kw["vision_embeds"] = rng.standard_normal(
            (2, cfg_r.vision_patches, cfg_r.d_model)).astype(np.float32)
    want, _ = RT.forward(params_r, cfg_r, jax.numpy.asarray(tokens),
                         **{k: jax.numpy.asarray(v) for k, v in kw.items()})
    got, _ = T.forward(model, cfg_t, torch.from_numpy(tokens),
                       **{k: torch.from_numpy(v) for k, v in kw.items()})
    want = np.asarray(want)
    row = np.abs(want).max(-1, keepdims=True)
    assert (np.abs(got.numpy() - want) <= 1e-5 * row).all()
