"""The reference's ``ServeEngine`` contracts (``tests/test_serve.py``) on the
port's contiguous ``ServeEngine``: prefill slot isolation, KV-capacity
parking, empty and overlong prompts, the last prompt token's KV written
once; on the smoke Llama with random weights drawn by the port, on the CPU.

Plus slot reuse on a stateful stack: an xLSTM slot released and served
again must start from a fresh state (its stabiliser ``m`` at -1e9, not
zero), so a second request in a reused slot matches a fresh engine bit for
bit.

Plus the reference's continuous-batching case (``tests/test_train_infra.py``)
and a model in the training layout served with grad mode on.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.launch.serve import ServeEngine
from repro_torch.nn import transformer as T


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompt(seed, n, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, n)


def _leaves(cache):
    return [t.clone() for per in cache for leaves in per.values()
            for t in leaves.values()]


def _engine(slots=3, max_len=32, arch="llama3.2-3b"):
    cfg = registry.get(arch).smoke()
    model = T.init(cfg, 0, "cpu")
    return cfg, model, ServeEngine(cfg, model, slots, max_len, device="cpu")


def test_prefill_writes_only_target_slot():
    cfg, model, eng = _engine()
    before = _leaves(eng.cache)
    logits = eng.add_request(0, _prompt(1, 5))
    assert logits.shape == (1, cfg.vocab) and bool(torch.isfinite(logits).all())
    # every cache leaf is [periods, batch, ...]: rows 1.. must be untouched
    for old, new in zip(before, _leaves(eng.cache)):
        assert torch.equal(old[:, 1:], new[:, 1:])
    assert list(eng.active) == [True, False, False]


def test_prefill_matches_single_slot_reference():
    cfg, model, eng = _engine(slots=3)
    ref = ServeEngine(cfg, model, 1, 32, device="cpu")
    prompt = _prompt(2, 6)
    # fill slot 1 first: slot 2's prefill must see a fresh row regardless
    eng.add_request(1, _prompt(3, 4))
    got = eng.add_request(2, prompt)
    want = ref.add_request(0, prompt)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_greedy_decode_isolated_per_slot():
    cfg, model, eng = _engine(slots=2)
    ref = ServeEngine(cfg, model, 1, 32, device="cpu")
    p0, p1 = _prompt(4, 5), _prompt(5, 7)
    eng.add_request(0, p0)
    eng.add_request(1, p1)
    ref.add_request(0, p0)
    for _ in range(4):
        eng.step()
        ref.step()
    assert eng.generated[0] == ref.generated[0]


def test_empty_prompt_returns_none():
    cfg, model, eng = _engine(slots=2)
    assert eng.add_request(0, np.zeros((0,), np.int64)) is None
    assert eng.generated[0] == []
    # one-token prompt: nothing to prefill, the token is fed by step()
    assert eng.add_request(1, [7]) is None
    assert eng.generated[1] == [7]


def test_decode_parks_slot_at_kv_capacity():
    """Decoding past max_len must park the slot, not silently clamp the KV
    write onto the last cache position."""
    cfg, model, eng = _engine(slots=2, max_len=8)
    eng.add_request(0, _prompt(7, 5))
    for _ in range(4):  # len 4 -> 8: exactly the remaining capacity
        assert eng.step() is not None
    assert eng.active[0] and eng.lens[0] == 8 and not eng.overflowed[0]
    before = _leaves(eng.cache)
    n_gen = len(eng.generated[0])
    assert eng.step() is None  # full slot parked; nothing left to decode
    assert not eng.active[0] and eng.overflowed[0] and eng.lens[0] == 8
    assert len(eng.generated[0]) == n_gen  # no token appended past capacity
    for old, new in zip(before, _leaves(eng.cache)):
        assert torch.equal(old, new)  # KV untouched
    # the parked slot is reusable: a fresh request resets the flags
    eng.add_request(0, [3, 1])
    assert eng.active[0] and not eng.overflowed[0] and eng.lens[0] == 1


def test_capacity_parking_leaves_other_slots_running():
    cfg, model, eng = _engine(slots=2, max_len=8)
    eng.add_request(0, _prompt(8, 7))
    eng.add_request(1, _prompt(9, 2))
    for _ in range(5):
        eng.step()
    assert not eng.active[0] and eng.overflowed[0]  # slot 0 hit capacity
    assert eng.active[1] and not eng.overflowed[1]  # slot 1 keeps decoding
    assert eng.lens[1] == 6


def test_overlong_prompt_rejected():
    cfg, model, eng = _engine(slots=1, max_len=8)
    with pytest.raises(ValueError, match="exceeds the cache capacity"):
        eng.add_request(0, np.zeros((9,), np.int64))
    assert not eng.active[0]  # rejected before touching the slot


def test_last_prompt_token_kv_written_once():
    """The last prompt token must enter the KV cache via step(), not twice."""
    cfg, model, eng = _engine(slots=1)
    eng.add_request(0, _prompt(6, 5))
    lens = [per["self"]["len"] for per in eng.cache]
    assert all((n[:, 0] == 4).all() for n in lens)  # prompt[:-1] only
    eng.step()
    assert all((n[:, 0] == 5).all() for n in lens)  # prompt[-1] landed once


@pytest.mark.parametrize("second", [[57], [57, 300, 12, 9, 401, 33, 2]])
def test_reused_xlstm_slot_starts_from_a_fresh_state(second):
    """Serve a request in slot 0 beside a neighbour in slot 1, release slot
    0, serve a second request there: the slot's state is a fresh cache's
    (the stabilisers ``m`` at -1e9, not zeros), and its logits and tokens
    equal those of a fresh engine serving only the second request, bit for
    bit (xLSTM rows share nothing).  A one-token request reaches its first
    decode step with the reset state itself."""
    cfg, model, eng = _engine(slots=2, arch="xlstm-125m")
    eng.add_request(1, _prompt(10, 6))  # a neighbour, decoding throughout
    eng.add_request(0, _prompt(11, 9))
    for _ in range(3):
        eng.step()
    eng.release_slot(0)
    got = eng.add_request(0, second)
    clean = ServeEngine(cfg, model, 2, 32, device="cpu")
    want = clean.add_request(0, second)
    assert (got is None) == (want is None)
    if got is not None:
        assert torch.equal(got, want)
    if len(second) == 1:  # nothing prefilled: the slot holds the reset state
        for per, fresh in zip(eng.cache, clean.cache):
            for name, leaves in per.items():
                for k, t in leaves.items():
                    assert torch.equal(t[:, 0], fresh[name][k][:, 0]), k
                if name in ("mlstm", "slstm"):
                    assert bool((leaves["m"][:, 0] == -1e9).all())
    for _ in range(4):
        eng.step()
        clean.step()
        assert torch.equal(eng.last_logits[0], clean.last_logits[0])
    assert eng.generated[0] == clean.generated[0]


def test_serve_engine_continuous_batching():
    """The reference's ``tests/test_train_infra.py`` case on the port:
    minicpm-2b smoke, two slots of 24, one request prefilled, both slots
    decoding 6 steps from the prompt's last token."""
    cfg = registry.get("minicpm-2b").smoke()
    model = T.init(cfg, 0, "cpu")
    eng = ServeEngine(cfg, model, batch_slots=2, max_len=24, device="cpu")
    prompt = _prompt(1, 4, cfg.vocab)
    eng.add_request(0, prompt)
    for s in range(2):
        eng.active[s] = True
        eng.generated[s] = [int(prompt[-1])]
    for _ in range(6):
        nxt = eng.step()
    assert nxt.shape == (2,)
    assert len(eng.generated[0]) == 7
    assert all(0 <= t < cfg.vocab for t in eng.generated[0])
    assert all(0 <= t < cfg.vocab for t in eng.generated[1])


@pytest.mark.parametrize("paged", [False, True])
def test_a_trainable_model_serves_without_a_graph(paged):
    """Serving runs under ``torch.no_grad()`` itself: a model in the
    training layout, served with grad mode on, builds no graph, so the
    paged path's kernel guard (which refuses operands that require grad)
    never fires; the tokens equal its serving copy's up to the stored
    dtype, which is fp32 for both here."""
    from repro_torch.lm.paging import PagedConfig

    cfg = dataclasses.replace(registry.get("llama3.2-3b").smoke(),
                              activ_dtype=torch.float32)
    model = T.init(cfg, 0, "cpu", trainable=True)
    served = T.serving_copy(model)
    out = []
    for m in (model, served):
        eng = ServeEngine(cfg, m, 2, 32, device="cpu",
                          paged=PagedConfig(block_size=4, prefill_chunk=4)
                          if paged else None)
        with torch.enable_grad():
            eng.add_request(0, _prompt(5, 7))
            eng.add_request(1, _prompt(6, 3))
            for _ in range(4):
                eng.step()
        assert not eng.last_logits.requires_grad
        out.append(eng.generated)
    assert out[0] == out[1]
