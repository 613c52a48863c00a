"""MoE stacks served by the port: paged ``ServeEngine`` and ``LMEngine`` on
the Granite-MoE and dbrx smoke configs against the reference's, and the
reference's contiguous-path slot dependence, pinned.

Streams: against the reference run op by op (``jax.disable_jit()``, its
Pallas decode kernel interpreted), the port's greedy tokens are equal and
its last-prefill and decode logits within one bf16 ulp of each row's
largest |logit| (bf16 matmuls summed in another order round a rare small
logit the other way: one element of 1536 in dbrx's run).  At decode the
MoE folds the slot batch into one routing group (capacity
``round(B K 1.25 / E)``), so the rows, idle slots' dummy tokens included,
compete for expert capacity.

The slot dependence: the contiguous ``ServeEngine`` prefills a prompt
token by broadcasting it to every slot, and the copies compete for
capacity, so a prompt's prefill logits depend on its slot.  The port keeps
the reference's numbers (ROADMAP Queue C records the defect); the paged
path, which prefills with one routing group per chunk, does not have it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.runtime as rrt
from repro.configs.registry import ARCHS
from repro.launch.serve import ServeEngine as RServe
from repro.lm.paging import PagedConfig as RPaged
from repro.nn import moe as RMoe
from repro.nn import transformer as RT
from repro_torch import convert
from repro_torch import runtime as rt
from repro_torch.configs import registry
from repro_torch.launch.serve import ServeEngine
from repro_torch.lm.paging import PagedConfig
from repro_torch.nn import moe as Moe

MOE_ARCHS = ["granite-moe-3b-a800m", "dbrx-132b"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_CACHE: dict = {}


def _weights(arch_id):
    if arch_id not in _CACHE:
        cfg_r = ARCHS[arch_id].smoke()
        params_r, _ = RT.init(jax.random.PRNGKey(0), cfg_r)
        cfg_t = registry.get(arch_id).smoke()
        model = convert.lm_params_from_reference(
            jax.tree.map(np.asarray, params_r), cfg_t, device="cpu")
        _CACHE[arch_id] = cfg_r, params_r, cfg_t, model
    return _CACHE[arch_id]


def _within_an_ulp(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    top = np.abs(want).max(-1, keepdims=True)
    assert (np.abs(got - want) <= 2.0 ** (np.floor(np.log2(top)) - 7)).all()


def _prompt(seed, n, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_paged_streams_equal_the_reference_run_op_by_op(arch_id):
    cfg_r, params_r, cfg_t, model = _weights(arch_id)
    kw = dict(block_size=4, prefill_chunk=3)
    ref = RServe(cfg_r, params_r, 3, 16, paged=RPaged(**kw))
    eng = ServeEngine(cfg_t, model, 3, 16, device="cpu",
                      paged=PagedConfig(**kw))
    logits = []
    inner = ref._decode_paged
    ref._decode_paged = lambda *a: logits.append(inner(*a)) or logits[-1]
    with jax.disable_jit():
        for s, n in enumerate((1, 5, 9)):  # nothing, one and three chunks
            p = _prompt(s + 1, n)
            lr, lp = ref.add_request(s, jnp.asarray(p)), eng.add_request(s, p)
            assert (lr is None) == (lp is None)
            if lr is not None:
                _within_an_ulp(lp.numpy(), np.asarray(lr))
        for _ in range(4):
            ref.step()
            eng.step()
            _within_an_ulp(eng.last_logits.numpy(),
                           np.asarray(logits[-1][0][:, -1]))
    assert eng.generated == ref.generated


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_lm_engine_tokens_equal_the_reference_run_op_by_op(arch_id):
    """Six requests over three paged slots (admission as slots free up,
    idle slots decoding dummy tokens beside live ones): every request's
    tokens equal the reference LMEngine's."""
    cfg_r, params_r, cfg_t, model = _weights(arch_id)
    kw = dict(slots=3, max_len=24, decode_per_step=2)
    pk = dict(block_size=4, prefill_chunk=4)
    ref = rrt.LMEngine(cfg_r, params_r, **kw, paged=RPaged(**pk))
    eng = rt.LMEngine(cfg_t, model, **kw, device="cpu",
                      paged=PagedConfig(**pk))
    with jax.disable_jit():
        for e in (ref, eng):
            for i, n in enumerate((3, 7, 2, 5, 9, 4)):
                e.submit(_prompt(30 + i, n), max_new_tokens=3 + i % 3)
        want = {r.id: r.tokens for r in ref.drain()}
    got = {r.id: r.tokens for r in eng.drain()}
    assert got == want and len(got) == 6
    assert eng.serve.decode_dispatches == ref.serve.decode_dispatches


def test_decode_capacity_is_shared_by_the_slot_batch():
    """One token broadcast to B rows (the contiguous prefill's batch): the
    copies compete for one routing group's capacity, so rows past the first
    get their MoE output dropped, exactly as in the reference (Granite's
    smoke layer: B = 3 drops a third, row 2's output is 0; B = 8 zeroes
    rows 5-7)."""
    cfg_r, params_r, cfg_t, model = _weights("granite-moe-3b-a800m")
    p_r = jax.tree.map(lambda a: a[0], params_r["blocks"][0]["moe"])
    p = model.blocks[0]["moe"]
    x = np.random.default_rng(3).standard_normal((1, 1, cfg_r.d_model))
    for B, zero_rows in ((3, [2]), (8, [5, 6, 7])):
        xb = np.repeat(x, B, 0).astype(np.float32)
        with jax.disable_jit():
            y_r, aux_r = RMoe.moe(p_r, jnp.asarray(xb).astype(jnp.bfloat16),
                                  cfg_r.moe)
        y, aux = Moe.moe(p, torch.from_numpy(xb).to(torch.bfloat16),
                         cfg_t.moe)
        np.testing.assert_array_equal(y.float().numpy(),
                                      np.asarray(y_r.astype(jnp.float32)))
        assert float(aux["dropped_frac"]) == float(aux_r["dropped_frac"]) > 0
        dead = [b for b in range(B) if not bool(y[b].any())]
        assert dead == zero_rows, (B, dead)
        if B == 3:
            assert abs(float(aux["dropped_frac"]) - 1 / 3) < 1e-6


def test_contiguous_prefill_depends_on_the_slot_as_the_reference_does():
    """The same prompt prefilled into slot 0 and slot 2 of a 3-slot
    contiguous engine gives different logits (the broadcast copies compete
    for capacity), each equal to the reference's for that slot, bit for
    bit; the paged engine gives one answer for every slot."""
    cfg_r, params_r, cfg_t, model = _weights("granite-moe-3b-a800m")
    prompt = _prompt(7, 6)
    got, want = {}, {}
    for slot in (0, 2):
        ref = RServe(cfg_r, params_r, 3, 16)
        eng = ServeEngine(cfg_t, model, 3, 16, device="cpu")
        with jax.disable_jit():
            want[slot] = np.asarray(ref.add_request(slot, jnp.asarray(prompt)))
        got[slot] = eng.add_request(slot, prompt).numpy()
        np.testing.assert_array_equal(got[slot], want[slot])
    assert not np.array_equal(got[0], got[2])  # the defect, as the reference
    paged = [ServeEngine(cfg_t, model, 3, 16, device="cpu",
                         paged=PagedConfig(block_size=4, prefill_chunk=8)
                         ).add_request(slot, prompt).numpy()
             for slot in (0, 2)]
    np.testing.assert_array_equal(paged[0], paged[1])
