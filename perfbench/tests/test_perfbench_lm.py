"""The language-model cell on the CPU, at ``starcoder2_3b.smoke()`` widths:
the plain reference against the port's paged serving, the seeded inputs, a
rehearsal of the cell through the harness (its look for a card skipped),
and ``correct`` false for the control, each planted fault of the reference
in the program's place, and the timed path broken underneath."""
import numpy as np
import pytest
import torch

from perfbench.tests.common import ROOT  # noqa: F401  (the port on the path)
from perfbench.bench import harness, judge, spec
from perfbench.reference import lm as ref

NAME = "starcoder2-3b.azure-code"
SEED = 2 ** 31 + 4321  # seeds may exceed 32 signed bits
# starcoder2_3b.smoke()'s widths; the cell's traffic cut to a CPU's size
SMOKE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab=512, head_dim=16, max_num_seqs=8, max_position_embeddings=112)
SMALL = dict(clients=8, warm_retired=8, pool=64,
             prompt_len={"median": 16, "sigma": 0.8, "min": 4, "max": 40},
             new_tokens={"median": 16, "sigma": 0.5, "min": 8, "max": 40},
             prefill_chunk=16, sample=24, sample_slowest=4)


def lm_cell(**config) -> spec.Cell:
    cell = spec.cell(NAME)
    cell.config.update(SMOKE, **config)
    cell.traffic.update(SMALL)
    return cell


def system_of(cell, seed=SEED):
    mod = spec.load_module("systems", cell.config["system"])
    return mod, mod.System(cell.config, cell.traffic, seed, torch.device("cpu"))


def test_weights_are_the_ports_model_and_repeat_for_a_seed():
    from repro_torch.nn import transformer as T

    cell = lm_cell()
    mod, a = system_of(cell)
    _, b = system_of(cell)
    _, c = system_of(cell, SEED + 1)
    assert torch.equal(a.weights["blocks"][1]["up_w"], b.weights["blocks"][1]["up_w"])
    assert not torch.equal(a.weights["embed"], c.weights["embed"])
    model = mod.port_model(cell.config, a.weights)
    want = {n: (tuple(p.shape), p.dtype) for n, p in
            T.abstract_init(mod.model_config(cell.config)).named_parameters()}
    got = {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()}
    assert got == want
    # the port's parameters are the benchmark's tensors, not copies
    assert model.blocks[0]["attn"]["q"]["w"].data_ptr() == \
        a.weights["blocks"][0]["q_w"].data_ptr()
    ln = a.weights["blocks"][0]["ln1"]
    assert ln["bias"].abs().mean() > 0.05 and (ln["scale"] - 1).abs().mean() > 0.05


def test_every_seed_serves_the_same_lengths_in_its_own_order():
    cell = lm_cell()
    _, a = system_of(cell)
    _, b = system_of(cell, SEED + 1)
    for x, y in ((a.prompt_lens, b.prompt_lens), (a.new_tokens, b.new_tokens)):
        np.testing.assert_array_equal(np.sort(x), np.sort(y))
        assert not np.array_equal(x, y)
    # every 16 consecutive requests hold one length of each 16th share
    mod = spec.load_module("systems", "lm_serving")
    order = mod.stratified(np.random.default_rng(5), np.arange(64), 16)
    for block in order.reshape(-1, 16):
        assert sorted(block // 4) == list(range(16))
    assert sorted(order) == list(range(64))
    assert a.prompt_lens.min() == 4 and a.prompt_lens.max() == 40
    assert np.median(a.prompt_lens) == 16  # the log-normal's median
    prompt, new = a.request(64 + 3)  # request i asks for pool entry i mod 64
    np.testing.assert_array_equal(prompt, a.request(3)[0])
    assert len(prompt) == a.prompt_lens[3] and new == a.new_tokens[3]
    assert (a.tokens >= 0).all() and (a.tokens < SMOKE["vocab"]).all()


def test_the_code_mix_keeps_its_medians_and_fits_a_slot():
    """The cell's own mix: the medians it states, and the longest prompt,
    output and decode burst's overshoot inside a slot's positions."""
    cell = spec.cell(NAME)
    mod = spec.load_module("systems", cell.config["system"])
    t, n = cell.traffic, int(cell.traffic["pool"])
    prompts, outs = mod.lengths(t["prompt_len"], n), mod.lengths(t["new_tokens"], n)
    assert np.median(prompts) == t["prompt_len"]["median"]
    assert np.median(outs) == t["new_tokens"]["median"]
    burst = 15  # LMEngine's decode burst at 32 slots
    assert prompts.max() + outs.max() + burst - 2 <= \
        cell.config["max_position_embeddings"]


def test_the_reference_is_the_ports_paged_serving_in_fp32():
    """Prefill, then paged decode, against the reference's whole-sequence
    pass over the prompt and the program's own tokens.  The port's KV pool
    is bf16 whatever the activations' type, so the reference stands with
    K and V rounded to bf16 (``bf16_kv``); then only the order of fp32 sums
    and the port's fp32 RoPE angles (the reference's are float64) differ:
    1e-4 of the row's largest |logit| (two layers, d 64), where K/V in
    fp32 differ by ~1e-3."""
    from repro_torch.lm.paging import PagedConfig
    from repro_torch.runtime.lm import LMEngine

    cell = lm_cell(dtype="float32")
    mod, sys_ = system_of(cell)
    eng = LMEngine(mod.model_config(cell.config),
                   mod.port_model(cell.config, sys_.weights), slots=2,
                   max_len=96, decode_per_step=1, device="cpu",
                   paged=PagedConfig(block_size=16, prefill_chunk=16))
    seen = {}  # slot -> [logits after the last prefilled token, each decode]
    add = eng.serve.add_request

    def add_request(slot, prompt, sampling=None):
        seen[slot] = [add(slot, prompt, sampling=sampling)[0]]
        return seen[slot][0]

    eng.serve.add_request = add_request
    prompts = [sys_.tokens[:37], sys_.tokens[40:61]]
    ids = [eng.submit(p, max_new_tokens=20) for p in prompts]
    done = {}
    while len(done) < 2:
        out = eng.step()
        for s in range(2):
            seen[s].append(eng.serve.last_logits[s].clone())
        done.update({r.id: r for r in out})
    for slot, (rid, p) in enumerate(zip(ids, prompts)):
        toks = done[rid].tokens
        got = torch.stack(seen[slot][:1 + len(toks)])  # positions P-2 .. P+n-2
        full = torch.as_tensor(np.concatenate([p, toks]), dtype=torch.int64)
        want = {}
        for fmt in ("bf16_kv", None):
            h = ref.hidden(sys_.weights, {**cell.config, "block_size": 16},
                           full[None], fmt)[0]
            want[fmt] = h[len(p) - 2:len(p) - 1 + len(toks)] @ \
                sys_.weights["head"].float()
        scale = want["bf16_kv"].abs().amax(-1, keepdim=True)
        err = ((got - want["bf16_kv"]).abs() / scale).max().item()
        assert err < 1e-4, err
        assert ((got - want[None]).abs() / scale).max().item() > 10 * err
        assert got[1:].argmax(-1).tolist() == toks


def run(trace=False, seconds=2.0) -> dict:
    return harness.run_cell(lm_cell(), SEED, seconds, trace, device="cpu",
                            patience_s=10.0)


def test_a_rehearsal_of_the_cell_is_correct():
    res = run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"setup_s", "tokens_per_s"}
    assert res["metrics"]["tokens_per_s"]["value"] > 0
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == {"unanswered", "truncated", "token_margin",
                                  "kv_pool_off_type"}
    assert res["checks"]["kv_pool_off_type"]["value"] == 0


def test_a_traced_rehearsal_reads_the_lm_layer():
    res = run(trace=True)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    for name in ("lm.ttft_p95_ms", "lm.tpot_ms", "lm.prefill_share",
                 "lm.decode_ms"):
        assert got[name]["value"] > 0, name
    assert 0 < got["lm.prefill_share"]["value"] < 100
    # device readers find nothing to read on the CPU and stay silent
    for name in ("flash_decode_roofline", "lm.mfu.token", "device.idle.token"):
        assert name not in got


@pytest.fixture(scope="module")
def window():
    cell = lm_cell()
    system, win, _ = harness.measure(cell, SEED, 2.0, False, device="cpu",
                                     patience_s=10.0)
    return cell, system, win


def test_the_program_passes_where_the_control_fails(window):
    """The control: the reference one precision below bf16 (every product's
    operands and K/V in float8 e4m3) in the program's place."""
    cell, system, win = window
    limits = cell.config["limits"]
    sound, _ = harness.judged(cell, system, win, SEED)
    assert judge.passed(judge.checks(sound, limits)), sound
    ctrl, _ = harness.judged(cell, system, win, SEED, fmt=cell.config["control"])
    assert not judge.passed(judge.checks(ctrl, limits)), ctrl


def test_a_kv_pool_of_another_type_is_not_correct(window):
    """The logits cannot tell an int8 or float8 pool from bf16 (PERF.md §2),
    so the pool the program served from is held to the configuration's."""
    cell, system, win = window
    sound, _ = harness.judged(cell, system, win, SEED)
    assert sound["kv_pool_off_type"] == 0
    served, system.pool_dtype = system.pool_dtype, "torch.int8"
    try:
        got, _ = harness.judged(cell, system, win, SEED)
    finally:
        system.pool_dtype = served
    assert got["kv_pool_off_type"] == 1
    assert not judge.passed(judge.checks(got, cell.config["limits"])), got


@pytest.mark.parametrize("fault", ref.FAULTS)
def test_each_planted_fault_fails(window, fault):
    cell, system, win = window
    got, _ = harness.judged(cell, system, win, SEED, overrides={"fault": fault})
    assert not judge.passed(judge.checks(got, cell.config["limits"])), got


def altered_token(monkeypatch):
    """A token altered where it is produced: at every fourth position, each
    slot's next token plus one."""
    from repro_torch.launch.serve import ServeEngine

    real = ServeEngine.step

    def step(self, *a, **k):
        out = real(self, *a, **k)
        for s in range(self.slots):
            if out is not None and self.active[s] and self.lens[s] % 4 == 0:
                self.generated[s][-1] = (self.generated[s][-1] + 1) \
                    % SMOKE["vocab"]
        return out
    monkeypatch.setattr(ServeEngine, "step", step)


def half_left_out(monkeypatch):
    """Half of the slot batch left out of each decode step: those rows run
    as inactive (their KV goes to the trash block) while the engine keeps
    their tokens."""
    from repro_torch.lm import model

    real = model.decode_step_paged

    def decode(m, cfg, pool, table, lens, tokens, active, **k):
        keep = torch.arange(active.shape[0], device=active.device) \
            < active.shape[0] // 2
        return real(m, cfg, pool, table, lens, tokens, active & keep, **k)
    monkeypatch.setattr(model, "decode_step_paged", decode)


def state_unchanged(monkeypatch):
    """A decode step that leaves the KV pool as it was: its writes dropped."""
    from repro_torch.lm import model
    from repro_torch.nn import layers

    real = model.decode_step_paged

    def decode(*a, **k):
        with monkeypatch.context() as m:
            m.setattr(layers, "_pool_write", lambda pool, *_: pool)
            return real(*a, **k)
    monkeypatch.setattr(model, "decode_step_paged", decode)


@pytest.mark.parametrize("fault", [altered_token, half_left_out,
                                   state_unchanged])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res = run()
    assert not res["correct"], res["checks"]
    chk = res["checks"]
    assert chk["token_margin"]["value"] > chk["token_margin"]["limit"], chk


def test_tokens_per_s_counts_what_the_slots_produced(monkeypatch):
    """The window's tokens worked out from the records equal those counted
    at each decode step: a token of a live slot whose request has not yet
    reached its ``max_new_tokens``."""
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.runtime.lm import LMEngine
    from perfbench.bench import lm_counts

    engines, per_step = [], []
    init, lm_step, step = LMEngine.__init__, LMEngine.step, ServeEngine.step

    def counted_init(self, *a, **k):
        init(self, *a, **k)
        engines.append(self)

    def counted_lm_step(self):
        per_step.append(0)
        return lm_step(self)

    def counted_step(self, *a, **k):
        out = step(self, *a, **k)
        for s, req in enumerate(engines[0]._owner):
            if out is not None and self.active[s] and req is not None \
                    and len(self.generated[s]) - 1 <= req.max_new_tokens:
                per_step[-1] += 1
        return out

    monkeypatch.setattr(LMEngine, "__init__", counted_init)
    monkeypatch.setattr(LMEngine, "step", counted_lm_step)
    monkeypatch.setattr(ServeEngine, "step", counted_step)
    cell = lm_cell()
    _, win, _ = harness.measure(cell, SEED, 2.0, False, device="cpu",
                                patience_s=10.0)
    lo, hi = win.window_steps
    c = win.book.view()
    got = lm_counts.tokens_in_steps(win.decodes, c["step_first"],
                                    c["step_retire"], c["iterations"], lo, hi)
    assert got == sum(per_step[lo:hi + 1]) > 0
