"""The Mellum2 cell on the CPU: the readers of its four new metrics on
made-up records, spans and device operations, its counts by hand, the
system's port model against the reference at a small size, the control and
each planted fault failing ``compare``, and the program broken underneath
(the window off, one expert's output zeroed) not ``correct``."""
import json
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from perfbench.tests.common import ROOT
from perfbench.bench import counts, harness, judge, moe_counts, peaks, spec
from perfbench.bench.trace import DeviceOp
from perfbench.reference import mellum as ref

NAME = "mellum2-12b.azure-code"
SEED = 2 ** 31 + 1234  # seeds may exceed 32 signed bits
GEMM = "cutlass::device_kernel<GemmUniversal<GroupProblemShape<int>>>"
PREP = "at::cuda::detail::prepare_grouped_gemm_data<bfloat16_t>"


def cfg_small() -> dict:
    c = dict(spec.cell(NAME).config)
    c.update(num_hidden_layers=4, hidden_size=8, num_attention_heads=4,
             num_key_value_heads=2, head_dim=2, moe_intermediate_size=4,
             num_experts=8, num_experts_per_tok=2, vocab_size=10,
             sliding_window=5,
             layer_types=["sliding_attention"] * 3 + ["full_attention"])
    return c


def span(name, t0, t1, **args):
    return types.SimpleNamespace(name=name, t0=t0, t1=t1, args=args)


def book(**cols):
    n = len(next(iter(cols.values())))
    cols = {k: np.asarray(v) for k, v in cols.items()}
    cols.setdefault("i", np.arange(n))
    return types.SimpleNamespace(view=lambda rows=None: cols, n=n)


def readings(**kw):
    """A stand-in for ``harness.Readings`` over a window [0, 10]."""
    win = types.SimpleNamespace(t0=0.0, t1=10.0, seconds=10.0,
                                book=kw.pop("all_rows", None),
                                steps=kw.pop("steps", None))
    cell = types.SimpleNamespace(config=cfg_small(),
                                 traffic={"block_size": 4})
    base = dict(window=win, spans=[], ops=[], trace_window=None,
                peaks=peaks.H100, cell=cell, system=None)
    base.update(kw)
    r = types.SimpleNamespace(**base)
    r.within = lambda spans, lo=None, hi=None: [
        s for s in spans if s.t0 >= (win.t0 if lo is None else lo)
        and s.t1 <= (win.t1 if hi is None else hi)]
    return r


def metric(name):
    return spec.load_module("metrics", name).read


# ---------------------------------------------------------------------------
# Counts and readers
# ---------------------------------------------------------------------------

def test_counts_by_hand():
    c = cfg_small()
    g = moe_counts.grouped_products(3, 5, c)
    # 3 experts' gate, up, down of 8 x 4 in bf16; 5 tokens x 2 assignments
    # of 8 in and out
    assert g == {"flops": 6 * 8 * 4 * 10, "bytes": 2 * 3 * 8 * 4 * 3
                 + 2 * 2 * 8 * 10, "peak": "bf16_flops"}
    assert moe_counts.windows(c) == [5, 5, 5, None]
    w = moe_counts.flash_decode_window([3, 9], 5, c, 4)
    assert w == moe_counts.flash_decode_window([3, 5], None, c, 4)
    assert list(moe_counts.context_sum(np.array([0, 2]), np.array([7, 9]),
                                       5)) == [1 + 2 + 3 + 4 + 5 + 5 + 5,
                                               3 + 4 + 5 + 5 + 5 + 5 + 5]
    assert moe_counts.context_sum(0, 4, None) == 10
    # q 8x8, k and v 8x4, o 8x8, router 8x8, 2 experts x 3 x 8x4, 4 layers
    assert moe_counts.position_flops(c) == 2 * 4 * (64 + 64 + 64 + 64 + 192)


def test_moe_share_reads_the_kernels_launched_inside_moe_spans():
    spans = [span("moe", 1.0, 1.1), span("moe", 2.0, 2.1),
             span("prefill-chunk", 0.5, 2.5)]
    ops = [DeviceOp("a", 1.2, 1.3, 1.05), DeviceOp("b", 1.5, 1.7, 1.5),
           DeviceOp("c", 2.2, 2.25, 2.05), DeviceOp("d", 2.25, 2.3, 2.2)]
    r = readings(spans=spans, ops=ops, trace_window=(0.0, 3.0))
    assert metric("lm.moe_share")(r) == pytest.approx(100 * 0.15 / 0.4)
    r.spans = spans[2:]
    assert metric("lm.moe_share")(r) is None


def stats(rows):
    buf = torch.tensor(rows, dtype=torch.int32)
    return types.SimpleNamespace(rows=lambda lo, hi: buf[lo:hi])


@pytest.mark.parametrize("speed", [1.0, 0.5])
def test_grouped_roofline_is_the_least_time_over_the_kernels_time(speed):
    c = cfg_small()
    calls = [(0, 8, 3, 1), (1, 1, 5, 2), (2, 4, 2, 4)]  # call, tokens, experts
    spans, ops, t = [], [], 1.0
    for call, tokens, experts, _ in calls:
        least = counts.roofline_seconds(
            moe_counts.grouped_products(experts, tokens, c), peaks.H100)
        spans.append(span("moe", t, t + 0.01, layer=0, tokens=tokens,
                          call=call))
        for k in range(3):  # each product: a prepare and a GEMM launch
            ops.append(DeviceOp(PREP, 0.0, 0.0, t + 0.001 * k))
            ops.append(DeviceOp(GEMM, 0.0, least / 3 / speed,
                                t + 0.001 * k + 0.0005))
        t += 0.1
    # a span that lost one GEMM's record is left out
    spans.append(span("moe", t, t + 0.01, layer=0, tokens=8, call=3))
    ops.append(DeviceOp(GEMM, 0.0, 1.0, t + 0.001))
    ops.append(DeviceOp("other", 0.0, 0.0, 5.0))
    system = types.SimpleNamespace(moe_stats=stats(
        [[e, m] for _, _, e, m in calls] + [[1, 1]]))
    r = readings(spans=spans, ops=ops, trace_window=(0.5, 6.0), system=system)
    got = metric("moe_grouped_roofline")(r)
    assert got == pytest.approx(100.0 * speed)
    assert got <= 100.0 + 1e-9
    r.system = types.SimpleNamespace(moe_stats=None)
    assert metric("moe_grouped_roofline")(r) is None


@pytest.mark.parametrize("speed", [1.0, 0.25])
def test_window_roofline_reads_each_layer_at_its_window(speed):
    c = cfg_small()
    lens = np.array([3, 12], dtype=np.int32)
    ops = []
    for j in range(2):  # 2 decode steps x 4 layers, at speed x the bound
        for i, w in enumerate(moe_counts.windows(c)):
            least = counts.roofline_seconds(
                moe_counts.flash_decode_window(lens + j + 1, w, c, 4),
                peaks.H100)
            ops.append(DeviceOp("flash_decode_kernel<128, 8, false>", 0.0,
                                least / speed, 1.0 + 0.1 * (4 * j + i)))
    ops += [DeviceOp("flash_decode_kernel<128, 8, false>", 0, 1.0, 3.0)]
    steps = [(1.0, 2.0, 2, lens), (3.0, 4.0, 2, lens)]  # the second lost 7
    r = readings(steps=steps, ops=ops, trace_window=(0.5, 8.0))
    got = metric("flash_decode_window_roofline")(r)
    assert got == pytest.approx(100.0 * speed)
    assert got <= 100.0 + 1e-9
    # the full-context count reads the sliding layers' rows too long
    assert metric("flash_decode_window_roofline")(
        readings(steps=steps, ops=ops, trace_window=(0.5, 8.0),
                 peaks=None)) is None


def test_mfu_counts_each_layers_context_by_hand():
    c = cfg_small()
    rows = book(prompt_len=[3, 8], iterations=[2, 4], step_first=[0, 0],
                step_retire=[0, 0])
    r = readings(all_rows=rows)
    r.window.decodes, r.window.window_steps = np.array([5]), (0, 0)
    M = moe_counts.position_flops(c)
    head = 2 * 8 * 10
    flops = 0.0
    for P, n in ((3, 2), (8, 4)):
        positions = list(range(P - 1)) + [P - 1 + t for t in range(n)]
        flops += len(positions) * M + n * head
        for p in positions:
            for w in moe_counts.windows(c):
                keys = p + 1 if w is None else min(p + 1, w)
                flops += 4 * 4 * 2 * keys
    got = metric("lm.mfu.moe")(r)
    assert got == pytest.approx(100.0 * flops / (10.0 * 989e12))


CHECK = r"""
import json, sys
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]
import perfbench.reference.mellum
print(json.dumps(sorted(sys.modules)))
"""


def test_the_mellum_reference_loads_neither_jax_nor_the_port():
    out = subprocess.run([sys.executable, "-c", CHECK, str(ROOT)],
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    tops = {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}
    assert "perfbench" in tops and "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_the_cells_entries_are_new_and_the_config_holds_the_catalogs():
    bench = spec.load_benchmark()
    cell = spec.cell(NAME, bench)
    names = {m["name"] for m in cell.per_layer}
    assert {"lm.moe_share", "moe_grouped_roofline",
            "flash_decode_window_roofline", "lm.mfu.moe"} <= names
    assert not names & {"flash_decode_roofline", "lm.mfu.token"}
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "tokens_per_s"}
    c = cell.config
    assert c["num_hidden_layers"] == 28 and c["num_experts"] == 64
    assert c["layer_types"] == (["sliding_attention"] * 3
                                + ["full_attention"]) * 7
    assert c["max_position_embeddings"] == 4096 and c["max_num_seqs"] == 32


# ---------------------------------------------------------------------------
# The cell at a CPU's size
# ---------------------------------------------------------------------------

# Widths cut to a CPU's size but the router's as published (64 experts,
# top 8), a window of 20 positions (not a multiple of the block of 8) and
# YaRN over 64 original positions; the cell's traffic cut to match.
SMOKE = dict(num_hidden_layers=4, hidden_size=128, num_attention_heads=4,
             num_key_value_heads=2, head_dim=32, moe_intermediate_size=32,
             vocab_size=512, sliding_window=20, max_num_seqs=8,
             max_position_embeddings=112,
             layer_types=["sliding_attention"] * 3 + ["full_attention"],
             mlp_layer_types=["sparse"] * 4)
SMALL = dict(clients=8, warm_retired=8, pool=64,
             prompt_len={"median": 16, "sigma": 0.8, "min": 4, "max": 40},
             new_tokens={"median": 16, "sigma": 0.5, "min": 8, "max": 40},
             block_size=8, prefill_chunk=16, sample=24, sample_slowest=4)


def mellum_cell() -> spec.Cell:
    cell = spec.cell(NAME)
    cell.config.update(SMOKE)
    rope = dict(cell.config["rope_parameters"])
    rope["full_attention"] = {**rope["full_attention"],
                              "original_max_position_embeddings": 64}
    cell.config["rope_parameters"] = rope
    cell.traffic.update(SMALL)
    return cell


def test_the_systems_port_model_is_the_reference():
    """The system's weights through the port's full-sequence forward, fp32,
    against the reference at 1e-5 of each row's largest |logit|."""
    from repro_torch.nn import transformer as T

    cell = mellum_cell()
    cell.config["dtype"] = "float32"
    mod = spec.load_module("systems", cell.config["system"])
    system = mod.System(cell.config, cell.traffic, SEED, torch.device("cpu"))
    model = mod.port_model(cell.config, system.weights)
    assert model.blocks[0]["moe"]["gate"].data_ptr() == \
        system.weights["blocks"][0]["gate"].data_ptr()
    want = {n: (tuple(p.shape), p.dtype) for n, p in
            T.abstract_init(system.model_cfg).named_parameters()}
    assert {n: (tuple(p.shape), torch.float32)
            for n, p in model.named_parameters()} == \
        {n: (s, torch.float32) for n, (s, _) in want.items()}
    tokens = torch.as_tensor(system.tokens[:60])
    got, _ = T.forward(model, system.model_cfg, tokens[None])
    with torch.no_grad():
        h = ref.hidden(system.weights, cell.config, [tokens])[0]
    lg = h @ system.weights["head"].float()
    scale = lg.abs().amax(-1, keepdim=True)
    assert ((got[0] - lg).abs() / scale).max() < 1e-5


def test_the_dropping_fault_drops_past_its_capacity():
    cell = mellum_cell()
    mod = spec.load_module("systems", cell.config["system"])
    system = mod.System(cell.config, cell.traffic, SEED, torch.device("cpu"))
    top_e = torch.zeros(700, 2, dtype=torch.int64)
    top_e[:, 1] = torch.arange(700) % 7 + 1
    groups = torch.arange(700) // ref.DROP_GROUP
    kept = ref.kept(top_e, groups, 8, 160)
    # expert 0 takes the first 160 of each group's tokens, the rest drop
    assert kept[:, 0].tolist() == [True] * 160 + [False] * 352 \
        + [True] * 160 + [False] * 28
    assert kept[:, 1].all()
    tokens = torch.as_tensor(system.tokens[:1100])
    with torch.no_grad():
        a = ref.hidden(system.weights, cell.config, [tokens])[0]
        b = ref.hidden(system.weights, cell.config, [tokens],
                       fault="drop_1.25")[0]
    assert torch.equal(a[:1], b[:1]) and not torch.allclose(a, b)


def run(trace=False, seconds=2.0) -> dict:
    return harness.run_cell(mellum_cell(), SEED, seconds, trace,
                            device="cpu", patience_s=10.0)


def test_a_rehearsal_of_the_cell_is_correct():
    res = run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"setup_s", "tokens_per_s"}
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == {"unanswered", "truncated", "margin_p99",
                                  "kv_pool_off_type"}


def test_a_traced_rehearsal_reads_the_lm_layer_and_the_moe_spans():
    res = run(trace=True)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    for name in ("lm.ttft_p95_ms", "lm.tpot_ms", "lm.prefill_share",
                 "lm.decode_ms"):
        assert got[name]["value"] > 0, name
    # device readers find nothing to read on the CPU and stay silent
    for name in ("lm.moe_share", "moe_grouped_roofline",
                 "flash_decode_window_roofline", "lm.mfu.moe",
                 "device.idle.token"):
        assert name not in got


@pytest.fixture(scope="module")
def window():
    cell = mellum_cell()
    system, win, _ = harness.measure(cell, SEED, 2.0, False, device="cpu",
                                     patience_s=10.0)
    return cell, system, win


def test_the_program_passes_where_the_control_fails(window):
    cell, system, win = window
    limits = cell.config["limits"]
    sound, _ = harness.judged(cell, system, win, SEED)
    assert judge.passed(judge.checks(sound, limits)), sound
    ctrl, _ = harness.judged(cell, system, win, SEED,
                             fmt=cell.config["control"])
    assert not judge.passed(judge.checks(ctrl, limits)), ctrl


@pytest.mark.parametrize("fault", [f for f in ref.FAULTS
                                   if f != "drop_1.25"])
def test_each_planted_fault_fails(window, fault):
    """(The dropping MoE drops nothing at these prompts' lengths: a group
    of 512 positions is needed; above, and on the card.)"""
    cell, system, win = window
    got, _ = harness.judged(cell, system, win, SEED,
                            overrides={"fault": fault})
    assert not judge.passed(judge.checks(got, cell.config["limits"])), got


def window_off(monkeypatch):
    """The program's sliding layers attend to every earlier position."""
    from repro_torch.nn import layers as L
    from repro_torch.nn import transformer as T

    real = T.ModelConfig.attn_cfg

    def attn_cfg(self, causal=True, layer=0):
        acfg = real(self, causal, layer)
        return L.AttnConfig(**{**acfg.__dict__, "window": None})
    monkeypatch.setattr(T.ModelConfig, "attn_cfg", attn_cfg)


def expert_zeroed(monkeypatch):
    """Expert 0's output left out: its rows of every down projection 0."""
    from repro_torch.nn import moe as Moe

    real = Moe.grouped_mm

    def grouped_mm(x, w, offs):
        out = real(x, w, offs)
        if w.shape[-1] != x.shape[-1] or w.shape[1] == x.shape[-1]:
            rows = torch.arange(out.shape[0])[:, None] < offs[0]
            out = torch.where(rows, torch.zeros((), dtype=out.dtype), out)
        return out
    monkeypatch.setattr(Moe, "grouped_mm", grouped_mm)


@pytest.mark.parametrize("fault", [window_off, expert_zeroed])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res = run()
    assert not res["correct"], res["checks"]
    chk = res["checks"]
    assert chk["margin_p99"]["value"] > chk["margin_p99"]["limit"], chk
