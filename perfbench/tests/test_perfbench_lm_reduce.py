"""The language-model cell's arithmetic against hand counts: flash_decode's
bytes, the window's FLOPs and tokens, and each reader of ``metrics/`` on made-up
records, spans and device operations; and a reference that loads neither
JAX nor the port."""
import json
import subprocess
import sys
import types

import numpy as np
import pytest

from perfbench.tests.common import ROOT
from perfbench.bench import counts, lm_counts, peaks, spec
from perfbench.bench.trace import DeviceOp

CFG = {"n_layers": 2, "d_model": 8, "n_heads": 4, "n_kv_heads": 2,
       "head_dim": 2, "d_ff": 16, "vocab": 10, "kv_cache_dtype": "bf16"}


def span(name, t0, t1, **args):
    return types.SimpleNamespace(name=name, t0=t0, t1=t1, args=args)


def book(**cols):
    n = len(next(iter(cols.values())))
    cols = {k: np.asarray(v) for k, v in cols.items()}
    cols.setdefault("i", np.arange(n))
    return types.SimpleNamespace(view=lambda rows=None: cols, n=n)


def readings(records=None, all_rows=None, **kw):
    """A stand-in for ``harness.Readings`` over a window [0, 10]."""
    win = types.SimpleNamespace(t0=0.0, t1=10.0, seconds=10.0,
                                book=all_rows, steps=kw.pop("steps", None))
    cell = types.SimpleNamespace(config=CFG, traffic={"block_size": 16})
    base = dict(window=win, spans=[], ops=[], trace_window=None,
                peaks=peaks.H100, cell=cell, records=records)
    base.update(kw)
    r = types.SimpleNamespace(**base)
    r.within = lambda spans, lo=None, hi=None: [
        s for s in spans if s.t0 >= (win.t0 if lo is None else lo)
        and s.t1 <= (win.t1 if hi is None else hi)]
    return r


def test_flash_decode_bytes_by_hand():
    # starcoder2-3b's shape: 2 KV heads of 128, 12 query heads each, bf16;
    # two live rows at 17 and 1 positions (the new token's included)
    c = lm_counts.flash_decode([17, 1], 2, 12, 128, False, 16)
    kv = 2 * 2 * 128 * 2 * (17 + 1)  # K and V, 2 heads x 128 bf16 a position
    table = 4 * (2 + 1)  # 17 positions span 2 blocks of 16, 1 spans 1
    lens = 4 * 2
    q_out = 2 * 4 * 24 * 128 * 2  # fp32 q in and out, 24 heads, 2 rows
    assert c["bytes"] == kv + table + lens + q_out == 67604
    assert c["flops"] == 4 * 24 * 128 * 18
    t = counts.roofline_seconds(c, peaks.H100)
    assert t == pytest.approx(c["bytes"] / 3.35e12)  # bound by bytes
    # an int8 pool: 1 byte an element and one fp32 scale a position and head
    q8 = lm_counts.flash_decode([17, 1], 2, 12, 128, True, 16)
    assert q8["bytes"] == 2 * 2 * (128 + 4) * 18 + table + lens + q_out


def test_request_flops_by_hand():
    # per layer: q 8x8, k and v 8x4, o 8x8, up 8x16, down 16x8 = 448 weights
    assert lm_counts.matrix_params(CFG) == 2 * 448
    # a prompt of 3 and 2 output tokens, admitted and retired in the
    # window's one step: 4 positions fed, 2 logits sampled, attention over
    # 1 + 2 + 3 + 4 keys, 4 x 4 heads x 2 a key, 2 layers
    want = 2 * 4 * 896 + 2 * 2 * 8 * 10 + 4 * 2 * 4 * 2 * 10
    assert lm_counts.window_flops(CFG, [5], [0], [0], [3], [2], 0, 0) == want
    # admitted in step 0, its second token produced in step 1, the window's
    # only step: one position (context 4 keys), one logit
    want = 2 * 896 + 2 * 8 * 10 + 4 * 2 * 4 * 2 * 4
    assert lm_counts.window_flops(CFG, [1, 5], [0], [1], [3], [2], 1, 1) == want


def test_tokens_per_s_counts_the_tokens_each_window_step_produced():
    # steps 2 and 3 are the window's; step 3's burst ran 5 decode steps
    decodes = [15, 15, 15, 5, 15, 15, 15, 15]
    rows = book(step_first=[0, 1, 3, 0, 4], step_retire=[2, 7, 5, 1, 6],
                iterations=[40, 100, 32, 20, 30],
                prompt_len=[100, 200, 300, 400, 500])
    # 10 (the first request's last 10 of 40; the burst's 5 more are
    # overshoot), 15 + 5, 5; none of the request retired before the window
    # or admitted after it
    assert lm_counts.tokens_in_steps(decodes, [0, 1, 3, 0, 4], [2, 7, 5, 1, 6],
                                     [40, 100, 32, 20, 30], 2, 3) == 35
    # and the prompt of the one request admitted in the window, 300
    assert lm_counts.prompt_tokens_in_steps([0, 1, 3, 0, 4],
                                            [100, 200, 300, 400, 500],
                                            2, 3) == 300
    r = readings(all_rows=rows)
    r.window.decodes, r.window.window_steps = np.array(decodes), (2, 3)
    assert spec.load_module("metrics", "tokens_per_s").read(r) == 33.5


def test_time_to_first_token_and_per_output_token():
    rows = book(t_submit=[-1.0, 2.0, 4.0, 9.5], t_first=[0.5, 2.5, 5.0, 10.5],
                t_retire=[3.0, 4.5, 9.0, 12.0], iterations=[6, 5, 3, 4],
                step_first=[0, 1, 2, 4], step_retire=[1, 1, 3, 5])
    rec = {k: v[:3] for k, v in rows.view().items()}  # retired in the window
    r = readings(records=rec, all_rows=rows)
    r.window.decodes = np.full(6, 2)
    # submitted and admitted inside the window: 0.5 and 1.0 s to the first
    # token (the last request's first token came after the close)
    got = spec.load_module("metrics", "lm.ttft_p95_ms").read(r)
    assert got == pytest.approx(np.percentile([500.0, 1000.0], 95))
    # (retire - first step's end) / tokens after the first step's 2, over
    # the requests retired in a later step: 2.5 / 4 and 4.0 / 1 s
    assert spec.load_module("metrics", "lm.tpot_ms").read(r) == \
        pytest.approx(1e3 * (0.625 + 4.0) / 2)


def test_prefill_share_and_decode_step_from_spans():
    spans = [span("prefill-chunk", 1, 2), span("prefill-chunk", 1.5, 2.5),
             span("decode-burst", 3, 4, decodes=10),
             span("decode-burst", 5, 5.5, decodes=5),
             span("decode-burst", 9, 11, decodes=15)]  # past the window
    r = readings(spans=spans)
    assert spec.load_module("metrics", "lm.prefill_share").read(r) == \
        pytest.approx(15.0)
    assert spec.load_module("metrics", "lm.decode_ms").read(r) == \
        pytest.approx(1e3 * 1.5 / 15)
    assert spec.load_module("metrics", "lm.decode_ms").read(readings()) is None


def test_flash_decode_roofline_over_whole_steps():
    lens = np.array([16, 40], dtype=np.int32)
    one = [lm_counts.flash_decode(lens + j + 1, 2, 2, 2, False, 16)
           for j in range(2)]
    least = sum(counts.roofline_seconds(c, peaks.H100) for c in one)
    # step 1: 2 decodes x 2 layers, each launch 2x its least time in total;
    # step 2 lost a launch record and is left out; step 3 ends past the trace
    ops = [DeviceOp("flash_decode_wide_kernel<128, false>", 0, least, 1.0 + 0.1 * k)
           for k in range(4)]
    ops += [DeviceOp("flash_decode_wide_kernel<128, false>", 0, 1.0, 3.0 + 0.1 * k)
            for k in range(3)]
    ops += [DeviceOp("other", 0, 1.0, 8.5)]
    steps = [(1.0, 2.0, 2, lens), (3.0, 4.0, 2, lens), (7.0, 9.0, 2, lens)]
    r = readings(steps=steps, ops=ops, trace_window=(0.5, 8.6))
    got = spec.load_module("metrics", "flash_decode_roofline").read(r)
    assert got == pytest.approx(50.0)
    r.peaks = None
    assert spec.load_module("metrics", "flash_decode_roofline").read(r) is None


def test_lm_mfu_by_hand():
    rows = book(prompt_len=[3, 5], iterations=[2, 4], step_first=[0, 0],
                step_retire=[0, 0])
    r = readings(all_rows=rows)
    r.window.decodes, r.window.window_steps = np.array([5]), (0, 0)
    # 4 and 8 positions through 2 x 896 weights, 2 and 4 logits of 8 x 10,
    # attention over 10 and 36 keys at 4 x 4 heads x 2 a key and layer
    flops = (12 * 2 * 896 + 6 * 2 * 8 * 10 + 46 * 4 * 2 * 4 * 2)
    got = spec.load_module("metrics", "lm.mfu.token").read(r)
    assert got == pytest.approx(100.0 * flops / (10.0 * 989e12))


CHECK = r"""
import json, sys
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]
import perfbench.reference.lm
print(json.dumps(sorted(sys.modules)))
"""


def test_the_lm_reference_loads_neither_jax_nor_the_port():
    out = subprocess.run([sys.executable, "-c", CHECK, str(ROOT)],
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    tops = {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}
    assert "perfbench" in tops and "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
