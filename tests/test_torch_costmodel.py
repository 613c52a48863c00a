"""The port's analytic cost model and roofline (``repro_torch.launch.
{costmodel,roofline}``, ``repro_torch.compat.cost_analysis``).

  * ``forward_flops`` and ``step_cost`` bit-equal to the reference's for
    every architecture x shape x kind;
  * ``roofline_terms``' verdicts on the reference test's two cases, priced
    at the H100's data-sheet rates;
  * the eager counterpart of the reference's
    ``test_cost_analysis_counts_while_body_once``: eager counting sees
    every loop iteration, so 16 steps count 4x 4 steps;
  * ``forward_flops`` against ``cost_analysis`` of the port's ``forward``
    on every smoke config, exactly, once the terms the two count
    differently are accounted for, per block kind (see ``_difference``).
"""
import dataclasses

import pytest
import torch

from repro.configs.common import SHAPES as RSHAPES
from repro.configs.registry import ARCHS as RARCHS
from repro.launch import costmodel as RCM
from repro.nn import transformer as RT
from repro_torch.compat import cost_analysis
from repro_torch.configs.common import SHAPES
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import costmodel as CM
from repro_torch.launch import mesh as M
from repro_torch.launch import roofline as R
from repro_torch.launch.train import batch_extras
from repro_torch.nn import transformer as T


@pytest.mark.parametrize("arch_id", sorted(ARCHS))
def test_forward_flops_and_step_cost_are_the_references(arch_id):
    assert SHAPES == RSHAPES
    for which in ("full", "smoke"):
        cfg = getattr(ARCHS[arch_id], which)()
        rcfg = getattr(RARCHS[arch_id], which)()
        n = RT.count_params_cfg(rcfg)[0]
        for shape in SHAPES.values():
            B, S, kind = shape["batch"], shape["seq"], shape["kind"]
            decode = kind == "decode"
            args = (B, 1, S) if decode else (B, S)
            assert CM.forward_flops(cfg, *args, decode=decode) == \
                RCM.forward_flops(rcfg, *args, decode=decode)
            for pb in (2, 4):
                got = CM.step_cost(cfg, n, kind, B, S, param_bytes=pb)
                want = RCM.step_cost(rcfg, n, kind, B, S, param_bytes=pb)
                assert (got.flops, got.hbm_bytes) == \
                    (want.flops, want.hbm_bytes)
        kv8 = CM.step_cost(dataclasses.replace(cfg, kv_cache_dtype="int8"),
                           n, "decode", 8, 512)
        want = RCM.step_cost(dataclasses.replace(rcfg, kv_cache_dtype="int8"),
                             n, "decode", 8, 512)
        assert (kv8.flops, kv8.hbm_bytes) == (want.flops, want.hbm_bytes)


def test_roofline_terms_bottleneck_on_the_h100():
    assert (M.PEAK_FLOPS_BF16, M.HBM_BW, M.NVLINK_BW) == (989e12, 3.35e12,
                                                          450e9)
    t = R.roofline_terms(flops=1e18, bytes_hbm=1e12, coll_bytes=1e12, chips=256)
    assert t["bottleneck"] == "compute"
    assert t["compute_s"] == 1e18 / (256 * 989e12)
    assert t["roofline_fraction_compute"] == 1.0
    t = R.roofline_terms(flops=1e12, bytes_hbm=1e15, coll_bytes=1e12, chips=256)
    assert t["bottleneck"] == "memory"
    assert t["memory_s"] == 1e15 / (256 * 3.35e12)
    t = R.roofline_terms(flops=1e12, bytes_hbm=1e12, coll_bytes=1e15, chips=8)
    assert t["bottleneck"] == "collective"
    assert t["collective_s"] == 1e15 / (8 * 450e9)


def test_model_flops_and_summary():
    mf = R.model_flops(100, 40, 1000, "train")
    assert mf == {"model_flops_6nd": 6.0e5, "model_flops_active": 2.4e5,
                  "factor": 6.0}
    assert R.model_flops(100, 40, 10, "decode")["model_flops_active"] == 800.0
    cell = {"arch": "a", "shape": "s", "mesh": "16x16", "useful_frac": 0.5,
            "terms": R.roofline_terms(1e15, 1e12, 0.0, 1)}
    assert "-> compute" in R.summarize(cell)


def test_cost_analysis_counts_every_loop_iteration():
    """The reference's XLA cost analysis reports the same FLOPs for 4 and
    16 scan steps; an eager count sees every step."""
    def make(n):
        def f(x, w):
            for _ in range(n):
                x = torch.tanh(x @ w)
            return x
        return f

    x, w = torch.ones((64, 128)), torch.ones((128, 128))
    f4 = cost_analysis(make(4), x, w)
    f16 = cost_analysis(make(16), x, w)
    assert f4["flops"] == 4 * 2 * 64 * 128 * 128
    assert f16["flops"] == 4 * f4["flops"]
    assert f16["bytes accessed"] == 4 * f4["bytes accessed"] > 0


def _difference(cfg, B: int, S: int) -> float:
    """What the port's eager forward computes beyond ``forward_flops``
    (negative: less), per layer by block kind.  Everything else (every
    projection, the MLPs, the router, the sLSTM, the encoder, the head)
    agrees exactly.

      * attention: flash attention computes every causal block in full
        (the model counts half the S x S scores);
      * MoE: the experts run on E x capacity slots, dropped and empty ones
        included (the model counts S x K assignments);
      * Mamba: the depthwise conv and the scan's elementwise recurrence are
        not matmuls and count nothing (the model counts 2 d_conv and 8 N
        per channel and token); the read-out C h is a product (2 N);
      * mLSTM: the input and forget gates' projections (2 di H a token) and
        each step's products (q C and q . n: 2 dh^2 + 2 dh a head) against
        the model's 8 dh^2 a head;
      * cross-attention: K/V projected from the encoder's frames, not from
        the decoder's tokens, and the frames' keys padded to one 512 block.
    """
    d, H = cfg.d_model, cfg.n_heads
    dh = cfg.head_dim or d // H
    extra = 0.0
    for li in range(cfg.n_layers):
        kind = cfg.block_pattern[li % cfg.period]
        if kind.startswith("attn"):
            extra += 2 * B * S * S * H * dh
            if "cross" in kind:
                nf = cfg.encoder.n_frames
                xdh = d // H
                extra += 2 * 2 * B * (nf - S) * d * H * xdh
                extra += 2 * B * S * H * xdh * 2 * (512 - nf)
        if kind.startswith("mamba"):
            m = cfg.mamba
            extra += -2 * B * S * m.d_inner * m.d_conv \
                - 6 * B * S * m.d_inner * m.d_state
        if kind == "mlstm":
            x = cfg.xlstm
            extra += 4 * B * S * x.d_inner * x.n_heads \
                + 2 * B * S * x.n_heads * x.dh - 6 * B * S * x.n_heads * x.dh ** 2
        if kind.endswith("moe"):
            m = cfg.moe
            cap = int(max(1, round(S * m.top_k * m.capacity_factor
                                   / m.num_experts)))
            extra += 2 * B * m.num_experts * cap * d * m.d_ff * 3 \
                - 2 * B * S * d * m.d_ff * 3 * m.top_k
    return extra


@pytest.mark.parametrize("arch_id", sorted(ARCHS))
def test_forward_flops_against_the_eager_count(arch_id):
    B, S = 2, 32
    cfg = ARCHS[arch_id].smoke()
    model = T.init(cfg, 0, device="cpu")
    batch = batch_extras(cfg, {"tokens": torch.randint(
        0, cfg.vocab, (B, S), generator=torch.Generator().manual_seed(0))},
        torch.Generator().manual_seed(1))
    with torch.no_grad():
        ca = cost_analysis(T.forward, model, cfg, batch["tokens"],
                           positions=batch.get("positions"),
                           vision_embeds=batch.get("vision_embeds"),
                           encoder_frames=batch.get("encoder_frames"))
    want = CM.forward_flops(cfg, B, S) + _difference(cfg, B, S)
    assert ca["flops"] == want
    assert ca["bytes accessed"] > 0
