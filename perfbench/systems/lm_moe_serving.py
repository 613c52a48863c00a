"""Language-model serving of a sliding-window, dropless-MoE decoder
(Mellum2-12B-A2.5B): one token prompt a request, answered with its greedy
continuation by the port's ``LMEngine`` over the paged KV pool, chunked
prefill, windowed ``flash_decode`` and the grouped expert products.

As ``lm_serving`` (whose ``lengths``, ``stratified``, requests, records and
:meth:`~perfbench.systems.lm_serving.System.compare` this reuses), for a
configuration file that holds the published ``config.json``'s keys:
``hidden_size``, ``layer_types``, ``rope_parameters``, ``num_experts``,
... .  The engine serves ``max_num_seqs`` slots of
``max_position_embeddings`` positions each, and the traffic's block size
and prefill chunk.

Inputs from the seed: the weights, drawn on the device in the type they
are served in (one bf16 draw for every matrix, embedding and head, scaled
by ``d_in ** -0.5``: ``hidden_size`` for the embedding, head, q, k, v,
router and the experts' gate and up, ``heads x head_dim`` for o,
``moe_intermediate_size`` for the experts' down; one float32 draw for the
RMSNorms, scale ``1 + 0.1 z``), and the requests as ``lm_serving`` draws
them.  The plain reference is ``reference/mellum.py``.

The port's configuration is built before any weight is drawn, so that a
program without these features fails at once.  ``moe_stats`` keeps the
engine's device record of its MoE calls (``ServeEngine.moe_stats``) for
the readers of a traced run.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.bench import inputs
from perfbench.reference import mellum as ref
from perfbench.systems import lm_serving

KINDS = {"sliding_attention": "sliding", "full_attention": "full"}


def model_config(c: dict):
    """The port's ``ModelConfig`` of configuration ``c``; raises where the
    port's fixed parts (RMSNorm eps 1e-6, normalised top-k, every MLP
    sparse, plain RoPE in sliding layers at the full layers' theta) differ
    from the file."""
    from repro_torch.nn.layers import YaRN
    from repro_torch.nn.moe import MoEConfig
    from repro_torch.nn.transformer import ModelConfig

    full = c["rope_parameters"]["full_attention"]
    sliding = c["rope_parameters"]["sliding_attention"]
    if (c["rms_norm_eps"] != 1e-6 or not c["norm_topk_prob"]
            or set(c["mlp_layer_types"]) != {"sparse"}
            or sliding.get("rope_type", "default") != "default"
            or sliding["rope_theta"] != full["rope_theta"]
            or full["rope_type"] != "yarn" or c["attention_bias"]):
        raise ValueError(f"{c['name']}: a part the port fixes differs")
    d, f = c["hidden_size"], c["moe_intermediate_size"]
    return ModelConfig(
        name=c["name"], n_layers=c["num_hidden_layers"], d_model=d,
        n_heads=c["num_attention_heads"], n_kv_heads=c["num_key_value_heads"],
        d_ff=f, vocab=c["vocab_size"], head_dim=c["head_dim"],
        block_pattern=("attn_moe",), norm="rmsnorm",
        rope_theta=float(full["rope_theta"]),
        tie_embeddings=c["tie_word_embeddings"],
        kv_cache_dtype=c["kv_cache_dtype"],
        activ_dtype=getattr(torch, c["dtype"]), remat=False,
        attn_pattern=tuple(KINDS[t] for t in c["layer_types"]),
        sliding_window=c["sliding_window"],
        yarn=YaRN(float(full["factor"]),
                  full["original_max_position_embeddings"],
                  float(full["beta_fast"]), float(full["beta_slow"]),
                  full["attention_factor"]),
        moe=MoEConfig(d_model=d, d_ff=f, num_experts=c["num_experts"],
                      top_k=c["num_experts_per_tok"]), moe_dropless=True)


def layout(c: dict) -> list:
    """``(path, shape, dtype, scale)`` of every weight, in the order they
    are drawn, each scale's leaves together: the ``hidden_size ** -0.5``
    bf16 leaves, then o, then the experts' down, then the float32 norms."""
    d, f, V = c["hidden_size"], c["moe_intermediate_size"], c["vocab_size"]
    H, G, dh = (c["num_attention_heads"], c["num_key_value_heads"],
                c["head_dim"])
    E = c["num_experts"]
    bf = getattr(torch, c["dtype"])
    a, o, b = d ** -0.5, (H * dh) ** -0.5, f ** -0.5
    wide = [(("embed",), (V, d), bf, a), (("head",), (d, V), bf, a)]
    outs, down, norms = [], [], []
    for i in range(c["num_hidden_layers"]):
        blk = ("blocks", i)
        wide += [(blk + ("q_w",), (d, H * dh), bf, a),
                 (blk + ("k_w",), (d, G * dh), bf, a),
                 (blk + ("v_w",), (d, G * dh), bf, a),
                 (blk + ("router",), (d, E), bf, a),
                 (blk + ("gate",), (E, d, f), bf, a),
                 (blk + ("up",), (E, d, f), bf, a)]
        outs.append((blk + ("o_w",), (H * dh, d), bf, o))
        down.append((blk + ("down",), (E, f, d), bf, b))
        norms += [(blk + (n,), (d,), torch.float32, None)
                  for n in ("norm1", "norm2")]
    norms.append((("final_norm",), (d,), torch.float32, None))
    return wide + outs + down + norms


def make_weights(c: dict, seed: int, device) -> dict:
    """The benchmark's weights of configuration ``c``: ``{"embed", "head",
    "final_norm", "blocks": [{"norm1", "q_w", "k_w", "v_w", "o_w",
    "norm2", "router", "gate", "up", "down"}]}``, views into one buffer of
    each type, each drawn in one call."""
    gen = inputs.device_generator(seed, 0x6D656C6C, device)
    leaves = layout(c)
    sizes: dict = {}
    for _, shape, dt, _ in leaves:
        sizes[dt] = sizes.get(dt, 0) + int(np.prod(shape))
    flat = {dt: torch.randn(n, generator=gen, dtype=dt, device=device)
            for dt, n in sizes.items()}
    out: dict = {"blocks": [{} for _ in range(c["num_hidden_layers"])]}
    offset = {dt: 0 for dt in flat}
    for path, shape, dt, scale in leaves:
        n, at = int(np.prod(shape)), offset[dt]
        offset[dt] = at + n
        view = flat[dt][at:at + n].view(shape)
        if scale is not None:
            view.mul_(scale)
        else:
            view.mul_(0.1).add_(1.0)
        node = out
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = view
    return out


def port_model(c: dict, w: dict, cfg=None):
    """The port's ``LM`` over the benchmark's weights (its parameters are
    the same tensors, not copies)."""
    from repro_torch.nn import transformer as T

    blocks = [{"ln1": {"scale": b["norm1"]},
               "attn": {n: {"w": b[f"{n}_w"]} for n in ("q", "k", "v", "o")},
               "ln2": {"scale": b["norm2"]},
               "moe": {n: b[n] for n in ("router", "gate", "up", "down")}}
              for b in w["blocks"]]
    return T.LM(cfg or model_config(c), w["embed"], blocks,
                {"scale": w["final_norm"]},
                None if c["tie_word_embeddings"] else w["head"])


class System(lm_serving.System):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.model_cfg = model_config(config)  # before the weights
        self.weights = make_weights(config, seed, device)
        n = int(traffic["pool"])
        rng = np.random.default_rng(inputs.stream_seed(seed, 0x6C656E73))
        k = int(traffic["strata"])
        self.prompt_lens = lm_serving.stratified(
            rng, lm_serving.lengths(traffic["prompt_len"], n), k)
        self.new_tokens = lm_serving.stratified(
            rng, lm_serving.lengths(traffic["new_tokens"], n), k)
        self.starts = np.concatenate([[0], np.cumsum(self.prompt_lens)])
        self.tokens = rng.integers(0, config["vocab_size"],
                                   int(self.starts[-1]), dtype=np.int64)
        self.short_total = 0  # requests retired short of max_new_tokens
        self.pool_dtype = None  # the type of the KV pool the program served
        self.moe_stats = None  # the engine's MoE record (ServeEngine)

    def engine(self, obs):
        """The port's ``LMEngine`` over the weights, as the cell serves it;
        raises where a request of the mix could outgrow a slot's KV
        capacity (prompt, outputs and a decode burst's overshoot)."""
        from repro_torch.lm.paging import PagedConfig
        from repro_torch.runtime.lm import LMEngine

        c, t = self.config, self.traffic
        eng = LMEngine(self.model_cfg,
                       port_model(c, self.weights, self.model_cfg),
                       slots=int(c["max_num_seqs"]),
                       max_len=int(c["max_position_embeddings"]),
                       paged=PagedConfig(
                           block_size=int(t["block_size"]),
                           prefill_chunk=int(t["prefill_chunk"])),
                       obs=obs, device=self.device)
        need = t["prompt_len"]["max"] + t["new_tokens"]["max"] \
            + eng.decode_per_step - 2
        if need > eng.serve.slot_capacity:
            raise ValueError(f"max_len {c['max_position_embeddings']}: a "
                             f"request may need {need} KV positions, a slot "
                             f"holds {eng.serve.slot_capacity}")
        self.moe_stats = eng.serve.moe_stats
        return eng

    def _logits(self, sample: dict, fmt: str | None = None,
                fault: str | None = None) -> dict:
        """``{row: logits [n_out, V]}`` of the sampled requests with output
        tokens: the reference fed each one's prompt and the program's own
        outputs, at the positions that predicted them."""
        rows = [j for j, n in enumerate(sample["iterations"]) if n]
        prompts = [torch.as_tensor(self.request(int(sample["i"][j]))[0],
                                   device=self.device) for j in rows]
        outs = [torch.as_tensor(sample["tokens"][j, :sample["iterations"][j]]
                                .astype(np.int64), device=self.device)
                for j in rows]
        return dict(zip(rows, ref.output_logits(self.weights, self.config,
                                                prompts, outs, fmt=fmt,
                                                fault=fault)))

    def compare(self, prog: dict, drawn) -> tuple:
        """:meth:`lm_serving.System.compare`'s numbers, and the 99th and
        99.9th percentiles of the margins beside their largest
        (``token_margin``): a router's near-tie at the eighth expert,
        flipped by bf16's rounding, moves a few positions' logits (PERF.md
        §2)."""
        values, diag = super().compare(prog, drawn)
        values["margin_p99"] = diag["margin_p99"]
        values["margin_p999"] = diag["margin_p999"]
        return values, diag
