"""Language-model serving: one token prompt a request, answered with its
greedy continuation by the port's ``LMEngine`` over the paged KV pool
(``lm/paging.py``), chunked prefill and the ``flash_decode`` kernel.

The engine serves ``max_num_seqs`` slots of ``max_position_embeddings``
positions each, the configuration's, and the traffic's block size and
prefill chunk.

Inputs from the seed: the weights, drawn on the device in the type they
are served in (one bf16 draw for every matrix, embedding, head and bias,
scaled by ``d_model ** -0.5``, or ``d_ff ** -0.5`` for the MLP's down
projection; one float32 draw for the LayerNorms, scale ``1 + 0.1 z`` and
bias ``0.1 z``, so that a norm's bias matters), and a pool of
``traffic["pool"]`` requests: prompt lengths and output lengths are the
same quantiles of the mix's log-normal distributions (about a median,
clipped) for every seed, each list in an
order of the seed's in which every ``traffic["strata"]`` consecutive
requests hold one length of each of as many equal shares of the quantiles
(so that every stretch of the run offers the same mix), and the prompt's
tokens are uniform over the vocabulary.  Request i asks for pool entry
``i mod pool``, greedy, no end-of-sequence token, so that it runs to its
``max_new_tokens``.

The program's outcome of a request is its output tokens (trimmed by
``LMEngine`` to ``max_new_tokens``) and whether the KV capacity parked
it.  The plain reference (``reference/lm.py``) takes the same weights and
each sampled request's prompt plus the program's own output tokens, and
:meth:`System.compare` reads, at every output position, how far the
program's token lies below the reference's best; it also holds the KV pool
the program served from to the configuration's type.
"""
from __future__ import annotations

import time
from statistics import NormalDist

import numpy as np
import torch

from perfbench.bench import inputs
from perfbench.reference import lm as ref

KV_TYPES = {"bf16": "torch.bfloat16", "int8": "torch.int8"}
MODEL_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
              "head_dim", "qkv_bias", "rope_theta", "tie_embeddings",
              "kv_cache_dtype")


def model_config(c: dict):
    """The port's ``ModelConfig`` of configuration ``c``."""
    from repro_torch.nn.transformer import ModelConfig

    return ModelConfig(name=c["name"], norm=c["norm"], mlp_kind=c["mlp_kind"],
                       activ_dtype=getattr(torch, c["dtype"]), remat=False,
                       **{k: c[k] for k in MODEL_KEYS})


def lengths(dist: dict, n: int) -> np.ndarray:
    """``n`` lengths at the midpoint quantiles of log-normal ``dist``:
    ``median``, ``sigma`` (the log's standard deviation), clipped to
    ``[min, max]``."""
    k = (np.arange(n) + 0.5) / n
    z = np.array([NormalDist().inv_cdf(float(x)) for x in k])
    x = np.rint(dist["median"] * np.exp(dist["sigma"] * z))
    return np.clip(x, dist["min"], dist["max"]).astype(np.int64)


def stratified(rng, lengths: np.ndarray, strata: int) -> np.ndarray:
    """``lengths`` in an order of ``rng``'s in which each run of ``strata``
    consecutive entries holds one of each ``strata``-th share of them,
    sorted: share s is the s-th block of the sorted lengths."""
    shares = np.sort(lengths).reshape(strata, -1)
    shares = np.stack([rng.permutation(row) for row in shares], 1)
    return rng.permuted(shares, axis=1).reshape(-1)


def layout(c: dict) -> list:
    """``(path, shape, dtype, scale)`` of every weight, in the order they
    are drawn: bf16 leaves scaled by ``d_model ** -0.5``, then the down
    projections (``d_ff ** -0.5``), then the float32 LayerNorms."""
    d, f, V = c["d_model"], c["d_ff"], c["vocab"]
    H, G, dh = c["n_heads"], c["n_kv_heads"], c["head_dim"]
    a, b, bf = d ** -0.5, f ** -0.5, getattr(torch, c["dtype"])
    wide, down, norms = [(("embed",), (V, d), bf, a), (("head",), (d, V), bf, a)], [], []
    for i in range(c["n_layers"]):
        blk = ("blocks", i)
        for n, width in (("q", H * dh), ("k", G * dh), ("v", G * dh)):
            wide.append((blk + (f"{n}_w",), (d, width), bf, a))
            if c["qkv_bias"]:
                wide.append((blk + (f"{n}_b",), (width,), bf, a))
        wide.append((blk + ("o_w",), (H * dh, d), bf, a))
        if c["o_bias"]:
            wide.append((blk + ("o_b",), (d,), bf, a))
        wide.append((blk + ("up_w",), (d, f), bf, a))
        if c["mlp_bias"]:
            wide += [(blk + ("up_b",), (f,), bf, a), (blk + ("down_b",), (d,), bf, a)]
        down.append((blk + ("down_w",), (f, d), bf, b))
        norms += [(blk + (ln, k), (d,), torch.float32, None)
                  for ln in ("ln1", "ln2") for k in ("scale", "bias")]
    norms += [(("final_ln", k), (d,), torch.float32, None)
              for k in ("scale", "bias")]
    return wide + down + norms


def make_weights(c: dict, seed: int, device) -> dict:
    """The benchmark's weights of configuration ``c``: ``{"embed", "head",
    "final_ln": {"scale", "bias"}, "blocks": [{"ln1": {..}, "q_w", "q_b",
    ..., "down_b"}]}``, views into two buffers drawn in one call each."""
    gen = inputs.device_generator(seed, 0x776569, device)
    leaves = layout(c)
    bf = getattr(torch, c["dtype"])
    sizes = {dt: sum(int(np.prod(s)) for _, s, t, _ in leaves if t == dt)
             for dt in (bf, torch.float32)}
    flat = {dt: torch.randn(n, generator=gen, dtype=dt, device=device)
            for dt, n in sizes.items()}
    offset = {dt: 0 for dt in flat}
    out: dict = {"blocks": [{"ln1": {}, "ln2": {}}
                            for _ in range(c["n_layers"])], "final_ln": {}}
    runs: dict = {}  # (dtype, scale) -> [start, end) of its leaves
    for path, shape, dt, scale in leaves:
        n, o = int(np.prod(shape)), offset[dt]
        lo, _ = runs.get((dt, scale), (o, o))
        runs[(dt, scale)] = (lo, o + n)
        offset[dt] = o + n
        view = flat[dt][o:o + n].view(shape)
        node = out
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = view
    for (dt, scale), (lo, hi) in runs.items():
        if scale is not None:
            flat[dt][lo:hi].mul_(scale)
    flat[torch.float32].mul_(0.1)
    for ln in [b[k] for b in out["blocks"] for k in ("ln1", "ln2")] + [
            out["final_ln"]]:
        ln["scale"].add_(1.0)
    return out


def port_model(c: dict, w: dict):
    """The port's ``LM`` over the benchmark's weights (its parameters are
    the same tensors, not copies)."""
    from repro_torch.nn import transformer as T

    def ln(p):
        return {"scale": p["scale"], "bias": p["bias"]}

    def dense(blk, n):
        p = {"w": blk[f"{n}_w"]}
        if f"{n}_b" in blk:
            p["b"] = blk[f"{n}_b"]
        return p

    blocks = [{"ln1": ln(b["ln1"]),
               "attn": {n: dense(b, n) for n in ("q", "k", "v", "o")},
               "ln2": ln(b["ln2"]),
               "mlp": {n: dense(b, n) for n in ("up", "down")}}
              for b in w["blocks"]]
    return T.LM(model_config(c), w["embed"], blocks, ln(w["final_ln"]),
                None if c["tie_embeddings"] else w["head"])


class System:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.weights = make_weights(config, seed, device)
        n = int(traffic["pool"])
        rng = np.random.default_rng(inputs.stream_seed(seed, 0x6C656E73))
        k = int(traffic["strata"])
        self.prompt_lens = stratified(rng, lengths(traffic["prompt_len"], n), k)
        self.new_tokens = stratified(rng, lengths(traffic["new_tokens"], n), k)
        self.starts = np.concatenate([[0], np.cumsum(self.prompt_lens)])
        self.tokens = rng.integers(0, config["vocab"], int(self.starts[-1]),
                                   dtype=np.int64)
        self.short_total = 0  # requests retired short of max_new_tokens
        self.pool_dtype = None  # the type of the KV pool the program served

    def engine(self, obs):
        """The port's ``LMEngine`` over the weights, as the cell serves it;
        raises where a request of the mix could outgrow a slot's KV
        capacity (prompt, outputs and a decode burst's overshoot)."""
        from repro_torch.lm.paging import PagedConfig
        from repro_torch.runtime.lm import LMEngine

        c, t = self.config, self.traffic
        eng = LMEngine(model_config(c), port_model(c, self.weights),
                       slots=int(c["max_num_seqs"]),
                       max_len=int(c["max_position_embeddings"]),
                       paged=PagedConfig(block_size=int(t["block_size"]),
                                         prefill_chunk=int(t["prefill_chunk"])),
                       obs=obs, device=self.device)
        need = t["prompt_len"]["max"] + t["new_tokens"]["max"] \
            + eng.decode_per_step - 2
        if need > eng.serve.slot_capacity:
            raise ValueError(f"max_len {c['max_position_embeddings']}: a "
                             f"request may need "
                             f"{need} KV positions, a slot holds "
                             f"{eng.serve.slot_capacity}")
        return eng

    def request(self, i: int) -> tuple:
        """``(prompt tokens, max_new_tokens)`` of request ``i``."""
        j = i % len(self.prompt_lens)
        return (self.tokens[self.starts[j]:self.starts[j + 1]],
                int(self.new_tokens[j]))

    def fields(self) -> dict:
        width = int(self.traffic["new_tokens"]["max"])
        return {"prompt_len": ((), np.int32), "max_new": ((), np.int32),
                "iterations": ((), np.int32), "tokens": ((width,), np.int32),
                "truncated": ((), np.bool_), "t_first": ((), np.float64),
                "step_first": ((), np.int32), "step_retire": ((), np.int32)}

    def outcome(self, req) -> dict:
        """The program's outcome of a retired ``LMRequest``: ``iterations``
        is its output tokens' count, so the harness's sample takes the
        longest among its slowest."""
        toks = np.zeros(int(self.traffic["new_tokens"]["max"]), np.int32)
        toks[:len(req.tokens)] = req.tokens
        return {"prompt_len": len(req.prompt), "max_new": req.max_new_tokens,
                "iterations": len(req.tokens), "tokens": toks,
                "truncated": req.truncated}

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
        cfg = {**self.config, "block_size": int(self.traffic["block_size"])}
        return dict(zip(rows, ref.output_logits(self.weights, cfg, prompts,
                                                outs, fmt=fmt, fault=fault)))

    def reference(self, sample: dict, fmt: str | None = None,
                  overrides: dict | None = None) -> dict:
        """The tokens a stand-in puts first at each output position of the
        sampled requests, fed their prompts and the program's own outputs:
        the reference computed in ``fmt`` (the control) or with
        ``overrides["fault"]`` planted, in the program's place."""
        chosen = np.zeros_like(sample["tokens"])
        for j, lg in self._logits(sample, fmt,
                                  (overrides or {}).get("fault")).items():
            chosen[j, :len(lg)] = lg.argmax(-1).cpu().numpy()
        return {"chosen": chosen}

    def compare(self, prog: dict, drawn) -> tuple:
        """``(numbers, diagnostics)``: over the sampled requests, fed their
        prompts and the program's outputs, at each output position the
        reference's best logit less its logit of the token the program
        chose (``chosen``, where a stand-in stands in the program's
        place), over the position's logit standard deviation (and, not
        compared, the share of positions whose token is not the reference's
        argmax: bf16's rounding flips near-ties too often for it to
        separate the control, PERF.md §2); and 1 where
        the program's KV pool is not of the configuration's type (its
        ``kv_cache_dtype``), which the logits cannot tell apart (PERF.md
        §2)."""
        t = time.monotonic()
        chosen = prog.get("chosen", prog["tokens"])
        logits = self._logits(prog)
        margins, misses = [], []
        for j, lg in logits.items():
            c = torch.as_tensor(chosen[j, :len(lg)].astype(np.int64),
                                device=lg.device)
            best, arg = lg.max(-1)
            got = lg.gather(-1, c[:, None])[:, 0]
            margins.append(((best - got) / lg.std(-1)).cpu().numpy())
            misses.append((arg != c).cpu().numpy())
        m = np.concatenate(margins) if margins else np.ones(1)
        miss = np.concatenate(misses) if misses else np.ones(1, bool)
        short = int(np.sum(prog["truncated"]
                           | (prog["iterations"] != prog["max_new"])))
        q = np.quantile(m, [0.5, 0.99, 0.999])
        values = {"truncated": max(short, self.short_total),
                  "kv_pool_off_type": int(
                      self.pool_dtype != KV_TYPES[self.config["kv_cache_dtype"]]),
                  "token_margin": float(m.max()),
                  "top1_miss": float(miss.mean())}
        diag = {"pairs": int(m.size), "requests": len(logits),
                "tokens_max": int(prog["iterations"].max(initial=0)),
                "margin_p50": float(q[0]), "margin_p99": float(q[1]),
                "margin_p999": float(q[2]),
                "misses": int(miss.sum()),
                "margin_of_misses_p50": float(np.median(m[miss]))
                if miss.any() else 0.0,
                "reference_s": time.monotonic() - t}
        return values, diag
