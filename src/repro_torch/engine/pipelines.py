"""Built-in serving pipelines of the port: NVSA RPM abduction, LVRF row
decoding, LM decode.

Two factorization workloads behind the same ``Engine.submit/step/drain`` API.
``nvsa_abduction`` factorizes padded block-code attribute books (unitary
algebra, F=3, M=10 padded with a 5/6/10 mask, D=1024, stochastic
Gauss-Seidel sweeps) and ranks RPM candidates through probabilistic
abduction; a bipolar NVSA config with ``fused_step=True`` runs each sweep as
one launch of the masked CUDA resonator kernel.  ``lvrf_rows`` decodes bipolar MAP row encodings against permutation-rolled
value atoms (F=3, M=n_values, D=2048, deterministic).  With
``fused_step=True`` every sweep is one launch of the CUDA resonator kernel.

``lm_decode`` is transformer serving (``launch/serve.ServeEngine``'s
prefill/decode) re-expressed as a registered StageGraph + ``step_ops``, so
the same adSCH machinery
(:func:`repro_torch.engine.engine.derive_sweeps_per_step`) prices LM steps; the request loop lives in
:class:`repro_torch.runtime.LMEngine`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import vsa
from repro_torch.core.scheduler import Op
from repro_torch.device import DEFAULT_DEVICE, generator as as_generator, resolve
from repro_torch.engine.registry import ServeSpec, register
from repro_torch.engine.stage import Stage, StageGraph
from repro_torch.models import lvrf as lvrf_mod
from repro_torch.models import nvsa as nvsa_mod


@register("nvsa_abduction")
def nvsa_abduction(generator, *, cfg=None, params=None, batch: int = 8,
                   expected_sweeps: int | None = None,
                   fused_step: bool = False, codebooks=None, mask=None,
                   device=DEFAULT_DEVICE) -> ServeSpec:
    """NVSA RPM abduction.

    Engine requests: the 8 context-panel queries of one task ([8, D]), with
    ``meta={"cand": [8, D]}`` candidate queries; the postprocess runs the
    same beliefs -> abduce -> execute -> rank tail as :func:`nvsa.solve`.
    With ``params`` (a :class:`repro_torch.models.cnn.CNN`) the ServeSpec
    also carries the runnable two-stage graph for stream serving.

    ``fused_step=True`` requests the fused CUDA sweep.  It only engages
    where :func:`repro_torch.core.factorizer.fused_sweep_eligible` holds:
    the default NVSA config is unitary/Gauss-Seidel/stochastic, so there the
    flag is a no-op (the two-pass sweep, unchanged trajectories); bipolar
    Jacobi noise-free NVSA configs (``vsa.lanes == 1``) run each sweep as
    one launch of the masked kernel.  ``codebooks`` / ``mask`` replace the
    books drawn from ``generator`` (e.g. the reference's, converted by
    :mod:`repro_torch.convert`).
    """
    import dataclasses as _dc

    dev = resolve(device)
    cfg = cfg if cfg is not None else nvsa_mod.NVSAConfig()
    if fused_step and not cfg.factorizer.fused_step:
        cfg = _dc.replace(cfg, factorizer=_dc.replace(
            cfg.factorizer, fused_step=True))
    cbs, mk = nvsa_mod.make_codebooks(as_generator(generator), cfg, device=dev)
    cbs = cbs if codebooks is None else codebooks.to(dev)
    mk = mk if mask is None else mask.to(dev)
    graph = nvsa_mod.stage_graph(params, cbs, mk, cfg, batch=batch,
                                 expected_sweeps=expected_sweeps)

    def postprocess(queries, res, meta):
        q = torch.as_tensor(queries)
        books, m = cbs.to(q.device), mk.to(q.device)
        beliefs = nvsa_mod.beliefs_from_scores(
            q, torch.as_tensor(res.scores, device=q.device), m, cfg)
        out = {"indices": res.indices, "iterations": res.iterations,
               "converged": res.converged, "beliefs": beliefs.cpu().numpy()}
        if meta is not None and "cand" in meta:
            cand = torch.as_tensor(meta["cand"], dtype=torch.float32,
                                   device=q.device)
            answer, sims = nvsa_mod.abduce_answers(beliefs[None], cand[None],
                                                   books, cfg)
            out["answer"] = int(answer[0])
            out["sims"] = sims[0].cpu().numpy()
        return out

    return ServeSpec("nvsa_abduction", cbs, cfg.factorizer, mk, graph,
                     postprocess)


@register("lvrf_rows")
def lvrf_rows(generator, *, cfg=None, rules=("constant", "progression_p1",
                                             "distribute_three"),
              examples: int = 32, max_iters: int = 40,
              batch: int = 32, synchronous: bool = False,
              fused_step: bool = False, atoms: dict | None = None,
              device=DEFAULT_DEVICE) -> ServeSpec:
    """LVRF: decode row encodings and serve rule abduction/execution.

    Engine requests: row vectors [k, D] (products of permuted value atoms);
    results decode back to the (v1, v2, v3) values.  The stage graph encodes
    observed rows, then scores them against the one-shot-learned rule
    codebook and executes the abduced rule over candidate completions.

    ``fused_step=True`` (forcing Jacobi sweeps, which the fused kernel
    requires) serves the rows through the fused CUDA sweep.  ``atoms``
    replaces the atoms drawn from ``generator`` (e.g. the reference's,
    converted by :mod:`repro_torch.convert`).
    """
    dev = resolve(device)
    cfg = cfg if cfg is not None else lvrf_mod.LVRFConfig()
    if atoms is None:
        atoms = lvrf_mod.init_atoms(as_generator(generator), cfg, device=dev)
    atoms = {k: v.to(dev) for k, v in atoms.items()}
    cbs = lvrf_mod.row_codebooks(atoms, cfg)
    fcfg = lvrf_mod.row_factorizer_config(
        cfg, max_iters=max_iters, synchronous=synchronous or fused_step,
        fused_step=fused_step)
    rows = lvrf_mod.make_rule_examples(np.random.default_rng(0), list(rules),
                                       cfg.n_values, examples)
    rule_vecs = lvrf_mod.learn_rules(atoms, rows, cfg)
    R, D, n = len(rules), cfg.vsa.dim, cfg.n_values

    def encode_fn(xs, generator):
        return lvrf_mod.encode_row(atoms, xs["rows"], cfg), xs["prefix"]

    def abduce_fn(x, generator):
        enc, prefix = x  # [B, K, D], [B, 2]
        sims = vsa.similarity(enc[:, :, None, :], rule_vecs)  # [B, K, R]
        post = torch.softmax(sims.sum(1) * 8.0, dim=-1)
        return lvrf_mod.execute(atoms, rule_vecs, post, prefix, cfg)

    graph = StageGraph("lvrf_rows", (
        Stage("encode", encode_fn, symbolic=False, cost_ops=(
            Op("enc_bind", "simd", (batch * 2 * 3 * D,)),)),
        Stage("abduce", abduce_fn, symbolic=True, cost_ops=(
            Op("rule_sims", "gemm", (batch * 2, D, R), symbolic=True),
            Op("execute", "gemm", (batch * n, D, R), deps=("rule_sims",),
               symbolic=True),
            Op("rank", "simd", (batch * n * R,), deps=("execute",),
               symbolic=True),)),
    ))

    def postprocess(queries, res, meta):
        return {"values": res.indices, "iterations": res.iterations,
                "converged": res.converged,
                "reconstruction_sim": res.reconstruction_sim}

    return ServeSpec("lvrf_rows", cbs, fcfg, None, graph, postprocess)


def lm_stack_ops(cfg, tokens: int, tag: str, *, symbolic: bool,
                 lm_head: bool, kv_window: int = 0) -> tuple:
    """adSCH cost hints for pushing ``tokens`` tokens through one LM stack.

    Coarse by design (layers folded into the GEMM row dim, attention scored
    as its projections): the scheduler only needs relative magnitudes to
    size the decode burst against the prefill window.

    ``kv_window > 0`` adds the decode-attention KV read — the term that
    dominates decode memory traffic: every token reads ``kv_window`` cached
    positions per layer (contiguous: the full ``max_len`` row the dense
    path touches; paged: ``ceil(len/block) * block`` — the blocks the
    flash-decode kernel reads).  Priced as a SIMD op (pure data movement),
    with int8 caches reading half the elements of bf16.
    """
    d, L = cfg.d_model, cfg.n_layers
    hd = cfg.head_dim if cfg.head_dim is not None else d // cfg.n_heads
    d_ff_in = 2 * cfg.d_ff if cfg.mlp_kind == "swiglu" else cfg.d_ff
    ops = [
        Op(f"{tag}_qkv", "gemm",
           (tokens * L, d, (cfg.n_heads + 2 * cfg.n_kv_heads) * hd),
           symbolic=symbolic),
    ]
    attn_deps = (f"{tag}_qkv",)
    if kv_window:
        scale = 0.5 if cfg.kv_cache_dtype == "int8" else 1.0
        elems = int(tokens * L * kv_window * cfg.n_kv_heads * hd * 2 * scale)
        ops.append(Op(f"{tag}_kv_gather", "simd", (max(elems, 1),),
                      deps=(f"{tag}_qkv",), symbolic=symbolic))
        attn_deps = (f"{tag}_qkv", f"{tag}_kv_gather")
    ops += [
        Op(f"{tag}_attn_out", "gemm", (tokens * L, cfg.n_heads * hd, d),
           deps=attn_deps, symbolic=symbolic),
        Op(f"{tag}_mlp_in", "gemm", (tokens * L, d, d_ff_in),
           deps=(f"{tag}_attn_out",), symbolic=symbolic),
        Op(f"{tag}_mlp_out", "gemm", (tokens * L, cfg.d_ff, d),
           deps=(f"{tag}_mlp_in",), symbolic=symbolic),
    ]
    if lm_head:
        ops.append(Op(f"{tag}_lm_head", "gemm", (tokens, d, cfg.vocab),
                      deps=(f"{tag}_mlp_out",), symbolic=symbolic))
    return tuple(ops)


@register("lm_decode")
def lm_decode(generator, *, cfg, batch: int = 4, prompt_len: int = 16,
              max_len: int | None = None,
              kv_block: int | None = None) -> ServeSpec:
    """LM continuous batching as a registered workload (host code only; the
    ``generator`` is unused and may be None).

    ``cfg`` is a :class:`repro_torch.nn.transformer.ModelConfig`.  The
    StageGraph maps LM serving onto the paper's interleave vocabulary:
    prefill is the big dense block (neural), per-token decode the small
    memory-bound kernel stream (declared ``symbolic`` so the adSCH policy
    fills it into leftover cells while another request's prefill owns the
    array — the continuous-batching overlap question of Fig. 13b).
    ``step_ops`` prices ONE decode token over the whole slot batch, so
    :func:`repro_torch.engine.engine.derive_sweeps_per_step` returns how
    many decode steps fit a prefill window — the burst
    :class:`repro_torch.runtime.LMEngine` runs between retirement scans.

    The decode stage carries the KV-read term at the ``prompt_len``
    operating point: contiguous caches read the full ``max_len`` row per
    token, paged caches (``kv_block`` set) ``ceil((prompt_len+1)/kv_block)``
    blocks.
    """
    if kv_block is not None:
        kv_window = -(-(prompt_len + 1) // kv_block) * kv_block
    else:
        kv_window = max_len if max_len is not None else prompt_len
    graph = StageGraph("lm_decode", (
        Stage("prefill", None, symbolic=False,
              cost_ops=lm_stack_ops(cfg, batch * prompt_len, "prefill",
                                    symbolic=False, lm_head=False)),
        Stage("decode", None, symbolic=True,
              cost_ops=lm_stack_ops(cfg, batch, "decode", symbolic=True,
                                    lm_head=True, kv_window=kv_window)),
    ))

    def step_ops(slots, *, data_shards=1, model_shards=1):
        del model_shards  # LM tensor parallelism: out of the cell model's scope
        return list(lm_stack_ops(cfg, -(-slots // data_shards), "decode",
                                 symbolic=True, lm_head=True,
                                 kv_window=kv_window))

    return ServeSpec("lm_decode", graph=graph, step_ops=step_ops)
