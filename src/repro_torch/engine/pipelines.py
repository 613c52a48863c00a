"""Built-in serving pipelines of the port: LVRF row decoding.

``lvrf_rows`` decodes bipolar MAP row encodings against permutation-rolled
value atoms (F=3, M=n_values, D=2048, deterministic).  With
``fused_step=True`` every sweep is one launch of the CUDA resonator kernel.
NVSA abduction and LM decoding wait for later slices of the port.
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
