"""NVSA: Neuro-Vector-Symbolic Architecture for RPM reasoning (paper Sec. II-D).

The port of ``repro/models/nvsa.py``.  Pipeline (Fig. 2): CNN perception
emits a VSA *query vector* per panel (the product of its attribute atoms, in
superposition); the CogSys factorizer decomposes it into per-attribute
beliefs; probabilistic abduction infers the row rules; execution predicts
the missing panel; candidates are ranked by VSA similarity.

Randomness is explicit: where the reference takes a ``jax.random`` key, the
port takes a ``torch.Generator`` (or an int seed).  :func:`solve` draws
nothing but the factorizer's per-query keys, ``fz.draw_keys(generator,
8 * B)``, row ``8 b + p`` for task b's context panel p; a caller that pins
the same rows through ``Engine.submit(ctx[b], keys=...)`` serves the same
trajectories.

:func:`stage_graph` is the adSCH analogue (Fig. 13b): the two stages,
perception and abduction, with scheduler cost hints; lowered by
:func:`repro_torch.engine.build.build_pipeline`, the perception of task batch
t runs in the same pipeline step as the abduction of batch t-1.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import factorizer as fz
from repro_torch.core import symbolic as sym
from repro_torch.core import vsa
from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.models import cnn

ATTR_SIZES = (5, 6, 10)  # type, size, color
MAX_M = max(ATTR_SIZES)


@dataclasses.dataclass(frozen=True)
class NVSAConfig:
    # Block-code VSA (NVSA-style): binding = block-wise circular convolution.
    vsa: vsa.VSAConfig = vsa.VSAConfig(dim=1024, blocks=4)
    cnn: cnn.CNNConfig = cnn.CNNConfig(vsa_dim=1024, attr_sizes=ATTR_SIZES)
    factorizer: fz.FactorizerConfig = None  # type: ignore[assignment]
    belief_temp: float = 96.0  # sharpness of cosine -> belief softmax
    # 'logits_bind': the frontend's VSA layer binds softmax-weighted attribute
    # atoms into the product query (the binding structure is part of the
    # network's output head, as in NVSA); 'head': the free-form D-dim
    # regression head.
    query_mode: str = "logits_bind"

    def __post_init__(self):
        if self.factorizer is None:
            object.__setattr__(self, "factorizer", fz.FactorizerConfig(
                vsa=self.vsa, num_factors=len(ATTR_SIZES), codebook_size=MAX_M,
                algebra="bipolar" if self.vsa.lanes == 1 else "unitary",
                activation="identity" if self.vsa.lanes == 1 else "abs",
                max_iters=60, noise_std=0.3, restart_every=20,
                conv_threshold=0.55))


def make_codebooks(generator, cfg: NVSAConfig, device=DEFAULT_DEVICE):
    """Padded attribute codebooks [F, MAX_M, D] + validity mask [F, MAX_M]
    (``generator``: a ``torch.Generator`` or an int seed)."""
    dev = resolve(device)
    cbs = fz.make_codebooks(generator, cfg.factorizer, device=dev)
    mask = torch.stack([torch.arange(MAX_M, device=dev) < n
                        for n in ATTR_SIZES])
    return cbs, mask


def target_query(codebooks: torch.Tensor, attrs, cfg: NVSAConfig) -> torch.Tensor:
    """Ground-truth product vector for supervision. attrs: [..., F] ints."""
    return fz.bind_combo(codebooks, attrs, cfg.vsa)


def frontend_loss(model: cnn.CNN, batch: dict, codebooks, cfg: NVSAConfig):
    """Cosine regression to the target query vector + auxiliary attr CE.

    batch: ``images`` [N, H, W] and integer labels ``type`` / ``size`` /
    ``color`` [N] (tensors on the model's device).  Returns ``(loss,
    {"cosine", "aux_ce"})`` as 0-d tensors, the loss differentiable in the
    model's parameters (a trainer calls ``requires_grad_(True)`` on the
    model), the metrics detached.
    """
    out = cnn.apply(model, batch["images"], cfg.cnn)
    labels = [batch[name].long() for name in ("type", "size", "color")]
    target = target_query(codebooks, torch.stack(labels, dim=-1), cfg)
    cos = vsa.similarity(out["query"], target)
    loss = torch.mean(1.0 - cos)
    aux = 0.0
    for a, lbl in enumerate(labels):
        logp = torch.log_softmax(out["attr_logits"][a], dim=-1)
        aux = aux + torch.mean(-torch.gather(logp, 1, lbl[:, None]))
    metrics = {"cosine": torch.mean(cos).detach(), "aux_ce": aux.detach()}
    return loss + 0.3 * aux, metrics


# ---------------------------------------------------------------------------
# Inference: perceive -> factorize -> abduce -> execute -> select
# ---------------------------------------------------------------------------

def perceive(model: cnn.CNN, images: torch.Tensor, cfg: NVSAConfig,
             codebooks: torch.Tensor | None = None) -> torch.Tensor:
    """images [..., H, W] -> query vectors [..., D].

    query_mode='logits_bind': the output layer binds the softmax-weighted
    attribute atoms (the VSA structure is part of the head); 'head': the
    free-form regression head.
    """
    flat = images.reshape(-1, *images.shape[-2:])
    out = cnn.apply(model, flat, cfg.cnn)
    if cfg.query_mode == "logits_bind" and codebooks is not None:
        atoms = []
        for a, n in enumerate(ATTR_SIZES):
            p = torch.softmax(out["attr_logits"][a], dim=-1)  # [N, n]
            atoms.append(p @ codebooks[a, :n])  # expected atom [N, D]
        q = vsa.bind_all(torch.stack(atoms), cfg.vsa)
    else:
        q = out["query"]
    return q.reshape(*images.shape[:-2], cfg.vsa.dim)


def beliefs_from_scores(queries: torch.Tensor, scores: torch.Tensor, mask,
                        cfg: NVSAConfig) -> torch.Tensor:
    """Soft beliefs [N, F, M] from factorizer similarity scores.

    Atoms are unit-norm and unbinding is norm-preserving, so dividing by the
    query norm turns the raw dot products into cosines before the masked
    softmax.  Shared by the in-process path and the engine's postprocess, so
    both decode identical beliefs from identical factorizations.
    """
    qnorm = torch.linalg.norm(queries, dim=-1)[:, None, None] + 1e-9
    cos = scores / qnorm
    return torch.softmax(torch.where(mask[None], cfg.belief_temp * cos,
                                     torch.tensor(-1e9, device=cos.device)),
                         dim=-1)


def beliefs_from_queries(queries: torch.Tensor, codebooks, mask, generator,
                         cfg: NVSAConfig):
    """Factorize query vectors [N, D] -> (per-attribute beliefs, result).

    All N = B*8 panel queries of a task batch ride ONE batch-native
    factorizer loop (per-query convergence masking); one key per query is
    drawn from ``generator``.  Runs on the queries' device.
    """
    res = fz.factorize_batch(queries, codebooks, generator, cfg.factorizer,
                             mask, device=queries.device)
    return beliefs_from_scores(queries, res.scores, mask, cfg), res


def abduce_answers(beliefs: torch.Tensor, cand: torch.Tensor, codebooks,
                   cfg: NVSAConfig) -> tuple:
    """Probabilistic abduction tail, shared by every serving path.

    beliefs [B, 8, F, MAX_M] (context panels), cand [B, 8, D] candidate
    queries -> (answer [B], sims [B, 8]).  Per attribute: assemble the 3x3
    belief grid (missing panel uniform), abduce the row rule, execute it,
    bind the expected atoms into the predicted panel vector, rank candidates
    by VSA similarity.
    """
    B = beliefs.shape[0]
    pred_atoms = []
    for a, n in enumerate(ATTR_SIZES):
        g = beliefs[:, :, a, :n]  # [B, 8, n]
        g = g / (g.sum(-1, keepdim=True) + 1e-9)
        pad = torch.full((B, 1, n), 1.0 / n, device=g.device)
        grid = torch.cat([g, pad], dim=1).reshape(B, 3, 3, n)
        post = sym.abduce_rules(grid)
        pred = sym.execute_rules(grid, post)  # [B, n]
        pred_atoms.append(pred @ codebooks[a, :n])  # expected atom [B, D]
    pred_q = vsa.bind_all(torch.stack(pred_atoms), cfg.vsa)  # [B, D]
    sims = vsa.similarity(pred_q[:, None, :], cand)  # [B, 8]
    return torch.argmax(sims, dim=-1), sims


def answers_from_queries(ctx: torch.Tensor, cand: torch.Tensor, codebooks,
                         mask, generator, cfg: NVSAConfig) -> torch.Tensor:
    """Symbolic stage: context/candidate queries [B, 8, D] -> answers [B]."""
    B = ctx.shape[0]
    beliefs, _ = beliefs_from_queries(ctx.reshape(B * 8, -1), codebooks, mask,
                                      generator, cfg)
    beliefs = beliefs.reshape(B, 8, len(ATTR_SIZES), MAX_M)
    answer, _ = abduce_answers(beliefs, cand, codebooks, cfg)
    return answer


def solve(model: cnn.CNN, batch: dict, codebooks, mask, generator,
          cfg: NVSAConfig) -> dict:
    """End-to-end RPM solve for a batch of 'center' tasks, on the
    codebooks' device.

    batch: images [B, 9, H, W], candidate_images [B, 8, H, W] (tensors or
    numpy).  The factorizer's keys are ``fz.draw_keys(generator, 8 * B)``
    (see the module docstring).  Returns answer predictions plus
    factorizer diagnostics.
    """
    dev = codebooks.device
    images = torch.as_tensor(batch["images"], device=dev)
    cand_images = torch.as_tensor(batch["candidate_images"], device=dev)
    B = images.shape[0]
    ctx = perceive(model, images[:, :8], cfg, codebooks)  # [B, 8, D]
    cand = perceive(model, cand_images, cfg, codebooks)  # [B, 8, D]
    ctx_beliefs, ctx_res = beliefs_from_queries(
        ctx.reshape(B * 8, -1), codebooks, mask, generator, cfg)
    ctx_beliefs = ctx_beliefs.reshape(B, 8, len(ATTR_SIZES), MAX_M)
    answer, sims = abduce_answers(ctx_beliefs, cand, codebooks, cfg)
    iters = ctx_res.iterations.reshape(B, 8)  # per query, not batch-max
    return {"answer": answer, "sims": sims,
            "fact_iters": iters,
            "fact_mean_iters": torch.mean(iters.float()),
            "fact_max_iters": torch.max(iters),
            "fact_converged": ctx_res.converged.reshape(B, 8)}


def accuracy(model: cnn.CNN, batch: dict, codebooks, mask, generator,
             cfg: NVSAConfig) -> torch.Tensor:
    out = solve(model, batch, codebooks, mask, generator, cfg)
    answer = torch.as_tensor(batch["answer"], device=out["answer"].device)
    return torch.mean((out["answer"] == answer).float())


# ---------------------------------------------------------------------------
# adSCH software analogue: scheduler-planned stage graph
# ---------------------------------------------------------------------------

def _neural_cost_ops(cfg: NVSAConfig, batch: int) -> tuple:
    """Scheduler hints for the CNN stage: 16 panels (8 ctx + 8 cand) per task.

    conv2d dims are the im2col (m, k, n): m = panels * out_pixels,
    k = 3*3*c_in, n = c_out (stride-2 convs halve the map each layer).
    """
    from repro_torch.core.scheduler import Op
    panels = batch * 16
    ops, c_in, hw_px = [], 1, cfg.cnn.img
    prev = ()
    for i, c in enumerate(cfg.cnn.channels):
        hw_px = max(1, hw_px // 2)
        op = Op(f"conv{i}", "conv2d",
                (panels * hw_px * hw_px, cfg.cnn.kernel ** 2 * c_in, c),
                deps=prev)
        ops.append(op)
        prev = (op.name,)
        c_in = c
    ops.append(Op("head", "gemm", (panels, c_in, cfg.cnn.head_hidden),
                  deps=prev))
    ops.append(Op("head_vsa", "gemm",
                  (panels, cfg.cnn.head_hidden, cfg.vsa.dim), deps=("head",)))
    return tuple(ops)


def _symbolic_cost_ops(cfg: NVSAConfig, batch: int,
                       expected_sweeps: int | None = None) -> tuple:
    """Scheduler hints for factorize+abduce: ``expected_sweeps`` resonator
    sweeps over the task batch's 8*B queries, then the abduction SIMD tail.

    The loop is unrolled into sweep-granular chained ops (the list scheduler
    has no loop construct): that granularity is what lets adSCH slot
    individual sweeps into the neural stage's idle-cell windows (Fig. 13c).
    """
    from repro_torch.core.scheduler import Op
    fcfg = cfg.factorizer
    sweeps = expected_sweeps if expected_sweeps is not None else \
        max(1, fcfg.max_iters // 3)  # observed mean convergence ~ max/3
    ops = []
    prev = ()
    for s in range(sweeps):
        for op in fz.sweep_cost_ops(fcfg, batch * 8):
            op = dataclasses.replace(
                op, name=f"{op.name}_s{s}",
                deps=tuple(f"{d}_s{s}" for d in op.deps) or prev)
            ops.append(op)
            prev = (op.name,)
    ops.append(Op("abduce", "simd", (batch * 3 * 9 * MAX_M * 8,),
                  deps=prev, symbolic=True))
    return tuple(ops)


def stage_graph(model, codebooks, mask, cfg: NVSAConfig, *, batch: int,
                expected_sweeps: int | None = None):
    """The NVSA RPM pipeline as an engine StageGraph.

    Stage fns take one task batch ``(images [B, 9, H, W], cands [B, 8, H,
    W])`` and thread ``(ctx, cand)`` query vectors to the symbolic stage,
    which draws its factorizer keys from the batch's generator exactly as
    :func:`solve` does, so a pipelined run equals per-batch ``solve`` calls
    given the same per-batch generators.  With ``model=None`` the graph is
    cost-model-only (usable for planning).
    """
    from repro_torch.engine.stage import Stage, StageGraph

    def neural_fn(xs, generator):
        imgs, cands = xs
        return (perceive(model, imgs[:, :8], cfg, codebooks),
                perceive(model, cands, cfg, codebooks))

    def symbolic_fn(x, generator):
        ctx, cand = x
        return answers_from_queries(ctx, cand, codebooks, mask, generator, cfg)

    return StageGraph("nvsa_rpm", (
        Stage("perceive", neural_fn if model is not None else None,
              symbolic=False, cost_ops=_neural_cost_ops(cfg, batch)),
        Stage("abduce", symbolic_fn if model is not None else None,
              symbolic=True,
              cost_ops=_symbolic_cost_ops(cfg, batch, expected_sweeps)),
    ))


def pipelined_solve_scan(model, image_stream, cand_stream, codebooks, mask,
                         generator, cfg: NVSAConfig):
    """DEPRECATED: use ``repro_torch.engine.build_pipeline(nvsa.stage_graph(...))``.

    A thin compatibility wrapper over the engine's pipeline runner; batch
    t's generator is derived from ``generator`` as
    :func:`repro_torch.engine.build.batch_generators` documents.

    image_stream: [T, B, 9, H, W]; cand_stream: [T, B, 8, H, W] -> [T, B].
    """
    import warnings

    from repro_torch.engine.build import build_pipeline
    warnings.warn(
        "nvsa.pipelined_solve_scan is deprecated; build the pipeline via "
        "repro_torch.engine.build_pipeline(nvsa.stage_graph(...)) instead",
        DeprecationWarning, stacklevel=2)
    B = image_stream.shape[1]
    runner = build_pipeline(stage_graph(model, codebooks, mask, cfg, batch=B))
    return runner((image_stream, cand_stream), generator)  # [T, B]
