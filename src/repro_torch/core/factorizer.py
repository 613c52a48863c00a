"""CogSys efficient symbolic factorization (paper Sec. IV-A, Fig. 8).

The port of ``repro/core/factorizer.py``.  Replaces the O(M^F)
product-combination codebook with F codebooks of M atoms searched *in
superposition*: iteratively (1) unbind all-but-one factor from the query,
(2) score the unbound estimate against that factor's codebook, (3) project
the scores back onto the codebook to form the next estimate.  Convergence is
reached when the re-bound hard decisions reconstruct the query.

Two algebras: ``bipolar`` (MAP: +-1 atoms, Hadamard binding, sign
saturation) and ``unitary`` (block-code HRR through ``torch.fft``, unit-
spectrum re-projection).

The factorizer is batch-native: one loop over the whole query batch
``[N, F, D]`` with a per-query ``done`` mask (converged queries freeze;
``iterations`` is per query).  The reference's ``jax.lax.while_loop`` is a
Python loop here.  Fused-eligible configs (bipolar Jacobi, see
:func:`fused_sweep_eligible`) run each sweep as ONE launch of the CUDA
kernel in :mod:`repro_torch.kernels.resonator_step` when the state lies on
the card, and as its plain version on the CPU.

Codebooks may be a dense ``[F, M, D]`` tensor or a quantized
:class:`~repro_torch.core.quantization.QTensor` (Tab. IX): int8 scores go
through the CUDA kernel of :mod:`repro_torch.kernels.similarity` (one
launch per factor per sweep on the card), fp8 scores through
:func:`~repro_torch.core.quantization.quantized_matvec`.

Stochasticity injection (Sec. IV-B: ``noise_std`` on the scores,
``proj_noise_std`` on the projection, ``restart_every``) draws its noise
from :mod:`repro_torch.core.rng`, a counter-based generator: each row's
noise is a pure function of its int64 key ``[2]``, its own sweep index, the
factor and the stream, so it does not depend on the row's slot or batch.
The reference's ``jax.random`` streams are different numbers; stochastic
runs are compared with it statistically.

**Model-sharded mode** (``model_axis`` set, :func:`make_resonator`): the
codebook rows are split over the model axis of a
:class:`repro_torch.launch.mesh.Mesh`, one row block per model shard on its
own device, and the slot rows over its data axis.  One controller drives
every shard in lockstep, so the resonator's members then take and return
one entry per data shard, and every cross-shard sum is one
:meth:`~repro_torch.launch.mesh.Mesh.reduce` call: the reference's
``psum``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Literal, NamedTuple

import torch
import torch.nn.functional as nnf

from repro_torch.core import rng, vsa
from repro_torch.core.quantization import QTensor, quantize, quantized_matvec
from repro_torch.core.vsa import VSAConfig
from repro_torch.device import DEFAULT_DEVICE, generator as as_generator, resolve


@dataclasses.dataclass(frozen=True)
class FactorizerConfig:
    vsa: VSAConfig
    num_factors: int  # F
    codebook_size: int  # M per factor
    algebra: Literal["bipolar", "unitary"] = "bipolar"
    max_iters: int = 100
    noise_std: float = 0.0  # relative (x std of scores) noise on Step 2
    proj_noise_std: float = 0.0  # relative noise on Step 3 projection
    activation: Literal["identity", "abs", "relu", "softmax"] = "identity"
    temperature: float = 1.0  # softmax sharpness when activation == 'softmax'
    conv_threshold: float = 0.9  # reconstruction cosine to declare convergence
    codebook_fmt: Literal["fp32", "int8", "fp8_e4m3"] = "fp32"
    synchronous: bool = False  # True = Jacobi sweep; False = Gauss-Seidel (better)
    restart_every: int = 0  # >0: re-randomise estimates every k stuck iterations
    fused_step: bool = False  # bipolar+synchronous only: run the whole sweep in
    # the fused kernel (kernels/resonator_step); see fused_sweep_eligible().

    def __post_init__(self):
        if self.algebra == "bipolar" and self.vsa.lanes != 1:
            raise ValueError("bipolar algebra requires lanes == 1 "
                             f"(dim == blocks), got L={self.vsa.lanes}")


class FactorizerResult(NamedTuple):
    indices: torch.Tensor  # [..., F] int32 decoded atom per factor
    iterations: torch.Tensor  # [...] int32 iterations executed per query
    converged: torch.Tensor  # [...] bool per query
    reconstruction_sim: torch.Tensor  # [...] float32 cosine(q, bind(decoded))
    scores: torch.Tensor  # [..., F, M] final similarity scores (soft beliefs)


def make_codebooks(generator, cfg: FactorizerConfig,
                   dtype=torch.float32, device=DEFAULT_DEVICE) -> torch.Tensor:
    """F codebooks of M atoms: [F, M, D] (``generator``: a
    ``torch.Generator`` or an int seed)."""
    shape = (cfg.num_factors, cfg.codebook_size)
    if cfg.algebra == "bipolar":
        return vsa.random_bipolar(generator, shape, cfg.vsa, dtype, device)
    return vsa.random_unitary(generator, shape, cfg.vsa, dtype, device)


def bind_combo(codebooks: torch.Tensor, indices: torch.Tensor,
               cfg: VSAConfig) -> torch.Tensor:
    """Product vector of one atom per factor: bind(X^1[i1], ..., X^F[iF]).

    ``indices`` may carry leading batch dims: [..., F] -> [..., D].
    """
    F = codebooks.shape[0]
    indices = torch.as_tensor(indices, device=codebooks.device).long()
    atoms = codebooks[torch.arange(F, device=codebooks.device), indices]
    return vsa.bind_all(atoms, cfg, axis=-2)


def _norm(x: torch.Tensor, cfg: FactorizerConfig) -> torch.Tensor:
    if cfg.algebra == "bipolar":
        return vsa.normalize_sign(x)
    return vsa.normalize_unitary(x, cfg.vsa)


def _unbind(q: torch.Tensor, est: torch.Tensor, cfg: FactorizerConfig,
            factor: int | None = None) -> torch.Tensor:
    """x~_i = q unbound by the product of the other factors' estimates.

    q: [..., D]; est: [..., F, D].  With ``factor=None`` returns the unbound
    estimate for every factor [..., F, D]; with ``factor=i`` just that
    factor's [..., D] (Gauss-Seidel inner step).  Estimates are normalised
    (self-inverse bipolar / unit-spectrum unitary), so inv(prod / est_i)
    reduces to conj(prod) * est_i in the spectral domain and to
    prod * est_i elementwise in the bipolar corner.
    """
    vcfg = cfg.vsa
    if cfg.algebra == "bipolar":
        prod = torch.prod(est, dim=-2)  # [..., D]
        if factor is None:
            return q[..., None, :] * prod[..., None, :] * est  # est_i^2 == 1
        return q * prod * est[..., factor, :]
    q_spec = torch.fft.rfft(vcfg.blockify(q.float()), dim=-1)
    est_spec = torch.fft.rfft(vcfg.blockify(est.float()), dim=-1)
    prod = torch.prod(est_spec, dim=-3)  # [..., B, nfreq]
    if factor is None:
        unbound = (q_spec[..., None, :, :] * torch.conj(prod)[..., None, :, :]
                   * est_spec)
    else:
        unbound = q_spec * torch.conj(prod) * est_spec[..., factor, :, :]
    return vcfg.flatten(torch.fft.irfft(unbound, n=vcfg.lanes, dim=-1))


def _activation(alpha: torch.Tensor, cfg: FactorizerConfig) -> torch.Tensor:
    if cfg.activation == "identity":
        return alpha
    if cfg.activation == "abs":
        return torch.abs(alpha)
    if cfg.activation == "relu":
        return torch.relu(alpha)
    if cfg.activation == "softmax":
        return torch.softmax(cfg.temperature * alpha, dim=-1)
    raise ValueError(cfg.activation)


class _State(NamedTuple):
    est: torch.Tensor  # [N, F, D] current normalised estimates
    iters: torch.Tensor  # [N] int32 per-query sweeps executed (frozen at convergence)
    done: torch.Tensor  # [N] bool per-query convergence mask
    sim: torch.Tensor  # [N] float32 reconstruction cosine (frozen at convergence)
    keys: torch.Tensor  # [N, 2] int64 per-query keys (the noise streams')
    it: int  # global sweep counter (host side)


def fused_sweep_eligible(cfg: FactorizerConfig) -> bool:
    """Can this config's sweep run the fused kernel?

    Bipolar Jacobi (synchronous) sweeps with elementwise activations, no
    stochasticity, and dense fp32 codebooks.  Validity masks do not
    disqualify: the mask-aware variant serves them.
    """
    return (cfg.fused_step and cfg.algebra == "bipolar" and cfg.synchronous
            and cfg.noise_std == 0 and cfg.proj_noise_std == 0
            and cfg.activation in ("identity", "abs")
            and cfg.codebook_fmt == "fp32")


def sweep_cost_ops(cfg: FactorizerConfig, n: int, *, data_shards: int = 1,
                   model_shards: int = 1, fused: bool | None = None) -> list:
    """Scheduler cost hints for ONE resonator sweep over `n` queries.

    unbind -> codebook scores -> projection -> convergence check, sized per
    the algebra.  With shards the dims are per device of a ``data x model``
    mesh and the cross-shard reductions appear as ``collective`` ops.
    ``fused`` (default: :func:`fused_sweep_eligible`) marks the projection's
    codebook read as resident on chip, as the fused kernel keeps it.
    """
    from repro_torch.core.scheduler import Op
    if fused is None:
        fused = fused_sweep_eligible(cfg)
    F, M, D = cfg.num_factors, cfg.codebook_size, cfg.vsa.dim
    n_loc = -(-n // data_shards)
    m_loc = -(-M // model_shards)
    ops = []
    if cfg.algebra == "unitary":
        ops.append(Op("unbind", "circconv", (n_loc * F * cfg.vsa.blocks,
                                             cfg.vsa.lanes), symbolic=True))
    else:
        ops.append(Op("unbind", "simd", (n_loc * F * D,), symbolic=True))
    ops.append(Op("scores", "gemm", (n_loc * F, D, m_loc), deps=("unbind",),
                  symbolic=True))
    ops.append(Op("project", "gemm", (n_loc * F, m_loc, D), deps=("scores",),
                  symbolic=True, weight_resident=fused))
    conv_dep = "project"
    if model_shards > 1:
        ops.append(Op("psum_scores", "collective",
                      (4 * n_loc * F * (M + D), model_shards),
                      deps=("project",), symbolic=True))
        ops.append(Op("psum_recon", "collective",
                      (4 * n_loc * F * D, model_shards),
                      deps=("psum_scores",), symbolic=True))
        conv_dep = "psum_recon"
    ops.append(Op("converge", "simd", (n_loc * D,), deps=(conv_dep,),
                  symbolic=True))
    return ops


class Resonator(NamedTuple):
    """Stepwise resonator machinery over a fixed codebook set.

    All members are closures over (codebooks, cfg, valid_mask), shared by
    the one-shot :func:`factorize_batch` loop and by
    :class:`repro_torch.engine.Engine`'s continuous-batching sweeps.
    """

    init: "object"  # (qs [N, D], keys [N, 2]) -> _State
    sweep: "object"  # (qs, state) -> state      one full factor sweep + freeze
    active: "object"  # (state) -> [N] bool      rows that still make progress
    decode: "object"  # (qs, state) -> FactorizerResult
    refill: "object"  # (qs, state, slot, q, key) -> (qs, state)  slot a query
    refill_many: "object"  # (qs, state, slots [K], qs [K, D], keys [K, 2])


def _dense(codebooks) -> torch.Tensor:
    return codebooks.dequantize() if isinstance(codebooks, QTensor) else codebooks


def superposition_init(codebooks, cfg: FactorizerConfig,
                       valid_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Zero-information starting estimate [F, D]: bundle of all valid atoms."""
    dense_cb = _dense(codebooks)
    if cfg.algebra == "bipolar":
        dense_cb = vsa.normalize_sign(dense_cb)
    if valid_mask is None:
        valid_mask = torch.ones(dense_cb.shape[:2], dtype=torch.bool,
                                device=dense_cb.device)
    return _norm(torch.einsum("fm,fmd->fd", valid_mask.to(dense_cb.dtype),
                              dense_cb), cfg)


_NEG = -1e9  # score of an invalid codebook row: never the argmax


def _active(cfg: FactorizerConfig, s: _State) -> torch.Tensor:
    return torch.logical_and(~s.done, s.iters < cfg.max_iters)


_NO_SPAN = contextlib.nullcontext()  # reusable; yields None


def _no_span(name: str):
    """The span factory of an untraced resonator: records nothing."""
    return _NO_SPAN


def _fft_plans(device: torch.device) -> int | None:
    """Plans in cuFFT's plan cache of ``device``; None off the card."""
    if device.type != "cuda":
        return None
    return torch.backends.cuda.cufft_plan_cache[device.index].size


def _noise(s: _State, tag: int, F: int, n: int, std: float):
    """Per factor, standard normals [N, n] of stream ``tag`` at each row's
    own sweep index; F Nones where ``std`` is 0."""
    if not std:
        return [None] * F
    return rng.normal(s.keys, s.iters, tag, F, n).unbind(1)


def _settle(cfg: FactorizerConfig, qs, s: _State, alpha, est,
            atoms, span=_no_span) -> _State:
    """The end of a sweep, shared by both modes: do the hard-decoded atoms
    ``atoms`` [N, F, D] reconstruct each query?  Then freeze converged and
    budget-exhausted rows, and restart stuck ones (in a ``restart`` span of
    the factory ``span``; see :func:`make_resonator`)."""
    sim = vsa.similarity(vsa.bind_all(atoms, cfg.vsa, axis=-2), qs)  # [N]
    act = _active(cfg, s)
    # Freeze converged / budget-exhausted queries: est/sim/iters stop.
    est = torch.where(act[:, None, None], est, s.est)
    sim = torch.where(act, sim, s.sim)
    iters = s.iters + act.to(torch.int32)
    done = s.done | (sim >= cfg.conv_threshold)
    if cfg.restart_every > 0:  # escape limit cycles by re-randomising
        do_restart = act & ~done & (iters % cfg.restart_every == 0)
        rows = torch.nonzero(do_restart).squeeze(1)  # one host sync
        if rows.numel():
            with span("restart") as sp:
                plans = None if sp is None else _fft_plans(est.device)
                F, D = est.shape[1:]
                z = rng.normal(s.keys[rows], iters[rows], rng.RESTART, F, D)
                est[rows] = _norm(z, cfg)  # est is this sweep's own tensor
                if sp is not None:
                    sp.args["rows"] = rows.numel()
                    if plans is not None:
                        sp.args["fft_plans"] = _fft_plans(est.device) - plans
    return _State(est, iters, done, sim, s.keys, s.it + 1)


def _init_state(init_est, qs, keys) -> _State:
    N, (F, D), dev = qs.shape[0], init_est.shape, init_est.device
    keys = torch.as_tensor(keys, dtype=torch.int64, device=dev)
    rng.check_keys(keys)
    return _State(init_est.expand(N, F, D).clone(),
                  torch.zeros(N, dtype=torch.int32, device=dev),
                  torch.zeros(N, dtype=torch.bool, device=dev),
                  torch.full((N,), -1.0, dtype=torch.float32, device=dev),
                  keys, 0)


def _refill_state(init_est, qs, s: _State, slots, new_qs, keys):
    """Slot fresh queries into rows ``slots``; new ``(qs, state)``, the
    inputs untouched."""
    dev = init_est.device
    slots = torch.as_tensor(slots, dtype=torch.long, device=dev)
    qs, est = qs.clone(), s.est.clone()
    iters, done, sim = s.iters.clone(), s.done.clone(), s.sim.clone()
    skeys = s.keys.clone()
    keys = torch.as_tensor(keys, dtype=torch.int64, device=dev)
    rng.check_keys(keys)
    qs[slots] = new_qs
    est[slots] = init_est
    iters[slots] = 0
    done[slots] = False
    sim[slots] = -1.0
    skeys[slots] = keys
    return qs, _State(est, iters, done, sim, skeys, s.it)


def make_resonator(codebooks, cfg: FactorizerConfig,
                   valid_mask: torch.Tensor | None = None, *,
                   model_axis=None, full_rows: int | None = None,
                   init_est: torch.Tensor | None = None,
                   fused=None, span=None) -> Resonator:
    """Build the sweep machinery for one codebook set (see :class:`Resonator`).

    A query row freezes once it converges (``done``) or exhausts its
    per-query iteration budget, so rows slotted in at different times
    (engine serving) each get the full ``cfg.max_iters`` budget and follow
    the trajectory of a solo :func:`factorize` call.

    ``codebooks`` is a dense ``[F, M, D]`` tensor or a :class:`QTensor`;
    quantized codebooks never take the fused sweep.  ``fused`` is an
    optional :class:`repro_torch.kernels.resonator_step.ops.FusedConfig`
    for configs where :func:`fused_sweep_eligible` holds: unmasked batches
    run the dense kernel, masked ones the mask-aware one.  All tensors stay
    on the codebooks' device.

    **Model-sharded mode**: ``model_axis`` is a mesh's model axis
    (``mesh.axis("model")``) and ``codebooks`` one dense row block
    ``[F, M / model, D]`` per model shard, in shard order; ``valid_mask``
    stays FULL ``[F, M]`` and ``full_rows`` gives M where there is no mask.
    ``init_est`` is required, computed by :func:`superposition_init` from the
    full codebooks (a shard-wise bundle would sum in another order).  Block
    m is placed on the device of every shard (d, m).  Each member then takes
    and returns a sequence with one entry per data shard (queries, states,
    keys, slot lists, results), on the device of shard (d, 0); ``refill``,
    the single-slot form, is None (``refill_many`` serves).  Each factor
    update scores the local rows on each model shard and issues ONE model
    reduction carrying (zero-padded local scores, partial projection)
    where ``noise_std == 0`` and the activation is elementwise, else two
    (score noise and softmax need the gathered scores first).  The padded
    score gather is exact (disjoint supports); the projection's sum is the
    one place the fp sum is reassociated: integer-exact for bipolar
    codebooks, last-ulp for unitary ones.  Convergence gathers the F decoded
    atom rows with one more (one-hot) reduction.  A fused-eligible config
    runs one ``fused_resonator_step_batch_local`` launch per shard per
    sweep, then the same F packed reductions.

    ``span`` is an optional span factory, ``span(name)`` giving a context
    manager that yields the live span or None (the Engine's, over its
    ``obs`` recorder).  The plain stepwise sweep then records, inside it,
    ``rng`` (the sweep's noise draws, where it draws any),
    ``factor-update`` (arg ``factor``) for each factor, and ``settle``
    with ``restart`` inside it on sweeps where rows restart (args ``rows``
    and, on the card, ``fft_plans``: the plans cuFFT's plan cache gained).
    The fused and model-sharded sweeps record none.  Without it nothing is
    recorded.
    """
    if cfg.max_iters >= rng.MAX_SWEEP:
        raise ValueError(f"max_iters={cfg.max_iters} exceeds the noise "
                         f"counter's {rng.MAX_SWEEP} sweeps")
    if model_axis is not None:
        return _sharded_resonator(codebooks, cfg, valid_mask, model_axis,
                                  full_rows, init_est, fused)
    vcfg = cfg.vsa
    dev = codebooks.device
    quantized = isinstance(codebooks, QTensor)
    use_int8_kernel = quantized and codebooks.values.dtype == torch.int8
    dense_cb = _dense(codebooks)
    if cfg.algebra == "bipolar":
        dense_cb = vsa.normalize_sign(dense_cb)  # de-quantised atoms stay bipolar
    F, M, D = dense_cb.shape
    no_mask = valid_mask is None
    if no_mask:
        valid_mask = torch.ones((F, M), dtype=torch.bool, device=dev)
    valid_mask = valid_mask.to(device=dev, dtype=torch.bool)
    neg = torch.tensor(_NEG, dtype=torch.float32, device=dev)
    if init_est is None:
        init_est = superposition_init(codebooks, cfg, valid_mask)
    init_est = init_est.to(dev)
    use_fused = fused_sweep_eligible(cfg) and not quantized
    factor_ids = torch.arange(F, device=dev)
    span = span or _no_span
    draws = bool(cfg.noise_std or cfg.proj_noise_std)

    def factor_update(qs, i: int, est: torch.Tensor, z_sim, z_proj):
        """One factor's unbind -> score -> project update for the whole batch;
        ``z_sim`` [N, M] / ``z_proj`` [N, D] are this factor's standard
        normals (None without that noise).  Returns (alpha_i [N, M],
        new_est_i [N, D])."""
        with span("factor-update") as sp:
            if sp is not None:
                sp.args["factor"] = i
            unbound = _unbind(qs, est, cfg, factor=i)  # [N, D]      (Step 1)
            if use_int8_kernel:  # the similarity_int8 kernel on the card
                from repro_torch.kernels.similarity import ops as sim_ops

                alpha = sim_ops.codebook_scores(unbound, codebooks[i])
            elif quantized:
                alpha = quantized_matvec(unbound, codebooks[i])
            else:
                alpha = unbound @ dense_cb[i].T
            alpha = torch.where(valid_mask[i], alpha, neg)  #        (Step 2)
            if z_sim is not None:  # stochasticity, relative to score spread
                sigma = cfg.noise_std * torch.std(
                    torch.where(valid_mask[i], alpha, 0.0), dim=-1,
                    keepdim=True, correction=0)
                alpha = torch.where(valid_mask[i], alpha + sigma * z_sim,
                                    alpha)
            w = _activation(alpha, cfg) * valid_mask[i]
            new_est = w @ dense_cb[i]  #                             (Step 3)
            if z_proj is not None:
                sigma = cfg.proj_noise_std * torch.std(
                    new_est, dim=-1, keepdim=True, correction=0)
                new_est = new_est + sigma * z_proj
            return alpha, _norm(new_est, cfg)

    def active(s: _State) -> torch.Tensor:
        return _active(cfg, s)

    def sweep(qs, s: _State) -> _State:
        est = s.est
        if use_fused:  # one kernel launch for all F factors on the card
            from repro_torch.kernels.resonator_step import ops as rs

            if no_mask:
                alpha, est = rs.fused_resonator_step_batch(
                    qs, est, dense_cb, activation=cfg.activation, fused=fused)
            else:
                alpha, est = rs.fused_resonator_step_batch_masked(
                    qs, est, dense_cb, valid_mask, activation=cfg.activation,
                    fused=fused)
        else:
            with span("rng") if draws else _NO_SPAN:
                z_sim = _noise(s, rng.SCORES, F, M, cfg.noise_std)
                z_proj = _noise(s, rng.PROJECTION, F, D, cfg.proj_noise_std)
            if cfg.synchronous:  # Jacobi: all factors from the same snapshot
                outs = [factor_update(qs, i, est, z_sim[i], z_proj[i])
                        for i in range(F)]
                alpha = torch.stack([o[0] for o in outs], dim=1)
                est = torch.stack([o[1] for o in outs], dim=1)
            else:  # Gauss-Seidel: each factor sees the freshest estimates
                est = est.clone()
                alphas = []
                for i in range(F):
                    alpha_i, est[:, i] = factor_update(qs, i, est, z_sim[i],
                                                       z_proj[i])
                    alphas.append(alpha_i)
                alpha = torch.stack(alphas, dim=1)
        idx = torch.argmax(alpha, dim=-1)  # [N, F] first maximum on ties
        atoms = dense_cb[factor_ids, idx]
        if use_fused:
            return _settle(cfg, qs, s, alpha, est, atoms)
        with span("settle"):
            return _settle(cfg, qs, s, alpha, est, atoms, span)

    def init(qs, keys) -> _State:
        return _init_state(init_est, qs, keys)

    def decode(qs, s: _State) -> FactorizerResult:
        """Final decode from the (frozen) estimates."""
        unbound = _unbind(qs, s.est, cfg)  # [N, F, D]
        alpha = torch.einsum("nfd,fmd->nfm", unbound, dense_cb)
        alpha = torch.where(valid_mask[None], alpha, neg)
        idx = torch.argmax(alpha, dim=-1).to(torch.int32)
        recon = vsa.bind_all(dense_cb[factor_ids, idx.long()], vcfg, axis=-2)
        return FactorizerResult(idx, s.iters, s.done,
                                vsa.similarity(recon, qs), alpha)

    def refill_many(qs, s: _State, slots, new_qs, keys):
        """Slot fresh queries into rows ``slots`` (int [K], each in range)
        for engine continuous batching; returns new ``(qs, state)`` and
        leaves the inputs untouched."""
        return _refill_state(init_est, qs, s, slots, new_qs, keys)

    def refill(qs, s: _State, slot, q, key):
        """Single-slot :func:`refill_many`."""
        return refill_many(qs, s, [slot], q[None],
                           torch.as_tensor(key, dtype=torch.int64)[None])

    return Resonator(init, sweep, active, decode, refill, refill_many)


def _sharded_resonator(blocks, cfg: FactorizerConfig, valid_mask, axis,
                       full_rows, init_est, fused) -> Resonator:
    """The model-sharded mode of :func:`make_resonator` (see there)."""
    if isinstance(blocks, (torch.Tensor, QTensor)) or any(
            isinstance(b, QTensor) for b in blocks):
        raise ValueError("model-sharded resonator requires dense codebooks, "
                         "one [F, M / model, D] tensor per model shard "
                         "(quantized rows would need their scales resharded "
                         "too)")
    if axis.name != "model":
        raise ValueError(f"codebook rows shard over the model axis, not "
                         f"{axis.name!r}")
    if init_est is None:
        raise ValueError("model-sharded resonator needs init_est from "
                         "superposition_init(full_codebooks, ...)")
    if valid_mask is None and full_rows is None:
        raise ValueError("model-sharded resonator needs the full row count: "
                         "pass full_rows= (or a full valid_mask)")
    mesh = axis.mesh
    devs = mesh.devices
    n_data, n_model = mesh.shape["data"], axis.size
    if len(blocks) != n_model:
        raise ValueError(f"{len(blocks)} codebook blocks for {n_model} model "
                         "shards")
    F, M_loc, D = blocks[0].shape
    if any(tuple(b.shape) != (F, M_loc, D) for b in blocks):
        raise ValueError("every model shard's block must have the same shape")
    M = valid_mask.shape[1] if valid_mask is not None else full_rows
    if M != M_loc * n_model:
        raise ValueError(f"codebook rows {M} don't tile into {n_model} local "
                         f"shards of {M_loc}")
    if valid_mask is None:
        valid_mask = torch.ones((F, M), dtype=torch.bool)
    valid_mask = valid_mask.to(torch.bool)
    offs = [m * M_loc for m in range(n_model)]
    homes = [row[0] for row in devs]
    on_dev: dict = {}  # (model shard, device) -> block: one copy per device

    def block(m, dev):
        if (m, dev) not in on_dev:
            b = blocks[m].to(dev)
            if cfg.algebra == "bipolar":
                b = vsa.normalize_sign(b)
            on_dev[(m, dev)] = b.contiguous()
        return on_dev[(m, dev)]

    cb = [[block(m, devs[d][m]) for m in range(n_model)] for d in range(n_data)]
    mask_home = [valid_mask.to(h) for h in homes]
    mask_loc = [[valid_mask[:, o:o + M_loc].to(devs[d][m])
                 for m, o in enumerate(offs)] for d in range(n_data)]
    init_home = [init_est.to(h) for h in homes]
    one_reduction = (cfg.noise_std == 0
                     and cfg.activation in ("identity", "abs", "relu"))
    use_fused = fused_sweep_eligible(cfg)
    grid = [(d, m) for d in range(n_data) for m in range(n_model)]

    def per_data(xs, what):
        xs = list(xs)
        if len(xs) != n_data:
            raise ValueError(f"{what}: {len(xs)} entries for {n_data} data "
                             "shards")
        return xs

    def on_shards(fn):
        """``fn(d, m)`` on every shard, as a [data][model] grid."""
        out = [[None] * n_model for _ in range(n_data)]
        for d, m in grid:
            out[d][m] = fn(d, m)
        return out

    def reduced(parts):
        """One model reduction; each data shard's sum on its home device."""
        return [row[0] for row in axis.reduce(parts)]

    def pad(a_loc, m):  # local scores at the shard's offset of [..., M]
        return nnf.pad(a_loc, (offs[m], M - offs[m] - M_loc))

    def packed_split(packed, d, i):
        """(masked full scores, gathered projection) of one packed sum; the
        projection made contiguous, as the dense path's is (an FFT of a
        strided input rounds differently on the CPU)."""
        return (torch.where(mask_home[d][i], packed[:, :M], _NEG),
                packed[:, M:].contiguous())

    def factor_update(qs, i: int, est, z_sim, z_proj):
        """Factor i's update on every data shard: (alpha_i [N, M],
        new_est_i [N, D]) per data shard."""
        unbound = [_unbind(q, e, cfg, factor=i) for q, e in zip(qs, est)]
        a_loc = on_shards(lambda d, m: unbound[d].to(devs[d][m])
                          @ cb[d][m][i].T)  # [N, M_loc]      (Step 2)
        if one_reduction:  # the local weights need no other shard's scores
            def packed(d, m):
                mk = mask_loc[d][m][i]
                w = _activation(torch.where(mk, a_loc[d][m], _NEG), cfg) * mk
                return torch.cat([pad(a_loc[d][m], m), w @ cb[d][m][i]], -1)

            alpha, new = zip(*(packed_split(p, d, i) for d, p in
                               enumerate(reduced(on_shards(packed)))))
        else:  # score noise and softmax need the gathered scores first
            alpha, w = [], []
            for d, a in enumerate(reduced(on_shards(
                    lambda d, m: pad(a_loc[d][m], m)))):
                mk = mask_home[d][i]
                a = torch.where(mk, a, _NEG)
                if z_sim[d] is not None:  # keys hold per row: drawn once
                    sigma = cfg.noise_std * torch.std(
                        torch.where(mk, a, 0.0), dim=-1, keepdim=True,
                        correction=0)
                    a = torch.where(mk, a + sigma * z_sim[d], a)
                alpha.append(a)
                w.append(_activation(a, cfg) * mk)
            new = reduced(on_shards(
                lambda d, m: w[d][:, offs[m]:offs[m] + M_loc].to(devs[d][m])
                @ cb[d][m][i]))  #                                (Step 3)
        ests = []
        for d, n in enumerate(new):
            if z_proj[d] is not None:
                sigma = cfg.proj_noise_std * torch.std(n, dim=-1, keepdim=True,
                                                       correction=0)
                n = n + sigma * z_proj[d]
            ests.append(_norm(n, cfg))
        return list(alpha), ests

    def hard_atoms(idx):
        """Decoded atom rows [N, F, D] per data shard for indices [N, F]:
        a one-hot contraction on each model shard, summed by one reduction
        (exact: every non-owning shard contributes zeros)."""
        def local(d, m):
            dev = devs[d][m]
            loc = idx[d].to(dev) - offs[m]
            onehot = (loc[..., None] == torch.arange(M_loc, device=dev))
            return torch.einsum("nfm,fmd->nfd", onehot.to(cb[d][m].dtype),
                                cb[d][m]).contiguous()  # the gather's layout
        return reduced(on_shards(local))

    def active(ss):
        return [_active(cfg, s) for s in per_data(ss, "states")]

    def sweep(qs, ss):
        qs, ss = per_data(qs, "queries"), per_data(ss, "states")
        est = [s.est for s in ss]
        if use_fused:  # one local kernel launch per shard, then F packs
            from repro_torch.kernels.resonator_step import ops as rs

            outs = on_shards(lambda d, m: rs.fused_resonator_step_batch_local(
                qs[d].to(devs[d][m]), est[d].to(devs[d][m]), cb[d][m],
                mask_loc[d][m], activation=cfg.activation, fused=fused))
            alphas, ests = [[] for _ in ss], [[] for _ in ss]
            for i in range(F):
                sums = reduced(on_shards(lambda d, m: torch.cat(
                    [pad(outs[d][m][0][:, i], m), outs[d][m][1][:, i]], -1)))
                for d, p in enumerate(sums):
                    a, n = packed_split(p, d, i)
                    alphas[d].append(a)
                    ests[d].append(_norm(n, cfg))
            alpha = [torch.stack(a, dim=1) for a in alphas]
            est = [torch.stack(e, dim=1) for e in ests]
        else:
            z_sim = [_noise(s, rng.SCORES, F, M, cfg.noise_std) for s in ss]
            z_proj = [_noise(s, rng.PROJECTION, F, D, cfg.proj_noise_std)
                      for s in ss]
            if cfg.synchronous:  # Jacobi: all factors from the same snapshot
                outs = [factor_update(qs, i, est, [z[i] for z in z_sim],
                                      [z[i] for z in z_proj])
                        for i in range(F)]
                alpha = [torch.stack([o[0][d] for o in outs], dim=1)
                         for d in range(n_data)]
                est = [torch.stack([o[1][d] for o in outs], dim=1)
                       for d in range(n_data)]
            else:  # Gauss-Seidel: each factor sees the freshest estimates
                est = [e.clone() for e in est]
                alphas = [[] for _ in ss]
                for i in range(F):
                    a_i, e_i = factor_update(qs, i, est, [z[i] for z in z_sim],
                                             [z[i] for z in z_proj])
                    for d in range(n_data):
                        est[d][:, i] = e_i[d]
                        alphas[d].append(a_i[d])
                alpha = [torch.stack(a, dim=1) for a in alphas]
        idx = [torch.argmax(a, dim=-1) for a in alpha]  # first max on ties
        atoms = hard_atoms(idx)
        return [_settle(cfg, qs[d], ss[d], alpha[d], est[d], atoms[d])
                for d in range(n_data)]

    def init(qs, keys):
        return [_init_state(i, q, k) for i, q, k in
                zip(init_home, per_data(qs, "queries"), per_data(keys, "keys"))]

    def decode(qs, ss):
        """Final decode: each shard's local-row scores, padded and gathered
        by one reduction; the decoded atoms by one more."""
        qs, ss = per_data(qs, "queries"), per_data(ss, "states")
        unbound = [_unbind(q, s.est, cfg) for q, s in zip(qs, ss)]
        alpha = [torch.where(mask_home[d][None], a, _NEG)
                 for d, a in enumerate(reduced(on_shards(lambda d, m: pad(
                     torch.einsum("nfd,fmd->nfm", unbound[d].to(devs[d][m]),
                                  cb[d][m]), m))))]
        idx = [torch.argmax(a, dim=-1).to(torch.int32) for a in alpha]
        atoms = hard_atoms([i.long() for i in idx])
        return [FactorizerResult(
            idx[d], ss[d].iters, ss[d].done,
            vsa.similarity(vsa.bind_all(atoms[d], cfg.vsa, axis=-2), qs[d]),
            alpha[d]) for d in range(n_data)]

    def refill_many(qs, ss, slots, new_qs, keys):
        """Per data shard: slot ``new_qs[d]`` into local rows ``slots[d]``;
        shards with no rows pass through."""
        qs, ss = per_data(qs, "queries"), per_data(ss, "states")
        for d, (sl, nq, k) in enumerate(zip(per_data(slots, "slots"),
                                            per_data(new_qs, "queries"),
                                            per_data(keys, "keys"))):
            if len(sl):
                qs[d], ss[d] = _refill_state(init_home[d], qs[d], ss[d], sl,
                                             nq, k)
        return qs, ss

    return Resonator(init, sweep, active, decode, None, refill_many)


def draw_keys(generator, n: int) -> torch.Tensor:
    """``n`` per-query keys, int64 ``[n, 2]``, drawn on the CPU from a
    ``torch.Generator`` (or an int seed)."""
    return torch.randint(0, 2 ** 62, (n, 2), generator=as_generator(generator),
                         dtype=torch.int64)


def _factorize_batched(qs, codebooks, keys, cfg, valid_mask) -> FactorizerResult:
    """Batch-native core: ONE loop over state [N, F, D] until no row is
    active (converged or out of budget)."""
    rs = make_resonator(codebooks, cfg, valid_mask)
    s = rs.init(qs, keys)
    while bool(rs.active(s).any()):
        s = rs.sweep(qs, s)
    return rs.decode(qs, s)


def _on(device, qs, codebooks, valid_mask):
    dev = resolve(device)
    qs = torch.as_tensor(qs, dtype=torch.float32, device=dev)
    if isinstance(codebooks, (torch.Tensor, QTensor)):
        codebooks = codebooks.to(dev)
    if valid_mask is not None:
        valid_mask = torch.as_tensor(valid_mask, device=dev)
    return qs, codebooks, valid_mask


def factorize(q, codebooks, generator: torch.Generator, cfg: FactorizerConfig,
              valid_mask=None, *, device=DEFAULT_DEVICE) -> FactorizerResult:
    """Factorise one query vector q [D] into one atom index per factor.

    Thin N=1 wrapper over the batched core.  ``codebooks`` is a dense
    [F, M, D] tensor or an int8/fp8 :class:`QTensor` of the same logical
    shape (Tab. IX).  ``valid_mask`` [F, M] marks real atoms when factors
    have different cardinalities and codebooks are padded to a common M.
    """
    qs, codebooks, valid_mask = _on(device, q, codebooks, valid_mask)
    res = _factorize_batched(qs[None], codebooks, draw_keys(generator, 1), cfg,
                             valid_mask)
    return FactorizerResult(*(x[0] for x in res))


def factorize_batch(qs, codebooks, generator: torch.Generator,
                    cfg: FactorizerConfig, valid_mask=None, *,
                    device=DEFAULT_DEVICE) -> FactorizerResult:
    """Factorise a batch of queries [N, D] in ONE loop; one key per query is
    drawn from ``generator``.  Converged queries freeze behind the per-query
    done mask instead of re-running to the batch-max iteration count."""
    qs, codebooks, valid_mask = _on(device, qs, codebooks, valid_mask)
    return _factorize_batched(qs, codebooks, draw_keys(generator, qs.shape[0]),
                              cfg, valid_mask)


def quantize_codebooks(codebooks: torch.Tensor, fmt: str) -> QTensor:
    """Per-atom quantisation of [F, M, D] codebooks (Tab. IX memory saving)."""
    return quantize(codebooks, fmt)


def codebook_bytes(cfg: FactorizerConfig) -> dict:
    """Memory footprint: factorised codebooks vs the exhaustive product codebook."""
    itemsize = {"fp32": 4, "int8": 1, "fp8_e4m3": 1}[cfg.codebook_fmt]
    fact = cfg.num_factors * cfg.codebook_size * cfg.vsa.dim * itemsize
    product = (cfg.codebook_size ** cfg.num_factors) * cfg.vsa.dim * itemsize
    return {"factorized_bytes": fact, "product_bytes": product,
            "reduction": product / max(fact, 1)}
