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

Not ported yet, and refused with ``NotImplementedError``: the model-sharded
mode (``model_axis``).
"""
from __future__ import annotations

import dataclasses
from typing import Literal, NamedTuple

import torch

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


def _check_supported(cfg: FactorizerConfig, model_axis) -> None:
    if model_axis is not None:
        raise NotImplementedError(
            "the model-sharded resonator (model_axis) waits for the sharded "
            "engine (ROADMAP Queue A: sharded engine)")
    if cfg.max_iters >= rng.MAX_SWEEP:
        raise ValueError(f"max_iters={cfg.max_iters} exceeds the noise "
                         f"counter's {rng.MAX_SWEEP} sweeps")


def make_resonator(codebooks, cfg: FactorizerConfig,
                   valid_mask: torch.Tensor | None = None, *,
                   model_axis: str | None = None, fused=None) -> Resonator:
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
    """
    _check_supported(cfg, model_axis)
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
    neg = torch.tensor(-1e9, dtype=torch.float32, device=dev)
    init_est = superposition_init(codebooks, cfg, valid_mask)
    use_fused = fused_sweep_eligible(cfg) and not quantized
    factor_ids = torch.arange(F, device=dev)

    def factor_update(qs, i: int, est: torch.Tensor, z_sim, z_proj):
        """One factor's unbind -> score -> project update for the whole batch;
        ``z_sim`` [N, M] / ``z_proj`` [N, D] are this factor's standard
        normals (None without that noise).  Returns (alpha_i [N, M],
        new_est_i [N, D])."""
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
                torch.where(valid_mask[i], alpha, 0.0), dim=-1, keepdim=True,
                correction=0)
            alpha = torch.where(valid_mask[i], alpha + sigma * z_sim, alpha)
        w = _activation(alpha, cfg) * valid_mask[i]
        new_est = w @ dense_cb[i]  #                             (Step 3)
        if z_proj is not None:
            sigma = cfg.proj_noise_std * torch.std(new_est, dim=-1,
                                                   keepdim=True, correction=0)
            new_est = new_est + sigma * z_proj
        return alpha, _norm(new_est, cfg)

    def noise(s: _State, tag: int, n: int, std: float):
        """Per factor, standard normals [N, n] of stream ``tag`` at each
        row's own sweep index; F Nones where ``std`` is 0."""
        if not std:
            return [None] * F
        return rng.normal(s.keys, s.iters, tag, F, n).unbind(1)

    def reconstruct(idx: torch.Tensor) -> torch.Tensor:
        return vsa.bind_all(dense_cb[factor_ids, idx], vcfg, axis=-2)

    def active(s: _State) -> torch.Tensor:
        return torch.logical_and(~s.done, s.iters < cfg.max_iters)

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
            z_sim = noise(s, rng.SCORES, M, cfg.noise_std)
            z_proj = noise(s, rng.PROJECTION, D, cfg.proj_noise_std)
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
        # Convergence: do the hard-decoded atoms reconstruct each query?
        idx = torch.argmax(alpha, dim=-1)  # [N, F] first maximum on ties
        sim = vsa.similarity(reconstruct(idx), qs)  # [N]
        act = active(s)
        # Freeze converged / budget-exhausted queries: est/sim/iters stop.
        est = torch.where(act[:, None, None], est, s.est)
        sim = torch.where(act, sim, s.sim)
        iters = s.iters + act.to(torch.int32)
        done = s.done | (sim >= cfg.conv_threshold)
        if cfg.restart_every > 0:  # escape limit cycles by re-randomising
            do_restart = act & ~done & (iters % cfg.restart_every == 0)
            rows = torch.nonzero(do_restart).squeeze(1)  # one host sync
            if rows.numel():
                z = rng.normal(s.keys[rows], iters[rows], rng.RESTART, F, D)
                est[rows] = _norm(z, cfg)  # est is this sweep's own tensor
        return _State(est, iters, done, sim, s.keys, s.it + 1)

    def init(qs, keys) -> _State:
        N = qs.shape[0]
        keys = torch.as_tensor(keys, dtype=torch.int64, device=dev)
        rng.check_keys(keys)
        return _State(init_est.expand(N, F, D).clone(),
                      torch.zeros(N, dtype=torch.int32, device=dev),
                      torch.zeros(N, dtype=torch.bool, device=dev),
                      torch.full((N,), -1.0, dtype=torch.float32, device=dev),
                      keys, 0)

    def decode(qs, s: _State) -> FactorizerResult:
        """Final decode from the (frozen) estimates."""
        unbound = _unbind(qs, s.est, cfg)  # [N, F, D]
        alpha = torch.einsum("nfd,fmd->nfm", unbound, dense_cb)
        alpha = torch.where(valid_mask[None], alpha, neg)
        idx = torch.argmax(alpha, dim=-1).to(torch.int32)
        return FactorizerResult(idx, s.iters, s.done,
                                vsa.similarity(reconstruct(idx.long()), qs),
                                alpha)

    def refill_many(qs, s: _State, slots, new_qs, keys):
        """Slot fresh queries into rows ``slots`` (int [K], each in range)
        for engine continuous batching; returns new ``(qs, state)`` and
        leaves the inputs untouched."""
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

    def refill(qs, s: _State, slot, q, key):
        """Single-slot :func:`refill_many`."""
        return refill_many(qs, s, [slot], q[None],
                           torch.as_tensor(key, dtype=torch.int64)[None])

    return Resonator(init, sweep, active, decode, refill, refill_many)


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
