"""Public entry points of the fused resonator sweep.

A tensor on the CPU goes to the plain version (:mod:`.ref`); a CUDA tensor
goes to the hand-written kernel (:mod:`.kernel`), which launches or raises.
There is no third path and no fallback.  Under autograd with an operand
that requires grad every entry point raises
(:func:`repro_torch.kernels.refuse_grad`).

``launches``, ``masked_launches`` and ``local_launches`` count the kernel
launches of the dense, the masked and the model-shard wrapper (plain
integers, bumped by :mod:`.kernel` once per launch), so a run can show that
its sweeps went through the kernel.
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.resonator_step import kernel as _k
from repro_torch.kernels.resonator_step import ref as _ref

launches = 0  # dense kernel launches in this process
masked_launches = 0  # masked kernel launches in this process
local_launches = 0  # model-shard kernel launches in this process


@dataclasses.dataclass(frozen=True)
class FusedConfig:
    """Kernel-level knobs for the fused resonator sweep.

    ``tn`` is the ceiling on the rows of a cluster's tile
    (:func:`.kernel.launch_geometry` picks the tile's rows below it).
    """

    tn: int = 128


DEFAULT_FUSED = FusedConfig()


def _cfg(fused: FusedConfig | None) -> FusedConfig:
    if fused is None:
        return DEFAULT_FUSED
    if not isinstance(fused, FusedConfig):
        raise TypeError(
            f"fused= expects a FusedConfig or None, got {fused!r}; to "
            "request the fused sweep set fused_step=True on the "
            "FactorizerConfig / spec builder")
    return fused


def fused_resonator_step_batch(qs, est, codebooks, activation: str = "identity",
                               fused: FusedConfig | None = None):
    """One fused Jacobi resonator sweep over a query batch (bipolar algebra).

    qs: [N, D]; est: [N, F, D] -> (alpha [N, F, M], new_est [N, F, D]).
    """
    f = _cfg(fused)
    refuse_grad("fused_resonator_step_batch", qs, est, codebooks)
    if qs.device.type == "cpu":
        return _ref.resonator_step_batch_ref(qs, est, codebooks, activation)
    return _k.resonator_step_batch(qs, est, codebooks, activation=activation,
                                   tn=f.tn)


def fused_resonator_step_batch_masked(qs, est, codebooks, valid_mask,
                                      activation: str = "identity",
                                      fused: FusedConfig | None = None):
    """Mask-aware fused sweep: invalid rows are neutralised before the
    activation and zeroed before the projection — bit-comparable to the
    masked two-pass path."""
    f = _cfg(fused)
    refuse_grad("fused_resonator_step_batch_masked", qs, est, codebooks)
    if qs.device.type == "cpu":
        return _ref.resonator_step_batch_masked_ref(qs, est, codebooks,
                                                    valid_mask, activation)
    return _k.resonator_step_batch_masked(qs, est, codebooks, valid_mask,
                                          activation=activation, tn=f.tn)


def fused_resonator_step_batch_local(qs, est, cb_local, valid_mask_local=None,
                                     activation: str = "identity",
                                     fused: FusedConfig | None = None):
    """Fused sweep over one model shard's codebook rows ``[F, M_loc, D]``
    and that shard's mask slice: returns (raw local scores [N, F, M_loc],
    fp32 partial projection [N, F, D]) for the caller's one packed
    reduction per factor (see ``core/factorizer.py``, model-sharded
    mode)."""
    f = _cfg(fused)
    refuse_grad("fused_resonator_step_batch_local", qs, est, cb_local)
    if qs.device.type == "cpu":
        return _ref.resonator_step_batch_local_ref(qs, est, cb_local,
                                                   valid_mask_local, activation)
    return _k.resonator_step_batch_local(qs, est, cb_local, valid_mask_local,
                                         activation=activation, tn=f.tn)


def fused_resonator_step(q, est, codebooks, activation: str = "identity"):
    """One fused Jacobi resonator sweep for a single query (bipolar algebra)."""
    refuse_grad("fused_resonator_step", q, est, codebooks)
    if q.device.type == "cpu":
        return _ref.resonator_step_ref(q, est, codebooks, activation)
    return _k.resonator_step(q, est, codebooks, activation=activation)


resonator_step_ref = _ref.resonator_step_ref
resonator_step_batch_ref = _ref.resonator_step_batch_ref
resonator_step_batch_masked_ref = _ref.resonator_step_batch_masked_ref
resonator_step_batch_local_ref = _ref.resonator_step_batch_local_ref
