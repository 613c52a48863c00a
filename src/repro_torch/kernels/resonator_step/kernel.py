"""Wrappers of the CUDA fused resonator sweep (``csrc/resonator_step.cu``).

Three variants of one kernel: dense, masked, and local (one model shard's
codebook rows, raw scores and the fp32 partial projection out).  Each
wrapper checks its inputs, allocates the outputs with ``torch.empty``,
launches the kernel on the current stream and bumps its launch count in
:mod:`.ops`.  They take CUDA tensors only: the CPU path lives in
:mod:`.ops`, which sends CPU tensors to the plain versions in :mod:`.ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

WARPS = 8  # warps per block, kWarps in the source
MAX_M = 1024  # codebook rows the design supports
SMEM_BUDGET = 200 * 1024  # dynamic shared memory a block may take (of 227 KB)
_INT_MAX = 2 ** 31 - 1


def launch_geometry(n: int, f: int, m: int, d: int, tn: int,
                    sms: int) -> tuple:
    """``(rows, dc, smem_bytes)`` of one launch.

    ``rows`` (rows per block) is the largest power of two up to the ceiling
    ``tn`` that still gives at least one block per SM; ``dc`` is the chunk of
    D staged in shared memory: all of D where ``M * D`` fits, else the
    largest multiple of 32 that does.  Raises ``ValueError`` for shapes
    beyond the design.
    """
    if min(n, f, d) < 1:
        raise ValueError(f"need N, F, D >= 1, got N={n} F={f} D={d}")
    if not 1 <= m <= MAX_M:
        raise ValueError(f"codebook rows M={m} outside the supported 1..{MAX_M}")
    if f > 65535:
        raise ValueError(f"F={f} exceeds the grid's 65535 factor blocks")
    if n * f * max(m, d) > _INT_MAX:
        raise ValueError(f"N*F*max(M, D) = {n * f * max(m, d)} exceeds 2^31-1")
    if tn < 1:
        raise ValueError(f"row ceiling tn must be >= 1, got {tn}")

    def fixed(rows):  # shared floats besides the codebook chunk
        return (rows * max(1, WARPS // rows) + rows) * m

    rows = 1
    while (rows * 2 <= tn and -(-n // (rows * 2)) * f >= sms
           and 4 * (fixed(rows * 2) + m * min(d, 32)) <= SMEM_BUDGET):
        rows *= 2
    dc = (SMEM_BUDGET // 4 - fixed(rows)) // m
    dc = d if dc >= d else dc // 32 * 32
    return rows, dc, 4 * (m * dc + fixed(rows))


def _check(name, t, shape):
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor (the plain version in "
                         "ref.py serves CPU tensors)")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(qs, est, codebooks, mask, activation, tn, local=False):
    if activation not in ("identity", "abs"):
        raise ValueError(f"fused sweep takes activation identity|abs, got "
                         f"{activation!r}")
    if not isinstance(codebooks, torch.Tensor) or codebooks.dim() != 3:
        raise ValueError("codebooks must be an [F, M, D] tensor")
    F, M, D = codebooks.shape
    N = qs.shape[0]
    _check("codebooks", codebooks, (F, M, D))
    _check("qs", qs, (N, D))
    _check("est", est, (N, F, D))
    if mask is not None:
        _check("valid_mask", mask, (F, M))
    devs = {t.device for t in (qs, est, codebooks, mask) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {sorted(map(str, devs))}")
    dev = qs.device
    rows, dc, _ = launch_geometry(
        N, F, M, D, tn, torch.cuda.get_device_properties(dev).multi_processor_count)
    alpha = torch.empty((N, F, M), dtype=torch.float32, device=dev)
    new_est = torch.empty((N, F, D), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.resonator_step_launch(
            qs.data_ptr(), est.data_ptr(), codebooks.data_ptr(),
            None if mask is None else mask.data_ptr(),
            alpha.data_ptr(), new_est.data_ptr(), N, F, M, D, rows, dc,
            int(activation == "abs"), int(local), stream)
    if rc != 0:
        raise RuntimeError(f"resonator_step launch failed: CUDA error {rc} "
                           f"({lib.resonator_step_error_string(rc).decode()})")
    return alpha, new_est


def _lib() -> ctypes.CDLL:
    lib = _build.load("resonator_step")
    fn = lib.resonator_step_launch
    if fn.argtypes is None:  # first use in this process
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.resonator_step_error_string.argtypes = [ctypes.c_int]
        lib.resonator_step_error_string.restype = ctypes.c_char_p
    return lib


def resonator_step_batch(qs: torch.Tensor, est: torch.Tensor,
                         codebooks: torch.Tensor, *,
                         activation: str = "identity", tn: int = 128):
    """One fused Jacobi sweep.  qs: [N, D]; est: [N, F, D] bipolar;
    codebooks: [F, M, D] -> (alpha [N, F, M], new_est [N, F, D])."""
    from repro_torch.kernels.resonator_step import ops

    out = _launch(qs, est, codebooks, None, activation, tn)
    ops.launches += 1
    return out


def resonator_step_batch_masked(qs: torch.Tensor, est: torch.Tensor,
                                codebooks: torch.Tensor,
                                valid_mask: torch.Tensor, *,
                                activation: str = "identity", tn: int = 128):
    """Mask-aware fused sweep.  valid_mask: [F, M] bool or {0,1} -> (alpha
    [N, F, M] with invalid rows at -1e9, new_est [N, F, D])."""
    from repro_torch.kernels.resonator_step import ops

    mask = valid_mask.to(torch.float32).contiguous() \
        if isinstance(valid_mask, torch.Tensor) else valid_mask
    out = _launch(qs, est, codebooks, mask, activation, tn)
    ops.masked_launches += 1
    return out


def resonator_step_batch_local(qs: torch.Tensor, est: torch.Tensor,
                               cb_local: torch.Tensor,
                               valid_mask_local: torch.Tensor | None = None,
                               *, activation: str = "identity",
                               tn: int = 128):
    """Fused sweep over ONE model shard's codebook rows.  cb_local:
    [F, M_loc, D]; valid_mask_local: [F, M_loc] bool or {0,1} (None: all
    valid) -> (alpha_loc [N, F, M_loc] raw, part_proj [N, F, D] fp32, not
    saturated)."""
    from repro_torch.kernels.resonator_step import ops

    if valid_mask_local is None:
        valid_mask_local = torch.ones(cb_local.shape[:2], device=qs.device)
    mask = valid_mask_local.to(torch.float32).contiguous()
    out = _launch(qs, est, cb_local, mask, activation, tn, local=True)
    ops.local_launches += 1
    return out


def resonator_step(q: torch.Tensor, est: torch.Tensor, codebooks: torch.Tensor,
                   *, activation: str = "identity"):
    """Single-query wrapper: q: [D]; est: [F, D] bipolar; codebooks:
    [F, M, D] -> (alpha [F, M], new_est [F, D])."""
    alpha, new_est = resonator_step_batch(q[None], est[None], codebooks,
                                          activation=activation)
    return alpha[0], new_est[0]
