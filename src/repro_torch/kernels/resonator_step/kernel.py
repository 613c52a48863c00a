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
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

MAX_M = 1024  # codebook rows the design supports
MAX_MT = 8  # codebook rows of a score tile
MAX_CLUSTER = 8  # blocks of a cluster, the portable most
MAX_ROWS = 16  # rows of a cluster's tile
MIN_SLICE = 256  # floats of D a block of a cluster takes at least
SMEM_BUDGET = 200 * 1024  # dynamic shared memory a block may take (of 227 KB)
_INT_MAX = 2 ** 31 - 1


class Geometry(NamedTuple):
    rows: int  # rows of a cluster's tile
    clusters: int  # ceil(N / rows)
    csize: int  # blocks of a cluster, each a slice of D
    ds: int  # floats of D a block owns, a multiple of 4
    dc: int  # floats of the slice staged at once, a multiple of 4
    mt: int  # codebook rows of a score tile
    smem: int  # bytes of dynamic shared memory a block


def smem_floats(f: int, m: int, rows: int, dc: int) -> int:
    """Shared floats of a block: the codebook chunk [F, M, dc], the unbound
    estimates u [rows, F, dc], partial scores [rows, F, M], weights [rows,
    F, M] and the mask [F, M] (each padded to 4)."""
    return (dc * (f * m + rows * f) + -(-rows * f * m // 4) * 4
            + rows * f * -(-m // 4) * 4 + -(-f * m // 4) * 4)


def launch_geometry(n: int, f: int, m: int, d: int, tn: int,
                    sms: int) -> Geometry:
    """The geometry of one launch.

    D is cut into ``csize`` slices (one block of the cluster each, at least
    MIN_SLICE floats, at most MAX_CLUSTER); ``rows``, a power of two up to
    the ceiling ``tn`` (and MAX_ROWS), grows while the grid keeps a block
    for each of ``sms`` SMs; ``dc`` is the whole slice where the block's
    tiles fit SMEM_BUDGET, else the largest multiple of 4 that does (rows
    halve where not even 4 floats fit).  M is cut into ``ceil(M / 8)``
    score tiles of equal size, so M <= 8 is one exact tile and M = 10 two
    of 5.  Raises ``ValueError`` for shapes beyond the design.
    """
    if min(n, f, d) < 1:
        raise ValueError(f"need N, F, D >= 1, got N={n} F={f} D={d}")
    if not 1 <= m <= MAX_M:
        raise ValueError(f"codebook rows M={m} outside the supported 1..{MAX_M}")
    if n * f * max(m, d) > _INT_MAX:
        raise ValueError(f"N*F*max(M, D) = {n * f * max(m, d)} exceeds 2^31-1")
    if tn < 1:
        raise ValueError(f"row ceiling tn must be >= 1, got {tn}")
    csize = max(1, min(MAX_CLUSTER, d // MIN_SLICE))
    ds = -(-d // (4 * csize)) * 4  # ceil(D / csize), up to a multiple of 4
    mt = -(-m // -(-m // MAX_MT))
    rows = 1
    while (rows * 2 <= min(tn, MAX_ROWS)
           and -(-n // (rows * 2)) * csize >= sms):
        rows *= 2
    while True:
        fixed = smem_floats(f, m, rows, 0)
        dc = min(ds, (SMEM_BUDGET // 4 - fixed) // (f * m + rows * f)
                 // 4 * 4)
        if dc >= 4:
            break
        if rows == 1:
            raise ValueError(f"F={f} x M={m} codebook rows do not fit the "
                             f"block's {SMEM_BUDGET} bytes of shared memory")
        rows //= 2
    return Geometry(rows, -(-n // rows), csize, ds, dc, mt,
                    4 * smem_floats(f, m, rows, dc))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
        if not isinstance(mask, torch.Tensor):
            raise ValueError("valid_mask must be an [F, M] tensor")
        if mask.dtype not in (torch.bool, torch.uint8, torch.float32):
            mask = mask.to(torch.float32)
        if tuple(mask.shape) != (F, M):
            raise ValueError(f"valid_mask has shape {tuple(mask.shape)}, "
                             f"expected {(F, M)}")
        mask = mask.contiguous()
    devs = {t.device for t in (qs, est, codebooks, mask) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {sorted(map(str, devs))}")
    dev = qs.device
    g = launch_geometry(N, F, M, D, tn, _sm_count(dev.index))
    vec = D % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (qs, est,
                                                               codebooks))
    alpha = torch.empty((N, F, M), dtype=torch.float32, device=dev)
    new_est = torch.empty((N, F, D), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.resonator_step_launch(
            qs.data_ptr(), est.data_ptr(), codebooks.data_ptr(),
            None if mask is None else mask.data_ptr(),
            int(mask is not None and mask.dtype != torch.float32),
            alpha.data_ptr(), new_est.data_ptr(), N, F, M, D, g.rows,
            g.clusters, g.csize, g.ds, g.dc, g.mt, g.smem,
            int(activation == "abs"), int(local), int(vec), stream)
    if rc != 0:
        raise RuntimeError(f"resonator_step launch failed: CUDA error {rc} "
                           f"({lib.resonator_step_error_string(rc).decode()})")
    return alpha, new_est


def _lib() -> ctypes.CDLL:
    lib = _build.load("resonator_step")
    fn = lib.resonator_step_launch
    if fn.argtypes is None:  # first use in this process
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 4 + [i] + [p] * 2 + [i] * 14 + [p]
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

    out = _launch(qs, est, codebooks, valid_mask, activation, tn)
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

    out = _launch(qs, est, cb_local, valid_mask_local, activation, tn,
                  local=True)
    ops.local_launches += 1
    return out


def resonator_step(q: torch.Tensor, est: torch.Tensor, codebooks: torch.Tensor,
                   *, activation: str = "identity"):
    """Single-query wrapper: q: [D]; est: [F, D] bipolar; codebooks:
    [F, M, D] -> (alpha [F, M], new_est [F, D])."""
    alpha, new_est = resonator_step_batch(q[None], est[None], codebooks,
                                          activation=activation)
    return alpha[0], new_est[0]
