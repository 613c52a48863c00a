"""Wrapper of the CUDA int8 codebook similarity (``csrc/similarity_int8.cu``).

The wrapper checks its inputs, allocates the scores with ``torch.empty``,
launches the kernel on the current stream and bumps the launch count in
:mod:`.ops`.  It takes CUDA tensors only: the CPU path lives in :mod:`.ops`,
which sends CPU tensors to the plain version in :mod:`.ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

TILE_ROWS = (8, 16, 32)  # codebook rows per block the source instantiates
SMEM_BUDGET = 48 * 1024  # bytes of the w tile, no opt-in attribute needed
_GRID_Y = 65535


def launch_geometry(n: int, m: int, d: int) -> tuple:
    """``(tm, dc)`` of one launch: ``tm`` codebook rows per block, the
    smallest instantiated tile that covers M (else the largest), and ``dc``
    the chunk of D staged at a time, a multiple of 16 with ``tm * dc``
    within the shared-memory budget.  Raises ``ValueError`` for shapes
    beyond the design."""
    if min(n, m, d) < 1:
        raise ValueError(f"need N, M, D >= 1, got N={n} M={m} D={d}")
    if max(n * max(m, d), m * d) > 2 ** 31 - 1:
        raise ValueError(f"N={n} M={m} D={d}: a flat index exceeds 2^31-1")
    tm = next((t for t in TILE_ROWS if t >= m), TILE_ROWS[-1])
    if -(-m // tm) > _GRID_Y:
        raise ValueError(f"M={m} needs more than {_GRID_Y} codebook tiles")
    dc = min(-(-d // 16) * 16, SMEM_BUDGET // tm // 16 * 16)
    return tm, dc


def _lib() -> ctypes.CDLL:
    lib = _build.load("similarity_int8")
    fn = lib.similarity_int8_launch
    if fn.argtypes is None:  # first use in this process
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.similarity_int8_error_string.argtypes = [ctypes.c_int]
        lib.similarity_int8_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, dtype, shape):
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor (the plain version in "
                         "ref.py serves CPU tensors)")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def similarity_int8(q: torch.Tensor, w_int8: torch.Tensor,
                    w_scale: torch.Tensor) -> torch.Tensor:
    """q: [N, D] float32; w_int8: [M, D] int8; w_scale: [M, 1] float32 ->
    scores [N, M] float32, on q's device and current stream."""
    from repro_torch.kernels.similarity import ops

    if not isinstance(q, torch.Tensor) or q.dim() != 2:
        raise ValueError("q must be an [N, D] tensor")
    if not isinstance(w_int8, torch.Tensor) or w_int8.dim() != 2:
        raise ValueError("w_int8 must be an [M, D] tensor")
    N, D = q.shape
    M = w_int8.shape[0]
    _check("q", q, torch.float32, (N, D))
    _check("w_int8", w_int8, torch.int8, (M, D))
    _check("w_scale", w_scale, torch.float32, (M, 1))
    devs = {t.device for t in (q, w_int8, w_scale)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {sorted(map(str, devs))}")
    tm, dc = launch_geometry(N, M, D)
    vec = D % 4 == 0 and q.data_ptr() % 16 == 0 and w_int8.data_ptr() % 4 == 0
    out = torch.empty((N, M), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.similarity_int8_launch(
            q.data_ptr(), w_int8.data_ptr(), w_scale.data_ptr(),
            out.data_ptr(), N, M, D, tm, dc, int(vec), stream)
    if rc != 0:
        raise RuntimeError(f"similarity_int8 launch failed: CUDA error {rc} "
                           f"({lib.similarity_int8_error_string(rc).decode()})")
    ops.launches += 1
    return out
