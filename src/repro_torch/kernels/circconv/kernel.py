"""Wrappers of the CUDA circular convolutions (``csrc/circconv.cu``).

Each wrapper checks its inputs, allocates the output with ``torch.empty``,
launches its kernel on the current stream and bumps its launch count in
:mod:`.ops`.  They take CUDA tensors only: the CPU path lives in :mod:`.ops`,
which sends CPU tensors to the plain versions in :mod:`.ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the source's dtype codes
CHUNK = 8  # outputs per thread and k per step; L is padded to a multiple
ROWS_THREADS = 256  # most threads in a rows block
TILE, SLICES = 64, 32  # single: outputs per block, k slices per block
MAX_L = 16384  # the longest row whose operands fit in the 227 KB of shared
# memory a Hopper block can opt into (rows: 4 (3 Lp + 8) bytes)


def _padded(L: int) -> int:
    return -(-L // CHUNK) * CHUNK


def rows_geometry(n: int, L: int) -> tuple:
    """``(Lp, R, tpr, smem)`` of one rows launch: ``Lp`` is L padded to a
    multiple of 8, ``tpr = min(Lp / 8, 256)`` threads per row, ``R`` rows
    per block (about 256 threads), ``smem`` its bytes of shared memory,
    passed to the launch (the one place that sizes the layout).  Raises ``ValueError`` for shapes beyond the design."""
    if n < 1 or L < 1:
        raise ValueError(f"need N, L >= 1, got N={n} L={L}")
    if L > MAX_L:
        raise ValueError(f"L={L}: a row's operands exceed shared memory "
                         f"(the kernel takes L <= {MAX_L})")
    if n * L > 2 ** 31 - 1:
        raise ValueError(f"N={n} L={L}: a flat index exceeds 2^31-1")
    Lp = _padded(L)
    tpr = min(Lp // CHUNK, ROWS_THREADS)
    R = max(1, min(ROWS_THREADS // tpr, n))
    return Lp, R, tpr, R * (3 * Lp + CHUNK) * 4


def single_geometry(L: int) -> tuple:
    """``(Lp, blocks, smem)`` of one single-row launch: output tiles of 64
    over the grid, k split over 32 slices a block."""
    if not 1 <= L <= MAX_L:
        raise ValueError(f"the single-row kernel takes 1 <= L <= {MAX_L}, "
                         f"got L={L}")
    Lp = _padded(L)
    return Lp, -(-Lp // TILE), (2 * Lp + TILE + CHUNK + SLICES * TILE) * 4


def _lib() -> ctypes.CDLL:
    lib = _build.load("circconv")
    if lib.circconv_rows_launch.argtypes is None:  # first use in this process
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.circconv_rows_launch.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
        lib.circconv_rows_launch.restype = ctypes.c_int
        lib.circconv_single_launch.argtypes = [p, p, p, i, i, i, i, p]
        lib.circconv_single_launch.restype = ctypes.c_int
        lib.circconv_error_string.argtypes = [ctypes.c_int]
        lib.circconv_error_string.restype = ctypes.c_char_p
    return lib


def _check(x: torch.Tensor, y: torch.Tensor, ndim: int) -> None:
    for name, t in (("x", x), ("y", y)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor (the plain "
                             "version in ref.py serves CPU tensors)")
        if t.dtype not in DTYPES:
            raise ValueError(f"{name} must be float32 or bfloat16, got "
                             f"{t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{name} must have {ndim} dims, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.shape != y.shape or x.dtype != y.dtype or x.device != y.device:
        raise ValueError(f"x and y differ: {tuple(x.shape)} {x.dtype} "
                         f"{x.device} against {tuple(y.shape)} {y.dtype} "
                         f"{y.device}")


def _launched(lib, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.circconv_error_string(rc).decode()})")


def circconv_rows(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x, y: [N, L] float32 or bfloat16 -> [N, L] in x's dtype, fp32 sums,
    on x's device and current stream."""
    from repro_torch.kernels.circconv import ops

    _check(x, y, 2)
    N, L = x.shape
    Lp, R, tpr, smem = rows_geometry(N, L)
    out = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.circconv_rows_launch(x.data_ptr(), y.data_ptr(),
                                      out.data_ptr(), N, L, Lp, R, tpr,
                                      smem, DTYPES[x.dtype], stream)
    _launched(lib, rc, "circconv_rows")
    ops.rows_launches += 1
    return out


def circconv_single(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x, y: [L] float32 or bfloat16 -> [L] in x's dtype, fp32 sums, the
    outputs split over the grid: the one-long-row corner (HRR, B = 1)."""
    from repro_torch.kernels.circconv import ops

    _check(x, y, 1)
    (L,) = x.shape
    Lp, _, smem = single_geometry(L)
    out = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.circconv_single_launch(x.data_ptr(), y.data_ptr(),
                                        out.data_ptr(), L, Lp, smem,
                                        DTYPES[x.dtype], stream)
    _launched(lib, rc, "circconv_single")
    ops.single_launches += 1
    return out
