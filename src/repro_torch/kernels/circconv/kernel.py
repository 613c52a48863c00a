"""Wrappers of the CUDA circular convolutions (``csrc/circconv.cu``).

Each wrapper checks its inputs, allocates the output with ``torch.empty``,
launches its kernel on the current stream and bumps its launch count in
:mod:`.ops`.  They take CUDA tensors only: the CPU path lives in :mod:`.ops`,
which sends CPU tensors to the plain versions in :mod:`.ref`.

``circconv_rows`` reads its operands as strided views over one common shape
``[..., L]``: a leading dim where an operand is broadcast has stride 0 and
costs no copy.  :func:`rows_plan` collapses the leading dims and picks one of
the kernel's two modes (:func:`rows_mode`): the tensor-core mode when many
rows share one row of an operand (the stationary one, MIMONet's keys), the
direct FMA mode otherwise.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the source's dtype codes
CHUNK = 8  # direct mode: outputs per thread and k per step; L is padded to 8
ROWS_THREADS = 256  # direct mode: most threads in a block
MAX_L = 16384  # the longest row whose operands fit in the 227 KB of shared
# memory a Hopper block can opt into (direct rows: 4 (3 Lp + 8) bytes)
MAX_DIMS = 4  # leading dims the kernel indexes; a plan collapses to at most this
MMA_ROWS, MMA_COLS, MMA_K = 64, 128, 64  # tensor-core tile: rows x outputs, k a stage
MMA_STAGES = 3  # k-stages of the streamed rows in flight (cp.async ring)
MMA_MIN_ROWS = 32  # rows that must share a stationary row for the tensor cores
MMA_MAX_L = 2048  # the longest row whose B strips fit in shared memory
SINGLE_TILE = 64  # single: outputs a block
SINGLE_BLOCKS = 128  # single: blocks the k-split aims at (132 SMs)
MAX_CLUSTER = 8  # the portable cluster size


class RowsPlan(NamedTuple):
    """One rows launch.  ``dims``: ``((size, x stride, y stride, out stride),
    ...)`` in elements, outermost first, at most ``MAX_DIMS``; row r of the
    launch is r's mixed-radix digits over the sizes.  ``swap``: x and y trade
    places (convolution commutes), so that y is the stationary operand.
    ``groups`` x ``group_rows`` = rows: in the tensor-core mode the
    ``group_rows`` rows of a group (the inner dims) share one y row."""
    mode: str  # "mma" (tensor cores) or "direct" (FMAs)
    swap: bool
    dims: tuple
    groups: int
    group_rows: int


def rows_mode(group_rows: int, L: int, aligned: bool = True) -> str:
    """The tensor-core mode takes rows that share a stationary row at least
    ``MMA_MIN_ROWS`` deep (half a tile: fewer waste more tensor-core rows
    than the 3 TF32 products gain over the FMAs), L a multiple of the
    output tile up to ``MMA_MAX_L``, and 16-byte aligned rows
    (``cp.async``).  Else direct."""
    if (group_rows >= MMA_MIN_ROWS and L % MMA_COLS == 0 and L <= MMA_MAX_L
            and aligned):
        return "mma"
    return "direct"


def _merge(dims: list) -> list:
    """Adjacent dims whose three strides all nest collapse into one."""
    out = []
    for d in dims:
        if out and all(out[-1][i] == d[i] * d[0] for i in (1, 2, 3)):
            out[-1] = (out[-1][0] * d[0], *d[1:])
        else:
            out.append(d)
    return out


def rows_plan(shape, x_strides, y_strides, aligned: bool = True):
    """The launch plan of x, y, both ``shape`` ([..., L]) with these strides
    (elements), or ``None`` if L is not unit-stride or the leading dims do
    not collapse into ``MAX_DIMS`` (the caller then passes contiguous
    copies).

    Dims of size 1 drop out.  The operand with fewer distinct rows (rows
    counted over its nonzero strides) is the stationary one; the rows that
    share one of its rows, the product of the dims where its stride is 0,
    decide the mode.  The tensor-core mode puts the stationary operand in y
    and its shared dims innermost, so that a group is a run of rows."""
    *lead, L = shape
    if L > 1 and (x_strides[-1] != 1 or y_strides[-1] != 1):
        return None
    so, step = [], L
    for n in reversed(lead):
        so.append(step)
        step *= n
    dims = [(n, sx, sy, o) for n, sx, sy, o in
            zip(lead, x_strides[:-1], y_strides[:-1], reversed(so)) if n > 1]
    distinct = [math.prod(d[0] for d in dims if d[i]) for i in (1, 2)]
    swap = distinct[0] < distinct[1]
    stat = 1 if swap else 2
    group_rows = math.prod(d[0] for d in dims if not d[stat])
    mode = rows_mode(group_rows, L, aligned)
    if mode == "mma":
        if swap:
            dims = [(n, sy, sx, o) for n, sx, sy, o in dims]
        dims = [d for d in dims if d[2]] + [d for d in dims if not d[2]]
        groups = math.prod(d[0] for d in dims) // group_rows
    else:
        swap, groups, group_rows = False, math.prod(lead), 1
    dims = _merge(dims)
    if len(dims) > MAX_DIMS:
        return None
    return RowsPlan(mode, swap, tuple(dims), groups, group_rows)


def _padded(L: int) -> int:
    return -(-L // CHUNK) * CHUNK


def _check_size(n: int, L: int) -> None:
    if n < 1 or L < 1:
        raise ValueError(f"need N, L >= 1, got N={n} L={L}")
    if L > MAX_L:
        raise ValueError(f"L={L}: a row's operands exceed shared memory "
                         f"(the kernel takes L <= {MAX_L})")
    if n * L > 2 ** 31 - 1:
        raise ValueError(f"N={n} L={L}: a flat index exceeds 2^31-1")


def rows_geometry(n: int, L: int) -> tuple:
    """``(Lp, R, tpr, smem)`` of one direct-mode launch: ``Lp`` is L padded
    to a multiple of 8, ``tpr = min(Lp / 8, 256)`` threads per row, ``R``
    rows per block (about 256 threads), ``smem`` its bytes of shared memory,
    passed to the launch (the one place that sizes the layout).  Raises
    ``ValueError`` for shapes beyond the design."""
    _check_size(n, L)
    Lp = _padded(L)
    tpr = min(Lp // CHUNK, ROWS_THREADS)
    R = max(1, min(ROWS_THREADS // tpr, n))
    return Lp, R, tpr, R * (3 * Lp + CHUNK) * 4


def mma_geometry(groups: int, group_rows: int, L: int, itemsize: int) -> tuple:
    """``(blocks, smem)`` of one tensor-core launch: a block is MMA_ROWS
    rows of one group x MMA_COLS outputs, so ``groups x ceil(group_rows /
    64) x L / 128`` blocks; shared memory is the ring of MMA_STAGES k-stages
    of its rows (row pitch MMA_K + 16 bytes, conflict-free fragments), the
    stationary row's window of L + 128 fp32 values and its B strips (L / 8
    + 15 groups of 8 x 8 fp32), each twice for fp32 inputs (TF32 high and
    low parts), and the rows' offsets."""
    _check_size(groups * group_rows, L)
    if L % MMA_COLS or L > MMA_MAX_L:
        raise ValueError(f"L={L}: the tensor-core mode takes L a multiple of "
                         f"{MMA_COLS} up to {MMA_MAX_L}")
    blocks = groups * -(-group_rows // MMA_ROWS) * (L // MMA_COLS)
    ring = MMA_STAGES * MMA_ROWS * (MMA_K * itemsize + 16)
    parts = 2 if itemsize == 4 else 1
    window_and_strips = parts * ((L + MMA_COLS) + (L // 8 + 15) * 64) * 4
    return blocks, ring + window_and_strips + 2 * MMA_ROWS * 8


def single_geometry(L: int) -> tuple:
    """``(Lp, tiles, csize, ks, smem)`` of one single-row launch: output
    tiles of 64, each one cluster of ``csize`` blocks that split k into
    slices of ``ks`` (a multiple of 8), so that the grid has about
    SINGLE_BLOCKS blocks; a block stages its slice of x and the window of y
    that slice needs, and receives its ranks' partial sums of its outputs."""
    if not 1 <= L <= MAX_L:
        raise ValueError(f"the single-row kernel takes 1 <= L <= {MAX_L}, "
                         f"got L={L}")
    Lp = _padded(L)
    tiles = -(-Lp // SINGLE_TILE)
    csize = max(1, min(MAX_CLUSTER, -(-SINGLE_BLOCKS // tiles)))
    ks = -(-(Lp // CHUNK) // csize) * CHUNK
    return Lp, tiles, csize, ks, (2 * ks + SINGLE_TILE + CHUNK
                                  + csize * SINGLE_TILE) * 4


def _lib() -> ctypes.CDLL:
    lib = _build.load("circconv")
    if lib.circconv_rows_launch.argtypes is None:  # first use in this process
        p, i = ctypes.c_void_p, ctypes.c_int
        # x, y, o, dims, N, L, Lp, R, tpr, smem, dtype, stream
        lib.circconv_rows_launch.argtypes = [p] * 4 + [i] * 7 + [p]
        lib.circconv_rows_launch.restype = ctypes.c_int
        # x, y, o, dims, groups, group_rows, L, smem, dtype, stream
        lib.circconv_rows_mma_launch.argtypes = [p] * 4 + [i] * 5 + [p]
        lib.circconv_rows_mma_launch.restype = ctypes.c_int
        # x, y, o, L, Lp, tiles, csize, ks, smem, dtype, stream
        lib.circconv_single_launch.argtypes = [p] * 3 + [i] * 7 + [p]
        lib.circconv_single_launch.restype = ctypes.c_int
        lib.circconv_empty_launch.argtypes = [p]
        lib.circconv_empty_launch.restype = ctypes.c_int
        lib.circconv_error_string.argtypes = [ctypes.c_int]
        lib.circconv_error_string.restype = ctypes.c_char_p
    return lib


def _check(x: torch.Tensor, y: torch.Tensor, one_row: bool) -> None:
    """CUDA, float32 or bfloat16, one dim (``one_row``) or at least two,
    one shape and dtype, unit stride in the last dim."""
    for name, t in (("x", x), ("y", y)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor (the plain "
                             "version in ref.py serves CPU tensors)")
        if t.dtype not in DTYPES:
            raise ValueError(f"{name} must be float32 or bfloat16, got "
                             f"{t.dtype}")
        if (t.dim() == 1) != one_row or t.dim() == 0:
            raise ValueError(f"{name} has {t.dim()} dims, expected "
                             f"{1 if one_row else 'at least 2'}: shape "
                             f"{tuple(t.shape)}")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim "
                             f"(strides {t.stride()})")
    if x.shape != y.shape or x.dtype != y.dtype or x.device != y.device:
        raise ValueError(f"x and y differ: {tuple(x.shape)} {x.dtype} "
                         f"{x.device} against {tuple(y.shape)} {y.dtype} "
                         f"{y.device}")


def _aligned(t: torch.Tensor) -> bool:
    """Every row of ``t`` starts on 16 bytes."""
    per = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(s % per == 0
                                          for s in t.stride()[:-1])


def _launched(lib, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.circconv_error_string(rc).decode()})")


def circconv_rows(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x, y: [..., L] float32 or bfloat16 views of one shape (stride 0 where
    broadcast, unit stride in L) -> a contiguous [..., L] in x's dtype, fp32
    sums, on x's device and current stream."""
    from repro_torch.kernels.circconv import ops

    _check(x, y, False)
    L = x.shape[-1]
    rows = math.prod(x.shape[:-1])
    _check_size(rows, L)
    plan = rows_plan(x.shape, x.stride(), y.stride(),
                     _aligned(x) and _aligned(y))
    if plan is None:
        raise ValueError(f"x, y strides {x.stride()}, {y.stride()} do not "
                         f"collapse into {MAX_DIMS} leading dims: pass "
                         "contiguous operands")
    a, b = (y, x) if plan.swap else (x, y)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dims = [(1, 0, 0, 0)] * (MAX_DIMS - len(plan.dims)) + list(plan.dims)
    arr = (ctypes.c_longlong * (4 * MAX_DIMS))(*[v for d in dims for v in d])
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if plan.mode == "mma":
            _, smem = mma_geometry(plan.groups, plan.group_rows, L,
                                   x.element_size())
            rc = lib.circconv_rows_mma_launch(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), arr, plan.groups,
                plan.group_rows, L, smem, DTYPES[x.dtype], stream)
        else:
            Lp, R, tpr, smem = rows_geometry(rows, L)
            rc = lib.circconv_rows_launch(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), arr, rows, L, Lp,
                R, tpr, smem, DTYPES[x.dtype], stream)
    _launched(lib, rc, "circconv_rows")
    ops.rows_launches += 1
    return out


def circconv_single(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x, y: [L] float32 or bfloat16 -> [L] in x's dtype, fp32 sums, the
    outputs and k split over the grid: the one-long-row corner (HRR, B = 1)."""
    from repro_torch.kernels.circconv import ops

    _check(x, y, True)
    (L,) = x.shape
    Lp, tiles, csize, ks, smem = single_geometry(L)
    out = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.circconv_single_launch(x.data_ptr(), y.data_ptr(),
                                        out.data_ptr(), L, Lp, tiles, csize,
                                        ks, smem, DTYPES[x.dtype], stream)
    _launched(lib, rc, "circconv_single")
    ops.single_launches += 1
    return out


def empty_launch(device) -> None:
    """Launches an empty kernel on ``device``'s current stream: the card's
    launch floor, which timing sets beside ``circconv_single``.  It counts
    no launch and computes nothing."""
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _launched(lib, lib.circconv_empty_launch(stream), "empty kernel")
