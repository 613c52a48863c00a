"""Wrapper of the CUDA paged decode attention (``csrc/flash_decode.cu``).

The wrapper checks its inputs, picks the split count from static shapes
(:func:`split_count`), allocates the output with ``torch.empty``, launches
the kernel on the current stream (one launch: a grid of clusters, one per
(row, KV head)) and bumps the launch count in :mod:`.ops`.  It takes CUDA
tensors only: the CPU path lives in :mod:`.ops`, which sends CPU tensors to
the plain version in :mod:`.ref`.

:func:`tile` and :func:`split_range` restate the kernel's split arithmetic,
so that the CPU tests can check its algebra and the card tests can aim at
its boundaries.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode.ref import check_scales

HEAD_DIMS = (16, 32, 64, 128)  # head widths the source instantiates
# Query heads per KV head the source takes, each in one launch: 1..8 on the
# CUDA cores (a template a rep), WIDE_MIN_REP..16 on the tensor cores (one
# template, M = 16 query heads, those past rep zero).  The ten reference
# configs have 1, 3, 5, 6, 8 and 12 (starcoder2-3b).
REPS = tuple(range(1, 17))
MAX_REP = REPS[-1]
WIDE_MIN_REP = 9
WIDE_TILE = 8  # positions a warp of the tensor-core kernel takes at once
_GRID_Y = 65535
MAX_SPLITS = 8  # blocks of a cluster: the portable cluster size
# Blocks per SM that split_count aims for.  Four fit (48-52 KB of shared
# memory, at most 128 registers a thread); aiming at three picks the split
# that measured fastest at Llama 3.2 3B's serving shape, S = 2 for 32 slots,
# both pools (chip_smoke.py phase 15 prints the time at every S): past one
# wave, clusters wait for a free slot together.
BLOCKS_PER_SM = 3
MIN_SPLIT = 64  # positions of the window a split gets at the least


def split_count(batch: int, kv_heads: int, window: int, sm_count: int,
                clusters: dict | None = None) -> int:
    """Blocks per (row, KV head), a power of two S <= MAX_SPLITS, as long as
    each split keeps at least MIN_SPLIT positions of the ``window`` (W * bs).
    The CUDA-core kernel (rep up to 8): the smallest S for which the grid's
    S * batch * kv_heads blocks fill the card (BLOCKS_PER_SM on each of
    ``sm_count`` SMs).  The tensor-core kernel passes ``clusters``, {S:
    clusters of S blocks the card runs at once} (:func:`wide_clusters`):
    the largest S for which all batch * kv_heads clusters run at once, so
    that none waits for a second wave.  Static shapes only: reading
    ``kv_lens`` would sync the host and break graph capture."""
    rows = batch * kv_heads
    s = 1
    if clusters is not None:
        while (s < MAX_SPLITS and rows <= clusters[2 * s]
               and window >= 2 * s * MIN_SPLIT):
            s *= 2
        return s
    while (s < MAX_SPLITS and s * rows < BLOCKS_PER_SM * sm_count
           and window >= 2 * s * MIN_SPLIT):
        s *= 2
    return s


def tile(dh: int, rep: int) -> int:
    """Positions one warp takes at once (``Shape::kBatch``, or
    ``kWideTile`` from WIDE_MIN_REP query heads on): a split's length is
    rounded up to it."""
    if rep >= WIDE_MIN_REP:
        return WIDE_TILE
    return (4 if rep <= 4 else 2) * (256 // dh)


def launch_rep(rep: int) -> int:
    """The rep a launch of ``rep`` query heads per KV head runs at: every
    rep of :data:`REPS` is instantiated, so ``rep`` itself; raises for one
    outside them."""
    if rep not in REPS:
        raise ValueError(f"{rep} query heads per KV head; the kernel takes "
                         f"1..{MAX_REP}")
    return rep


def split_range(length: int, splits: int, rank: int, span: int,
                window: int = 0) -> tuple:
    """Positions ``[start, end)`` that block ``rank`` of a cluster of
    ``splits`` takes of a row of ``length`` live positions, of which a
    ``window`` (0: none) keeps the last ``window``: the splits share
    ``[max(0, length - window), length)``."""
    lo = max(0, length - window) if window > 0 else 0
    share = -(-(length - lo) // splits)
    per = -(-share // span) * span
    start = lo + min(length - lo, rank * per)
    return start, min(length, start + per)


def split_edges(span: int, splits: int, cap: int) -> list:
    """Row lengths on and next to the boundaries between the blocks of a
    cluster of ``splits``, where the card checks aim: multiples of the
    rounding unit ``span`` up to 2 * splits of them and multiples of
    splits * span up to ``cap``, one either side of each, plus 0 and the
    full window ``cap``."""
    marks = {k * span for k in range(1, 2 * splits + 1)}
    marks |= {k * splits * span for k in range(1, cap // (splits * span) + 1)}
    return sorted({0, cap} | {n + d for n in marks for d in (-1, 0, 1)
                              if 0 <= n + d <= cap})


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode")
    fn = lib.flash_decode_launch
    if fn.argtypes is None:  # first use in this process
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i,
                       p]
        fn.restype = ctypes.c_int
        lib.flash_decode_wide_occupancy.argtypes = [i, i, i, p, p]
        lib.flash_decode_wide_occupancy.restype = ctypes.c_int
        lib.flash_decode_error_string.argtypes = [ctypes.c_int]
        lib.flash_decode_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def wide_clusters(index: int, dh: int, quantized: bool) -> dict:
    """``{S: clusters of S blocks card ``index`` runs at once}`` for the
    tensor-core kernel at (dh, pool type), S = 1, 2, 4, 8, as the card
    reports them (``cudaOccupancyMaxActiveClusters``; a host query, no
    device work).  Its blocks (8 warps, ~95 KB of shared memory at dh 128)
    fit two an SM, but how the SMs group bounds the clusters too: an H100
    SXM runs 62 clusters of 4, not 66."""
    lib = _lib()
    out = {}
    with torch.cuda.device(index):
        for s in (1, 2, 4, 8):
            per_sm, n = ctypes.c_int(), ctypes.c_int()
            rc = lib.flash_decode_wide_occupancy(
                dh, int(quantized), s, ctypes.byref(per_sm), ctypes.byref(n))
            if rc != 0:
                raise RuntimeError(
                    f"flash_decode occupancy query failed: CUDA error {rc} "
                    f"({lib.flash_decode_error_string(rc).decode()})")
            out[s] = n.value
    return out


def _check(name, t, dtypes, shape):
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor (the plain version in "
                         "ref.py serves CPU tensors)")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be "
                         f"{' or '.join(map(str, dtypes))}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def flash_decode(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 table: torch.Tensor, kv_lens: torch.Tensor, *,
                 k_scale: torch.Tensor | None = None,
                 v_scale: torch.Tensor | None = None,
                 window: int | None = None,
                 splits: int | None = None) -> torch.Tensor:
    """Paged online-softmax decode attention (shapes in :mod:`.ref`):
    q [B, G, rep, dh] fp32; k/v pool [NBP, bs, G, dh] bf16 or int8 (with
    fp32 k/v scales [NBP, bs, G, 1]); table [B, W] int32; kv_lens [B] int32
    -> [B, G, rep, dh] fp32, on q's device and current stream.

    ``kv_lens`` is clamped to [0, W * bs] in the kernel, and a block id
    outside [0, NBP) in a row's live window is masked, never read.  With a
    ``window``, a row's positions below ``kv_lens - window`` are neither
    read nor counted, and the splits share the rest (:func:`split_range`).
    ``splits`` (1..MAX_SPLITS) overrides :func:`split_count`'s choice of
    blocks per (row, KV head).  One launch and one allocation, the output,
    at every rep."""
    from repro_torch.kernels.flash_decode import ops

    check_scales(k_pool, k_scale, v_scale)
    for name, t, nd in (("q", q, 4), ("k_pool", k_pool, 4),
                        ("table", table, 2)):
        if not isinstance(t, torch.Tensor) or t.dim() != nd:
            raise ValueError(f"{name} must be a {nd}-d tensor")
    B, G, rep, dh = q.shape
    nbp, bs = k_pool.shape[0], k_pool.shape[1]
    W = table.shape[1]
    kv = (torch.bfloat16, torch.int8)
    _check("q", q, (torch.float32,), (B, G, rep, dh))
    _check("k_pool", k_pool, kv, (nbp, bs, G, dh))
    _check("v_pool", v_pool, (k_pool.dtype,), (nbp, bs, G, dh))
    _check("table", table, (torch.int32,), (B, W))
    _check("kv_lens", kv_lens, (torch.int32,), (B,))
    quantized = k_pool.dtype == torch.int8
    if quantized:
        _check("k_scale", k_scale, (torch.float32,), (nbp, bs, G, 1))
        _check("v_scale", v_scale, (torch.float32,), (nbp, bs, G, 1))
    operands = [q, k_pool, v_pool, table, kv_lens] + (
        [k_scale, v_scale] if quantized else [])
    devs = {t.device for t in operands}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: "
                         f"{sorted(map(str, devs))}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not in {HEAD_DIMS}")
    launch_rep(rep)
    if min(G, bs, W, nbp) < 1 or B > _GRID_Y:
        raise ValueError(f"need G, bs, W, NBP >= 1 and B <= {_GRID_Y}, got "
                         f"B={B} G={G} bs={bs} W={W} NBP={nbp}")
    if G > _GRID_Y:
        raise ValueError(f"{G} KV heads; the grid takes at most {_GRID_Y}")
    if window is not None and not 1 <= window <= 2 ** 31 - 1:
        raise ValueError(f"window {window} not in 1..2**31-1")
    if splits is not None and not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"splits {splits} not in 1..{MAX_SPLITS}")
    if nbp * bs * G > 2 ** 31 - 1 or W * bs > 2 ** 31 - 1:
        raise ValueError("pool or table too large for 32-bit positions")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("the K/V pools must be 16-byte aligned")
    out = torch.empty((B, G, rep, dh), dtype=torch.float32, device=q.device)
    if B == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        if splits is None:
            index = torch.cuda.current_device()
            splits = split_count(
                B, G, W * bs if window is None else min(W * bs, window),
                _sm_count(index),
                wide_clusters(index, dh, quantized)
                if rep >= WIDE_MIN_REP else None)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_decode_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            table.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
            B, G, rep, nbp, bs, W, dh, int(quantized), splits,
            window or 0, stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode launch failed: CUDA error {rc} "
                           f"({lib.flash_decode_error_string(rc).decode()})")
    ops.launches += 1
    return out
