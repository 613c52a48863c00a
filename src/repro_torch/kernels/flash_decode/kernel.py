"""Wrapper of the CUDA paged decode attention (``csrc/flash_decode.cu``).

The wrapper checks its inputs, allocates the output with ``torch.empty``,
launches the kernel on the current stream and bumps the launch count in
:mod:`.ops`.  It takes CUDA tensors only: the CPU path lives in :mod:`.ops`,
which sends CPU tensors to the plain version in :mod:`.ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode.ref import check_scales

HEAD_DIMS = (16, 32, 64, 128)  # head widths the source instantiates
MAX_REP = 8  # query heads per KV head the kernel's accumulator holds
_GRID_Y = 65535


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode")
    fn = lib.flash_decode_launch
    if fn.argtypes is None:  # first use in this process
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.flash_decode_error_string.argtypes = [ctypes.c_int]
        lib.flash_decode_error_string.restype = ctypes.c_char_p
    return lib


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
                 v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Paged online-softmax decode attention (shapes in :mod:`.ref`):
    q [B, G, rep, dh] fp32; k/v pool [NBP, bs, G, dh] bf16 or int8 (with
    fp32 k/v scales [NBP, bs, G, 1]); table [B, W] int32; kv_lens [B] int32
    -> [B, G, rep, dh] fp32, on q's device and current stream.

    ``kv_lens`` is clamped to [0, W * bs] in the kernel, and a block id
    outside [0, NBP) in a row's live window is masked, never read."""
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
    if not 1 <= rep <= MAX_REP:
        raise ValueError(f"{rep} query heads per KV head; the kernel takes "
                         f"1..{MAX_REP}")
    if min(G, bs, W, nbp) < 1 or B > _GRID_Y:
        raise ValueError(f"need G, bs, W, NBP >= 1 and B <= {_GRID_Y}, got "
                         f"B={B} G={G} bs={bs} W={W} NBP={nbp}")
    if nbp * bs * G > 2 ** 31 - 1 or W * bs > 2 ** 31 - 1:
        raise ValueError("pool or table too large for 32-bit positions")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("the K/V pools must be 16-byte aligned")
    out = torch.empty((B, G, rep, dh), dtype=torch.float32, device=q.device)
    if B == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_decode_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            table.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
            B, G, rep, nbp, bs, W, dh, int(quantized), stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode launch failed: CUDA error {rc} "
                           f"({lib.flash_decode_error_string(rc).decode()})")
    ops.launches += 1
    return out
