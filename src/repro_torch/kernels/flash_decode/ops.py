"""Public entry point of paged decode attention.

``flash_decode(..., use_flash=True)``: a tensor on the CPU goes to the plain
version (:func:`.ref.flash_decode_plain`), a CUDA tensor to the
hand-written kernel (:mod:`.kernel`), which launches or raises.  There is
no third path and no fallback.  ``use_flash=False`` is the reference's own
explicit choice of the dense gathered path (:func:`.ref.flash_decode_ref`),
on any device; it is never taken on a failure.  Under autograd with an
operand that requires grad the flash path raises
(:func:`repro_torch.kernels.refuse_grad`); the dense path, which the
reference differentiates, does not.

Counters (plain integers): ``launches`` counts the kernel's launches
(bumped by :mod:`.kernel`), ``plain_calls`` the plain version's calls on
the flash path, so that a CPU run can count its flash-decode dispatches
as a card run counts launches.
"""
from __future__ import annotations

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.flash_decode import kernel as _k
from repro_torch.kernels.flash_decode import ref as _ref

launches = 0  # kernel launches in this process
plain_calls = 0  # flash-path calls served by the plain version (CPU)


def flash_decode(q, pool: dict, table, kv_lens, *, use_flash: bool = True):
    """Decode attention over a paged KV pool.

    q: [B, G, rep, dh] pre-scaled fp32; pool: {"k", "v"} (+ "k_scale",
    "v_scale" when int8) with leaves [NBP, bs, G, dh]; table [B, W] int32;
    kv_lens [B] int32 valid-position counts.  Returns [B, G, rep, dh] fp32.
    """
    global plain_calls
    ks, vs = pool.get("k_scale"), pool.get("v_scale")
    if not use_flash:
        return _ref.flash_decode_ref(q, pool["k"], pool["v"], table, kv_lens,
                                     ks, vs)
    refuse_grad("flash_decode", q, *pool.values())
    if q.device.type == "cpu":
        plain_calls += 1
        return _ref.flash_decode_plain(q, pool["k"], pool["v"], table,
                                       kv_lens, ks, vs)
    return _k.flash_decode(q, pool["k"], pool["v"], table, kv_lens,
                           k_scale=ks, v_scale=vs)


flash_decode_ref = _ref.flash_decode_ref
flash_decode_plain = _ref.flash_decode_plain
