"""Block-table KV cache pool for paged LM serving (host side).

The port of ``repro/lm/paging.py``, less its Pallas ``interpret`` knob.

The device side is a fixed pool of ``[num_blocks + 1, block_size, G, dh]``
KV blocks per attention layer (:func:`repro_torch.nn.layers.init_kv_pool`; the
+1 is the trash block dead writes scatter into).  This module is the HOST
side: :class:`PagedConfig` (the knob bundle `ServeEngine`/`LMEngine` thread
down, the way ``FusedConfig`` threads the resonator path) and
:class:`BlockTablePool` (the allocator — per-slot block lists over one free
list, and the trash-padded ``[slots, W]`` table the kernels index through).

What paging buys the serving stack:

  * slot capacity is POOL-limited, not ``max_len``-limited — a slot parks
    only when the pool (or its table width) is exhausted, and freed slots
    return their blocks for other slots to grow into;
  * ``resize`` is a block-table edit: carried slots keep their physical
    blocks untouched (live rows bit-equal across a mid-run re-tune), no KV
    buffer is reshaped or copied;
  * admission/reset is ``release(slot)`` — O(blocks held), never a copy of
    the cache.

Allocation is deterministic (LIFO free list, blocks returned in reverse),
so a replayed run makes identical placement decisions — part of the
bit-equal replay contract the fault-tolerant runtime relies on.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class PagedConfig:
    """Paged-serving knobs threaded from ``LMEngine`` down to the kernel.

    ``block_size`` is the KV positions per physical block (= the flash
    kernel's tile length).  ``num_blocks`` sizes the shared pool (default:
    enough for every slot to reach ``max_len``).  ``max_blocks_per_slot``
    caps one slot's table width W (default: ``ceil(max_len / block_size)``,
    keeping per-slot capacity aligned with the contiguous engine's
    ``max_len`` contract; raise it — and ``num_blocks`` — to serve slots
    past ``max_len``).  ``prefill_chunk`` is the static prompt-chunk width
    (one dispatch per chunk).  ``use_flash`` selects the ``flash_decode``
    kernel (its plain version for CPU tensors) vs the reference's dense
    gathered path, an explicit choice of the caller.
    """

    block_size: int = 16
    num_blocks: int | None = None
    max_blocks_per_slot: int | None = None
    prefill_chunk: int = 8
    use_flash: bool = True

    def __post_init__(self):
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {self.block_size}")
        if self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {self.prefill_chunk}")
        for name in ("num_blocks", "max_blocks_per_slot"):
            v = getattr(self, name)
            if v is not None and v < 1:
                raise ValueError(f"{name} must be >= 1, got {v}")

    def resolve_num_blocks(self, slots: int, max_len: int) -> int:
        if self.num_blocks is not None:
            return self.num_blocks
        return slots * cdiv(max_len, self.block_size)

    def resolve_table_width(self, slots: int, max_len: int) -> int:
        nb = self.resolve_num_blocks(slots, max_len)
        w = self.max_blocks_per_slot if self.max_blocks_per_slot is not None \
            else cdiv(max_len, self.block_size)
        return max(1, min(w, nb))


class BlockTablePool:
    """Host allocator: per-slot block lists over one shared free list.

    Physical block ids ``0 .. num_blocks-1`` are allocatable; ``num_blocks``
    is the trash block (`self.trash`) used only as table padding and as the
    scatter target for dead writes — it is never allocated.
    """

    def __init__(self, num_blocks: int, block_size: int, slots: int,
                 table_width: int):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.table_width = table_width
        self.trash = num_blocks
        self.slots = slots
        # LIFO, seeded so the first pops hand out 0, 1, 2, ...
        self._free: list = list(range(num_blocks - 1, -1, -1))
        self.rows: list = [[] for _ in range(slots)]

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def slot_capacity(self) -> int:
        """Max tokens one slot can ever hold (table-width-limited)."""
        return self.table_width * self.block_size

    def capacity(self, slot: int) -> int:
        """Tokens the slot can hold with its CURRENT block list."""
        return len(self.rows[slot]) * self.block_size

    def ensure(self, slot: int, tokens: int) -> bool:
        """Grow ``slot``'s block list until it holds ``tokens`` positions.
        Returns False when the pool or the slot's table width is exhausted
        (blocks already appended stay with the slot — the caller decides
        whether to park or release)."""
        need = cdiv(tokens, self.block_size)
        row = self.rows[slot]
        while len(row) < need:
            if len(row) >= self.table_width or not self._free:
                return False
            row.append(self._free.pop())
        return True

    def release(self, slot: int) -> int:
        """Return the slot's blocks to the free list; returns the count."""
        blocks = self.rows[slot]
        self._free.extend(reversed(blocks))
        self.rows[slot] = []
        return len(blocks)

    def reset(self) -> None:
        for s in range(self.slots):
            self.release(s)

    def table(self) -> np.ndarray:
        """Trash-padded ``[slots, W]`` int32 table for the device."""
        t = np.full((self.slots, self.table_width), self.trash, np.int32)
        for s, row in enumerate(self.rows):
            t[s, :len(row)] = row
        return t

    def resize(self, slots: int, carry=()) -> None:
        """Re-map to ``slots`` rows keeping ``carry`` (old slot ids, in
        their new-row order); every non-carried slot's blocks are freed.
        Carried block lists are untouched — the physical KV they point at
        is exactly the warm-handoff state."""
        carry = list(carry)
        if len(carry) > slots:
            raise ValueError(f"cannot carry {len(carry)} slots into {slots}")
        keep = set(carry)
        for s in range(self.slots):
            if s not in keep:
                self.release(s)
        old = self.rows
        self.rows = [old[c] for c in carry] + \
            [[] for _ in range(slots - len(carry))]
        self.slots = slots
