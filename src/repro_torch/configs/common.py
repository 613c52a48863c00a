"""Shared architecture-spec machinery of the config pool.

Each ``repro_torch/configs/<id>.py`` exposes ``full()`` (the published
width and depth), ``smoke()`` (a reduced same-family config for CPU tests)
and a module-level ``SPEC``, as the reference's do.  ``SHAPES`` are the
reference's workload shapes:

    train_4k     seq 4096   global_batch 256   -> train_step
    prefill_32k  seq 32768  global_batch 32    -> prefill (forward)
    decode_32k   seq 32768  global_batch 128   -> serve_step (1 token + cache)
    long_500k    seq 524288 global_batch 1     -> serve_step, sub-quadratic
                                                  archs only (skip recorded)
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.nn.transformer import ModelConfig

SHAPES = {
    "train_4k": {"seq": 4096, "batch": 256, "kind": "train"},
    "prefill_32k": {"seq": 32768, "batch": 32, "kind": "prefill"},
    "decode_32k": {"seq": 32768, "batch": 128, "kind": "decode"},
    "long_500k": {"seq": 524288, "batch": 1, "kind": "decode"},
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # dense | moe | vlm | ssm | audio | hybrid
    full: Callable[[], ModelConfig]
    smoke: Callable[[], ModelConfig]
    sub_quadratic: bool = False  # runs long_500k
    optimizer: str = "adamw"  # adamw | adafactor
    schedule: str = "cosine"  # cosine | wsd
    opt_state_dtype: str = "fp32"  # bf16 for the >=70B archs (HBM budget)
    grad_accum: int = 1  # microbatch count for train_4k
    source: str = ""

    def shapes(self) -> dict:
        out = {}
        for name, s in SHAPES.items():
            if name == "long_500k" and not self.sub_quadratic:
                out[name] = {**s, "skip": "full-attention arch: 500k decode "
                             "reserved for sub-quadratic archs per assignment"}
            else:
                out[name] = {**s, "skip": None}
        return out
