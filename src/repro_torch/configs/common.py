"""Shared architecture-spec machinery of the config pool.

Each ``repro_torch/configs/<id>.py`` exposes ``full()`` (the published
width and depth), ``smoke()`` (a reduced same-family config for CPU tests)
and a module-level ``SPEC``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.nn.transformer import ModelConfig


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    full: Callable[[], ModelConfig]
    smoke: Callable[[], ModelConfig]
    source: str = ""
