"""Pipeline registry: named neurosymbolic workloads the engine can serve.

A registered builder returns a :class:`ServeSpec` — everything the request
engine needs to run one workload:

  * the factorizer side (codebooks / FactorizerConfig / validity mask) that
    requests are slotted against,
  * an optional :class:`repro_torch.engine.stage.StageGraph` for adSCH cost
    estimates,
  * an optional ``postprocess`` turning a completed request's factorization
    results into the workload's answer.

Builders are registered at import time by :mod:`repro_torch.engine.pipelines`;
downstream code registers its own with :func:`register`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.core.factorizer import FactorizerConfig


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """One servable workload (see module docstring).

    ``codebooks``/``cfg`` describe the factorizer side and may be ``None``
    for workloads that are not resonator-shaped; such specs must supply
    ``step_ops`` so the adSCH machinery can still price one engine step.
    """

    name: str
    codebooks: Any = None  # [F, M, D] tensor
    cfg: FactorizerConfig | None = None
    valid_mask: Any = None  # [F, M] bool tensor or None
    graph: Any = None  # StageGraph | None — adSCH cost estimates
    # (queries [k, D], FactorizerResult over the k queries, meta) -> answer
    postprocess: Callable | None = None
    # (slots, *, data_shards=1, model_shards=1) -> list[Op]: cost hints for
    # ONE engine step unit.  When None, engines fall back to
    # factorizer.sweep_cost_ops(cfg, ...).
    step_ops: Callable | None = None

    @property
    def dim(self) -> int:
        if self.codebooks is None:
            raise ValueError(f"spec {self.name!r} has no codebooks (not a "
                             "factorizer workload)")
        return self.codebooks.shape[-1]


_BUILDERS: dict = {}


def register(name: str):
    """Decorator: ``@register("lvrf_rows")`` over a builder
    ``(generator, **kwargs) -> ServeSpec``."""

    def deco(builder):
        if name in _BUILDERS:
            raise ValueError(f"pipeline {name!r} already registered")
        _BUILDERS[name] = builder
        return builder

    return deco


def available() -> tuple:
    return tuple(sorted(_BUILDERS))


def build(name: str, generator, **kwargs) -> ServeSpec:
    """Instantiate a registered pipeline's ServeSpec (``generator``: a
    ``torch.Generator`` or an int seed; ``device=`` defaults to CUDA)."""
    try:
        builder = _BUILDERS[name]
    except KeyError:
        raise KeyError(f"unknown pipeline {name!r}; "
                       f"registered: {available()}") from None
    return builder(generator, **kwargs)
