"""RAVEN-style rule evolution: the part of ``repro/data/raven.py`` that LVRF's
one-shot rule learning needs (host-side numpy)."""
from __future__ import annotations

import numpy as np


def apply_rule(rule: str, row: np.ndarray, n_values: int, rng) -> np.ndarray:
    """Evolve a length-3 attribute row under `rule`; row[0] given."""
    a = row.copy()
    if rule == "constant":
        a[1] = a[2] = a[0]
    elif rule == "progression_p1":
        a[1], a[2] = (a[0] + 1) % n_values, (a[0] + 2) % n_values
    elif rule == "progression_m1":
        a[1], a[2] = (a[0] - 1) % n_values, (a[0] - 2) % n_values
    elif rule == "arithmetic_plus":
        a[1] = rng.integers(0, n_values)
        a[2] = (a[0] + a[1]) % n_values
    elif rule == "arithmetic_minus":
        a[1] = rng.integers(0, n_values)
        a[2] = (a[0] - a[1]) % n_values
    elif rule == "distribute_three":
        # The three values form a fixed set permuted across rows.
        pass  # handled at grid level
    else:
        raise ValueError(rule)
    return a
