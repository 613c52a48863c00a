"""RAVEN-style data: the parts of ``repro/data/raven.py`` that the port's
models need (host-side numpy, copied): rule evolution for LVRF's one-shot
rule learning, and panel rendering with attribute labels for MIMONet."""
from __future__ import annotations

import numpy as np

# Attribute spaces (RAVEN uses type 5, size 6, color 10).
NUM_TYPES = 5
NUM_SIZES = 6
NUM_COLORS = 10

IMG_SIZE = 32


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


def render_panel(type_id: int, size_id: int, color_id: int,
                 img: int = IMG_SIZE) -> np.ndarray:
    """Render one object as a filled regular polygon / circle mask."""
    yy, xx = np.mgrid[0:img, 0:img].astype(np.float32)
    cy = cx = (img - 1) / 2
    r = (0.15 + 0.12 * size_id) * img / 2  # radius from size attribute
    dy, dx = yy - cy, xx - cx
    rad = np.sqrt(dy**2 + dx**2) + 1e-6
    if type_id == NUM_TYPES - 1:  # circle
        mask = rad <= r
    else:
        n_sides = type_id + 3  # triangle, square, pentagon, hexagon
        ang = np.arctan2(dy, dx)
        # regular polygon: r(theta) = r*cos(pi/n)/cos((theta mod 2pi/n) - pi/n)
        t = np.mod(ang, 2 * np.pi / n_sides) - np.pi / n_sides
        mask = rad <= r * np.cos(np.pi / n_sides) / np.cos(t)
    shade = 0.1 + 0.09 * color_id  # color attribute -> fill intensity
    return (mask * shade).astype(np.float32)


def attribute_classification_batch(rng, batch_size: int = 128) -> dict:
    """Supervised panels for frontend training: image + attribute labels."""
    t = rng.integers(0, NUM_TYPES, batch_size)
    s = rng.integers(0, NUM_SIZES, batch_size)
    c = rng.integers(0, NUM_COLORS, batch_size)
    imgs = np.stack([render_panel(t[i], s[i], c[i]) for i in range(batch_size)])
    return {"images": imgs.astype(np.float32), "type": t.astype(np.int32),
            "size": s.astype(np.int32), "color": c.astype(np.int32)}
