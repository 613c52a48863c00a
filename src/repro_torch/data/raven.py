"""Synthetic RAVEN-style RPM (Raven's Progressive Matrices) data pipeline.

A copy of ``repro/data/raven.py`` (host numpy, no JAX), so a config gives the
port the reference's batches, array for array; panels come from a table
rendered once (:func:`panel_table`).  Procedurally generates
abstract-reasoning tasks in the style of RAVEN [95] / I-RAVEN [36]: a 3x3
grid of panels where each attribute of the objects in a row evolves under a
hidden rule; the 9th panel is missing and must be picked from 8 candidates.
This is the cognitive workload NVSA / PrAE / LVRF (and hence CogSys) are
evaluated on.

Scope: the `center` constellation is fully rendered to images (one object,
attributes type/size/color) so the neural frontend genuinely perceives; the
multi-object constellations (2x2Grid, 3x3Grid, Left-Right, Up-Down, O-IC,
DistFour) are generated at the attribute level and drive the factorization /
abduction benchmarks (Tab. VII's 14 scenarios).

Deterministic seeding, shard-aware iteration (`num_shards`/`shard_index` for
data parallelism) and a resumable `state` for checkpointing.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Iterator

import numpy as np

# Attribute spaces (RAVEN uses type 5, size 6, color 10).
NUM_TYPES = 5
NUM_SIZES = 6
NUM_COLORS = 10
ATTR_SIZES = {"type": NUM_TYPES, "size": NUM_SIZES, "color": NUM_COLORS}
ATTRS = ("type", "size", "color")

RULES = ("constant", "progression_p1", "progression_m1", "arithmetic_plus",
         "arithmetic_minus", "distribute_three")
CONSTELLATIONS = ("center", "2x2grid", "3x3grid", "left_right", "up_down",
                  "o_ic", "dist_four")
# Panels per constellation (slots that carry an object).
_SLOTS = {"center": 1, "2x2grid": 4, "3x3grid": 9, "left_right": 2,
          "up_down": 2, "o_ic": 2, "dist_four": 4}

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


def _gen_attribute_grid(rule: str, n_values: int, rng) -> np.ndarray:
    """3x3 grid of one attribute's values under `rule` (rows share the rule)."""
    g = np.zeros((3, 3), dtype=np.int32)
    if rule == "distribute_three":
        vals = rng.choice(n_values, size=3, replace=False)
        for r in range(3):
            g[r] = np.roll(vals, r)
        return g
    for r in range(3):
        row = np.zeros(3, dtype=np.int64)
        row[0] = rng.integers(0, n_values)
        g[r] = apply_rule(rule, row, n_values, rng)
    return g


@dataclasses.dataclass
class RPMTask:
    """One RPM problem instance (attribute-level representation)."""

    constellation: str
    rules: dict  # attr -> rule name
    grid: dict  # attr -> [3, 3] int32 values (per attribute)
    candidates: dict  # attr -> [8] int32 candidate values for panel (2,2)
    answer: int  # index of the correct candidate
    images: np.ndarray | None = None  # [9, H, W] for 'center' (answer slot zeroed)
    candidate_images: np.ndarray | None = None  # [8, H, W]


# ---------------------------------------------------------------------------
# Rendering (center constellation)
# ---------------------------------------------------------------------------

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


@functools.lru_cache(maxsize=None)
def panel_table(img: int = IMG_SIZE) -> np.ndarray:
    """Every panel :func:`render_panel` draws, ``[NUM_TYPES, NUM_SIZES,
    NUM_COLORS, img, img]``, rendered once and read-only.  Batches index it
    (a fancy index copies) instead of rendering each panel: the same arrays,
    and a 128-panel batch costs tens of microseconds of host time in place
    of about 9 ms."""
    # Numpy integer ids, as the callers' label arrays hold: with them the
    # polygon test runs in float64 (a Python int would keep it in float32
    # under numpy 2's promotion and move a few edge pixels).
    ids = np.arange(max(NUM_TYPES, NUM_SIZES, NUM_COLORS))
    table = np.stack([np.stack([np.stack([render_panel(ids[t], ids[s], ids[c],
                                                       img)
                                          for c in range(NUM_COLORS)])
                                for s in range(NUM_SIZES)])
                      for t in range(NUM_TYPES)])
    table.setflags(write=False)
    return table


# ---------------------------------------------------------------------------
# Task generation
# ---------------------------------------------------------------------------

def generate_task(rng, constellation: str = "center",
                  render: bool = True) -> RPMTask:
    rules = {a: RULES[rng.integers(0, len(RULES))] for a in ATTRS}
    grid = {a: _gen_attribute_grid(rules[a], ATTR_SIZES[a], rng) for a in ATTRS}
    answer_attrs = {a: grid[a][2, 2] for a in ATTRS}

    # 8 candidates: the answer + 7 distractors perturbing 1-2 attributes
    # (I-RAVEN style so the answer is not the statistical mode).
    cand = {a: np.zeros(8, dtype=np.int32) for a in ATTRS}
    answer = int(rng.integers(0, 8))
    seen = {tuple(answer_attrs[a] for a in ATTRS)}
    for c in range(8):
        if c == answer:
            for a in ATTRS:
                cand[a][c] = answer_attrs[a]
            continue
        while True:
            attrs = dict(answer_attrs)
            for a in rng.choice(ATTRS, size=rng.integers(1, 3), replace=False):
                attrs[a] = (attrs[a] + rng.integers(1, ATTR_SIZES[a])) % ATTR_SIZES[a]
            if tuple(attrs[a] for a in ATTRS) not in seen:
                seen.add(tuple(attrs[a] for a in ATTRS))
                break
        for a in ATTRS:
            cand[a][c] = attrs[a]

    images = cand_images = None
    if render and constellation == "center":
        table = panel_table()
        images = np.zeros((9, IMG_SIZE, IMG_SIZE), dtype=np.float32)
        # the 9th panel is the unknown
        images[:8] = table[grid["type"].reshape(9)[:8],
                           grid["size"].reshape(9)[:8],
                           grid["color"].reshape(9)[:8]]
        cand_images = table[cand["type"], cand["size"], cand["color"]]
    return RPMTask(constellation, rules, grid, cand, answer, images, cand_images)


@dataclasses.dataclass
class RavenConfig:
    constellation: str = "center"
    batch_size: int = 32
    seed: int = 0
    num_shards: int = 1
    shard_index: int = 0
    render: bool = True


class RavenDataset:
    """Shard-aware, resumable iterator of batched RPM tasks.

    Batches are dicts of stacked numpy arrays.  `state()` /
    `restore()` capture the stream position for checkpoint/restart.
    """

    def __init__(self, cfg: RavenConfig):
        self.cfg = cfg
        self._step = 0

    def state(self) -> dict:
        return {"step": self._step}

    def restore(self, state: dict) -> None:
        self._step = int(state["step"])

    def _task_seed(self, step: int, i: int) -> int:
        global_i = (step * self.cfg.num_shards + self.cfg.shard_index) * self.cfg.batch_size + i
        return self.cfg.seed * 1_000_003 + global_i

    def next_batch(self) -> dict:
        cfg = self.cfg
        tasks = [generate_task(np.random.default_rng(self._task_seed(self._step, i)),
                               cfg.constellation, cfg.render)
                 for i in range(cfg.batch_size)]
        self._step += 1
        batch = {
            "answer": np.array([t.answer for t in tasks], dtype=np.int32),
            "rules": np.array([[RULES.index(t.rules[a]) for a in ATTRS]
                               for t in tasks], dtype=np.int32),
        }
        for a in ATTRS:
            batch[f"grid_{a}"] = np.stack([t.grid[a] for t in tasks])
            batch[f"cand_{a}"] = np.stack([t.candidates[a] for t in tasks])
        if cfg.render and cfg.constellation == "center":
            batch["images"] = np.stack([t.images for t in tasks])
            batch["candidate_images"] = np.stack([t.candidate_images for t in tasks])
        return batch

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()


def attribute_classification_batch(rng, batch_size: int = 128) -> dict:
    """Supervised panels for frontend training: image + attribute labels."""
    t = rng.integers(0, NUM_TYPES, batch_size)
    s = rng.integers(0, NUM_SIZES, batch_size)
    c = rng.integers(0, NUM_COLORS, batch_size)
    imgs = panel_table()[t, s, c]
    return {"images": imgs.astype(np.float32), "type": t.astype(np.int32),
            "size": s.astype(np.int32), "color": c.astype(np.int32)}
