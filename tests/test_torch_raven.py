"""``repro_torch.data.raven``'s task generator against the reference's
``repro.data.raven``: tasks and batches array-equal for the same config
(seeds, shards, after ``restore``, rendered and not), plus ports of the
generator's own tests (``tests/test_symbolic_and_data.py``)."""
import numpy as np
import pytest

from repro.data import raven as rr
from repro_torch.data import raven as tr


def _equal_batches(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_constants_equal_the_reference():
    assert tr.ATTRS == rr.ATTRS and tr.RULES == rr.RULES
    assert tr.ATTR_SIZES == rr.ATTR_SIZES
    assert tr.CONSTELLATIONS == rr.CONSTELLATIONS and tr._SLOTS == rr._SLOTS


@pytest.mark.parametrize("seed", [0, 1, 17])
@pytest.mark.parametrize("constellation", ["center", "3x3grid"])
def test_generate_task_equals_the_reference(seed, constellation):
    got = tr.generate_task(np.random.default_rng(seed), constellation)
    want = rr.generate_task(np.random.default_rng(seed), constellation)
    assert got.constellation == want.constellation
    assert got.rules == want.rules and got.answer == want.answer
    for a in tr.ATTRS:
        np.testing.assert_array_equal(got.grid[a], want.grid[a])
        np.testing.assert_array_equal(got.candidates[a], want.candidates[a])
    for field in ("images", "candidate_images"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed,shards,render", [
    (0, (1, 0), True), (3, (2, 1), False), (5, (4, 3), True)])
def test_batches_equal_the_reference_across_steps_and_restore(seed, shards,
                                                              render):
    kw = dict(batch_size=4, seed=seed, num_shards=shards[0],
              shard_index=shards[1], render=render)
    ds_t, ds_r = tr.RavenDataset(tr.RavenConfig(**kw)), \
        rr.RavenDataset(rr.RavenConfig(**kw))
    for _ in range(2):
        _equal_batches(ds_t.next_batch(), ds_r.next_batch())
    st = ds_t.state()
    assert st == ds_r.state()
    again = tr.RavenDataset(tr.RavenConfig(**kw))
    again.restore(st)
    _equal_batches(again.next_batch(), ds_r.next_batch())


# Ports of tests/test_symbolic_and_data.py (the generator) ------------------

def test_generated_grids_satisfy_rules():
    rng = np.random.default_rng(0)
    for _ in range(50):
        t = tr.generate_task(rng, render=False)
        for a in tr.ATTRS:
            g, rule, n = t.grid[a], t.rules[a], tr.ATTR_SIZES[a]
            for r in range(3):
                v = g[r]
                if rule == "constant":
                    assert v[0] == v[1] == v[2]
                elif rule == "progression_p1":
                    assert (v[1] - v[0]) % n == 1 and (v[2] - v[1]) % n == 1
                elif rule == "progression_m1":
                    assert (v[0] - v[1]) % n == 1 and (v[1] - v[2]) % n == 1
                elif rule == "arithmetic_plus":
                    assert (v[0] + v[1]) % n == v[2]
                elif rule == "arithmetic_minus":
                    assert (v[0] - v[1]) % n == v[2]
                elif rule == "distribute_three":
                    assert len(set(v.tolist())) == 3
            if rule == "distribute_three":
                assert set(g[0]) == set(g[1]) == set(g[2])


def test_candidates_unique_and_answer_present():
    rng = np.random.default_rng(1)
    for _ in range(20):
        t = tr.generate_task(rng, render=False)
        combos = {tuple(t.candidates[a][c] for a in tr.ATTRS) for c in range(8)}
        assert len(combos) == 8  # distractors are distinct
        ans = tuple(t.grid[a][2, 2] for a in tr.ATTRS)
        assert tuple(t.candidates[a][t.answer] for a in tr.ATTRS) == ans


def test_pipeline_determinism_and_sharding():
    c0 = tr.RavenConfig(batch_size=8, seed=3, render=False)
    a = tr.RavenDataset(c0).next_batch()
    b = tr.RavenDataset(c0).next_batch()
    assert all(np.array_equal(a[k], b[k]) for k in a)
    s0 = tr.RavenDataset(tr.RavenConfig(
        batch_size=8, seed=3, num_shards=2, shard_index=0, render=False)).next_batch()
    s1 = tr.RavenDataset(tr.RavenConfig(
        batch_size=8, seed=3, num_shards=2, shard_index=1, render=False)).next_batch()
    assert not np.array_equal(s0["grid_type"], s1["grid_type"])


def test_resume_state():
    ds = tr.RavenDataset(tr.RavenConfig(batch_size=4, render=False))
    ds.next_batch()
    st = ds.state()
    b1 = ds.next_batch()
    ds2 = tr.RavenDataset(tr.RavenConfig(batch_size=4, render=False))
    ds2.restore(st)
    b2 = ds2.next_batch()
    assert all(np.array_equal(b1[k], b2[k]) for k in b1)


def test_render_panels():
    img = tr.render_panel(0, 3, 5)
    assert img.shape == (32, 32) and 0 < img.max() <= 1.0
    small = (tr.render_panel(4, 0, 9) > 0).sum()
    big = (tr.render_panel(4, 5, 9) > 0).sum()
    assert big > small * 2


@pytest.mark.parametrize("seed,n", [(0, 128), (7, 5), (10_000, 256)])
def test_attribute_classification_batch_equals_the_reference(seed, n):
    """The frontend trainers' batches (panels from the port's table)."""
    got = tr.attribute_classification_batch(np.random.default_rng(seed), n)
    want = rr.attribute_classification_batch(np.random.default_rng(seed), n)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_panel_table_holds_every_rendered_panel_read_only():
    table = tr.panel_table()
    assert table.shape == (tr.NUM_TYPES, tr.NUM_SIZES, tr.NUM_COLORS, 32, 32)
    assert not table.flags.writeable
    ids = np.arange(10, dtype=np.int32)  # ids as the tasks' arrays hold them
    for t in range(tr.NUM_TYPES):
        for s in range(tr.NUM_SIZES):
            for c in range(tr.NUM_COLORS):
                np.testing.assert_array_equal(
                    table[t, s, c], rr.render_panel(ids[t], ids[s], ids[c]))
    batch = tr.attribute_classification_batch(np.random.default_rng(1), 4)
    batch["images"][0] = -1.0  # a batch is a copy, never the table
    assert (table >= 0).all()
