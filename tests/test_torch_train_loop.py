"""``repro_torch.train.{loop,checkpoint}`` against the reference's oracles
and files.

Ports of ``tests/test_train_infra.py::{test_loop_checkpoint_resume,
test_straggler_watchdog}``, then checkpoint interop: a checkpoint the port
writes restores through the reference's ``CheckpointManager`` and the other
way round, with equal arrays (bitwise: the files hold the numbers), equal
``extra`` and the same ``LATEST`` pointer.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as rc
from repro_torch.train import checkpoint as tc
from repro_torch.train import optimizer as optim
from repro_torch.train.loop import LoopConfig, StragglerWatchdog, run


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class ToyData:
    def __init__(self):
        self._step = 0

    def state(self):
        return {"step": self._step}

    def restore(self, s):
        self._step = int(s["step"])

    def __iter__(self):
        while True:
            x = np.random.default_rng(self._step).standard_normal(
                (16, 8)).astype(np.float32)
            self._step += 1
            x = torch.from_numpy(x)
            yield {"x": x, "y": x @ torch.arange(8.0).reshape(8, 1)}


def _toy(make_opt):
    """A fresh zero param, its optimizer, the loop state and the step."""
    w = torch.zeros((8, 1), requires_grad=True)
    opt = make_opt([w])

    def step(state, batch):
        loss = torch.mean((batch["x"] @ w - batch["y"]) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
        return state, {"loss": loss.detach()}

    return w, {"params": w, "opt": opt.state_tree()}, step


@pytest.mark.parametrize("make_opt", [
    lambda p: optim.sgd(p, 0.05), lambda p: optim.adamw(p, 0.05)],
    ids=["sgd", "adamw"])
def test_loop_checkpoint_resume(tmp_path, make_opt):
    cfg = LoopConfig(total_steps=25, checkpoint_every=10,
                     checkpoint_dir=str(tmp_path), log_every=5)
    w1, state1, step1 = _toy(make_opt)
    final1, hist1 = run(step1, state1, ToyData(), cfg)
    assert final1["params"] is w1 and [s for s, _ in hist1] == [0, 5, 10, 15,
                                                                  20]
    # fresh state, same dir: resumes from step 20 and matches
    w2, state2, step2 = _toy(make_opt)
    final2, hist2 = run(step2, state2, ToyData(), cfg)
    np.testing.assert_allclose(w1.detach().numpy(), w2.detach().numpy(),
                               atol=1e-6)
    assert hist2[0][0] >= 20  # resumed, did not restart from 0
    # the optimizer's state (moments and step) came back in place as well
    for a, b in zip(tc.flatten(state1["opt"]), tc.flatten(state2["opt"])):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    assert int(state2["opt"][0]["step"]) == 25


def test_straggler_watchdog():
    w = StragglerWatchdog(factor=3.0, alpha=0.5)
    for _ in range(5):
        assert not w.observe(0.1)
    assert w.observe(1.0)  # 10x the EWMA -> flagged
    assert w.flagged == 1
    assert abs(w.ewma - 0.1) < 0.02  # straggler did not poison the mean


def test_metrics_hook_sees_logged_and_slow_steps(tmp_path):
    w, state, step = _toy(lambda p: optim.sgd(p, 0.05))
    seen = []
    run(step, state, ToyData(), LoopConfig(total_steps=7, log_every=3),
        metrics_hook=lambda i, m, dt, slow: seen.append((i, slow)))
    assert [i for i, slow in seen if not slow] == [0, 3, 6]


# Checkpoint files ------------------------------------------------------------

def _tree(rng):
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "layers": [{"k": rng.standard_normal(5).astype(np.float32),
                        "b": np.arange(3, dtype=np.int32)},
                       {"k": rng.standard_normal(2).astype(np.float32),
                        "b": np.arange(2, dtype=np.int32)}],
            "step": np.array(7, np.int32)}


def test_flatten_follows_jax_order():
    tree = _tree(np.random.default_rng(0))
    want = jax.tree_util.tree_leaves(tree)
    got = tc.flatten(tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    rebuilt = tc.unflatten(tree, got)
    assert jax.tree_util.tree_structure(rebuilt) == \
        jax.tree_util.tree_structure(tree)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _tree(np.random.default_rng(1))
    port = jax.tree.map(torch.from_numpy, tree)
    mgr = tc.CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30):
        mgr.save(s, port, extra={"data_state": {"step": s}})
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_000000020",
                                            "step_000000030"]
    ref = rc.CheckpointManager(str(tmp_path))
    assert ref.latest_step() == 30
    like = jax.tree.map(jnp.zeros_like, tree)
    restored, extra = ref.restore(30, like)
    assert extra == {"data_state": {"step": 30}}
    for g, w in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves(tree)):
        assert np.asarray(g).dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g), w)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _tree(np.random.default_rng(2))
    ref = rc.CheckpointManager(str(tmp_path), async_save=False)
    ref.save(5, jax.tree.map(jnp.asarray, tree), extra={"note": "ref"})
    mgr = tc.CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 5
    with open(os.path.join(tmp_path, "LATEST")) as f:
        assert f.read() == "step_000000005"
    like = jax.tree.map(lambda a: torch.zeros(a.shape, dtype=torch.from_numpy(
        a).dtype), tree)
    restored, extra = mgr.restore(5, like)
    assert extra == {"note": "ref"}
    for g, w in zip(tc.flatten(restored), jax.tree_util.tree_leaves(tree)):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), w)


def test_bf16_leaves_cross_both_ways(tmp_path):
    vals = np.random.default_rng(3).standard_normal(6).astype(np.float32)
    bf = torch.from_numpy(vals).bfloat16()
    tc.CheckpointManager(str(tmp_path / "p"), async_save=False).save(
        1, {"m": bf})
    got, _ = tc.CheckpointManager(str(tmp_path / "p")).restore(
        1, {"m": torch.zeros(6, dtype=torch.bfloat16)})
    assert got["m"].dtype == torch.bfloat16 and torch.equal(got["m"], bf)
    ref = rc.CheckpointManager(str(tmp_path / "r"), async_save=False)
    ref.save(1, {"m": jnp.asarray(vals).astype(jnp.bfloat16)})
    got, _ = tc.CheckpointManager(str(tmp_path / "r")).restore(
        1, {"m": torch.zeros(6, dtype=torch.bfloat16)})
    assert torch.equal(got["m"], bf)


def test_restore_checks_the_leaf_count_and_places_on_device(tmp_path):
    mgr = tc.CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(3, {"a": torch.ones(2), "b": torch.zeros(3)})
    with pytest.raises(ValueError, match="2 leaves, template has 1"):
        mgr.restore(3, {"a": torch.ones(2)})
    got, _ = mgr.restore(3, {"a": torch.ones(2, dtype=torch.float64),
                             "b": np.zeros(3)}, device="cpu")
    assert got["a"].dtype == torch.float64 and got["b"].device.type == "cpu"


def test_an_async_save_snapshots_before_the_tensors_move_on(tmp_path):
    """save() returns once the leaves are copied: updating a CPU tensor in
    place right after it must not reach the files the thread writes."""
    w = torch.zeros(1 << 16)
    mgr = tc.CheckpointManager(str(tmp_path))
    for step in range(1, 6):
        w.fill_(step)
        mgr.save(step, {"w": w})
        w.fill_(-1.0)  # the next training step, while the writer runs
    mgr.wait()
    got, _ = mgr.restore(5, {"w": torch.empty(1 << 16)})
    assert torch.equal(got["w"], torch.full((1 << 16,), 5.0))
