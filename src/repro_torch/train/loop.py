"""Generic fault-tolerant training loop.

The port of ``repro/train/loop.py``.  Wires together a train step, an input
pipeline (with checkpointable state), :class:`CheckpointManager` (async,
atomic, restore onto any device), a straggler watchdog (per-step wall-clock
EWMA) and crash-resume (restores the latest checkpoint, the pipeline's
position included).

The train state is a tree (dicts, lists, tuples) of tensors, typically the
model's parameters and :meth:`~repro_torch.train.optimizer._Base.state_tree`.
A resume copies the checkpoint into those tensors in place, so a step that
closes over a module and its optimizer sees the restored values too.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable

import torch

from repro_torch.train.checkpoint import CheckpointManager, flatten


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    log_every: int = 10
    checkpoint_every: int = 100
    checkpoint_dir: str | None = None
    keep_checkpoints: int = 3
    straggler_factor: float = 3.0  # flag steps slower than factor x EWMA
    ewma_alpha: float = 0.1


@dataclasses.dataclass
class StragglerWatchdog:
    """Flags anomalously slow steps (node degradation / preemption signal)."""

    factor: float = 3.0
    alpha: float = 0.1
    ewma: float | None = None
    flagged: int = 0

    def observe(self, dt: float) -> bool:
        slow = self.ewma is not None and dt > self.factor * self.ewma
        if slow:
            self.flagged += 1
        else:  # stragglers don't poison the running mean
            self.ewma = dt if self.ewma is None else \
                (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow


def _sync(metrics) -> None:
    """Wait for the devices that hold ``metrics`` (the reference's
    ``jax.block_until_ready``)."""
    for dev in {x.device for x in flatten(metrics)
                if isinstance(x, torch.Tensor) and x.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


@torch.no_grad()
def _assign(state, restored) -> None:
    for dst, src in zip(flatten(state), flatten(restored)):
        if not isinstance(dst, torch.Tensor):
            raise TypeError("a resumable train state holds tensors only, "
                            f"not {type(dst).__name__}")
        dst.copy_(src)


def run(train_step: Callable, state: Any, data: Iterable, cfg: LoopConfig,
        metrics_hook: Callable | None = None) -> Any:
    """Run the loop; ``train_step(state, batch) -> (state, metrics)``.
    ``data`` exposes optional ``.state()`` / ``.restore()`` for resume.
    Returns ``(final train state, history)``: history holds ``(step,
    {name: float})`` every ``log_every`` steps.
    """
    ckpt = CheckpointManager(cfg.checkpoint_dir, keep=cfg.keep_checkpoints) \
        if cfg.checkpoint_dir else None
    start = 0
    if ckpt is not None:
        latest = ckpt.latest_step()
        if latest is not None:
            restored, extra = ckpt.restore(latest, state)
            _assign(state, restored)
            start = latest
            if hasattr(data, "restore") and "data_state" in extra:
                data.restore(extra["data_state"])
    watchdog = StragglerWatchdog(cfg.straggler_factor, cfg.ewma_alpha)
    it = iter(data)
    history = []
    for step in range(start, cfg.total_steps):
        batch = next(it)
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        _sync(metrics)
        dt = time.perf_counter() - t0
        slow = watchdog.observe(dt)
        if metrics_hook and (step % cfg.log_every == 0 or slow):
            metrics_hook(step, metrics, dt, slow)
        if step % cfg.log_every == 0:
            history.append((step, {k: float(v) for k, v in metrics.items()}))
        if ckpt is not None and (step + 1) % cfg.checkpoint_every == 0:
            extra = {"data_state": data.state()} if hasattr(data, "state") \
                else {}
            ckpt.save(step + 1, state, extra)
    if ckpt is not None:
        ckpt.wait()
    return state, history
