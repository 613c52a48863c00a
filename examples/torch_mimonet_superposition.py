"""MIMONet computation in superposition (paper workload 2), trained end to
end with the PyTorch port.

The port of ``examples/mimonet_superposition.py``.  S panel images are
bound to per-stream VSA keys, bundled into ONE vector and pushed through ONE
shared backbone pass; per-stream attribute predictions are recovered by
unbinding.  :func:`train_eval` trains with the reference's recipe (AdamW at
1e-3, global-norm clip 1.0, 600 steps of B = 64 items from
``default_rng(seed)``) through ``impl="fft"`` (the circconv kernel has no
gradient), then reports held-out accuracy and panels/s: the paper's 2-4x
speedup-at-small-accuracy-cost trade.

    PYTHONPATH=src python examples/torch_mimonet_superposition.py
        [--streams 1 2 4] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.data import raven
from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.models import mimonet
from repro_torch.train import optimizer as optim

TEST_SEED, TEST_ITEMS = 10_000, 256


def batch_streams(rng, B: int, S: int, device=DEFAULT_DEVICE) -> dict:
    """B items of S panels each (``attribute_classification_batch(rng, B *
    S)``) as tensors on ``device``."""
    dev = resolve(device)
    b = raven.attribute_classification_batch(rng, B * S)
    return {"images": torch.from_numpy(b["images"]).reshape(B, S, 32, 32)
            .to(dev),
            **{a: torch.from_numpy(b[a]).reshape(B, S).to(dev)
               for a in mimonet.ATTRS}}


def accuracy(model, batch: dict, cfg: mimonet.MIMONetConfig) -> float:
    """Mean over the three attributes of ``loss_fn``'s accuracies."""
    with torch.no_grad():
        _, accs = mimonet.loss_fn(model, batch, cfg)
    return float(np.mean([float(a) for a in accs.values()]))


def panels_per_s(model, images: torch.Tensor, cfg: mimonet.MIMONetConfig,
                 reps: int = 5) -> float:
    """Panels a second through the shared backbone: the mean of ``reps``
    forward passes over ``images`` [N, S, H, W], after one warm-up."""
    def fwd():
        with torch.no_grad():
            mimonet.apply(model, images, cfg)[0].sum().item()  # waits
    fwd()
    t0 = time.perf_counter()
    for _ in range(reps):
        fwd()
    dt = (time.perf_counter() - t0) / reps
    return images.shape[0] * images.shape[1] / dt


def train_eval(S: int, steps: int = 600, B: int = 64, seed: int = 0,
               device=DEFAULT_DEVICE, report: dict | None = None) -> tuple:
    """Train MIMONet at ``MIMONetConfig(num_streams=S)`` and return
    ``(held-out accuracy, panels/s)``.  ``report`` (when given) receives the
    frozen model, its config, the held-out batch, the training wall and the
    host data time."""
    dev = resolve(device)
    cfg = mimonet.MIMONetConfig(num_streams=S)
    model = mimonet.init(cfg, seed, device=dev).requires_grad_(True)
    params = list(model.parameters())
    opt = optim.adamw(params, 1e-3)
    rng = np.random.default_rng(seed)
    data_s = 0.0
    t_all = time.perf_counter()
    for _ in range(steps):
        t0 = time.perf_counter()
        batch = batch_streams(rng, B, S, dev)
        data_s += time.perf_counter() - t0
        loss, _ = mimonet.loss_fn(model, batch, cfg)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        optim.clip_by_global_norm([p.grad for p in params], 1.0)
        opt.step()
    final_loss = float(loss.detach())  # waits for the last step
    wall = time.perf_counter() - t_all
    model.requires_grad_(False)
    test = batch_streams(np.random.default_rng(TEST_SEED), TEST_ITEMS, S, dev)
    acc = accuracy(model, test, cfg)
    tp = panels_per_s(model, test["images"], cfg)
    if report is not None:
        report.update(model=model, cfg=cfg, test=test, wall_s=wall,
                      data_s=data_s, final_loss=final_loss,
                      steps_per_s=steps / wall)
    return acc, tp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, nargs="*", default=[1, 2, 4])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args()
    base_tp = None
    for S in args.streams:
        acc, tp = train_eval(S, device=args.device)
        base_tp = base_tp or tp
        print(f"S={S}: attribute accuracy={acc:.3f} throughput={tp:,.0f} "
              f"panels/s ({tp / base_tp:.2f}x vs S=1)")
    print("(paper: MIMONets trade a few accuracy points for 2-4x throughput)")


if __name__ == "__main__":
    main()
