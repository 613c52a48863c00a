"""End-to-end driver of the PyTorch port: train the NVSA/PrAE frontend, then
serve RAVEN abduction tasks with it.

The port of ``examples/raven_abduction.py``.  :func:`get_frontend` trains
the CNN frontend with the reference's recipe (``cnn.init`` from seed 0,
``attribute_classification_batch(default_rng(0), 128)`` batches,
``adamw(cosine_schedule(3e-3, 100, steps))``, global-norm clip 1.0, 4000
steps) through :func:`repro_torch.train.loop.run`, saves it to
``artifacts/nvsa_frontend_torch.pt`` and loads it from there when it is
present.  :func:`main` then serves tasks through the adSCH-planned pipeline
and per-batch ``solve`` calls, and reports accuracy and latency.

    PYTHONPATH=src python examples/torch_raven_abduction.py [--tasks 128]
        [--device cuda|cpu] [--steps 4000]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch import engine
from repro_torch.data import raven
from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.models import cnn, nvsa
from repro_torch.train import loop
from repro_torch.train import optimizer as optim

ART = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                   "artifacts")
DEFAULT_PATH = os.path.join(ART, "nvsa_frontend_torch.pt")
BATCH = 128
LOG_EVERY = 1000


class Batches:
    """``attribute_classification_batch(default_rng(seed), batch)`` batches
    as tensors on ``device``; ``data_s`` sums the host time spent making
    and copying them."""

    def __init__(self, seed: int, batch: int, device):
        self.rng = np.random.default_rng(seed)
        self.batch = batch
        self.device = device
        self.data_s = 0.0

    def __iter__(self):
        while True:
            t0 = time.perf_counter()
            b = raven.attribute_classification_batch(self.rng, self.batch)
            out = {k: torch.from_numpy(v).to(self.device)
                   for k, v in b.items()}
            self.data_s += time.perf_counter() - t0
            yield out


def get_frontend(cfg: nvsa.NVSAConfig, cbs: torch.Tensor, steps: int = 4000,
                 device=DEFAULT_DEVICE, path: str = DEFAULT_PATH,
                 report: dict | None = None) -> cnn.CNN:
    """The trained frontend, frozen, on ``device``: loaded from ``path`` if
    it exists, else trained for ``steps`` steps against the codebooks
    ``cbs`` and saved there.  A trained run fills ``report`` (when given)
    with its loss and cosine at steps 0, 1000, ... and the last, the wall,
    steps/s and the host data time."""
    dev = resolve(device)
    if os.path.exists(path):
        return cnn.CNN(torch.load(path, map_location=dev, weights_only=True))
    print(f"training frontend for {steps} steps on {dev}...", flush=True)
    model = cnn.init(cfg.cnn, 0, device=dev).requires_grad_(True)
    params = list(model.parameters())
    opt = optim.adamw(params, optim.cosine_schedule(3e-3, 100, steps))
    books = cbs.to(dev)
    last = {}

    def step(state, batch):
        loss, m = nvsa.frontend_loss(model, batch, books, cfg)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        optim.clip_by_global_norm([p.grad for p in params], 1.0)
        opt.step()
        last["metrics"] = {"loss": loss.detach(), **m}
        return state, last["metrics"]

    def hook(i, m, dt, slow):
        if i % LOG_EVERY == 0:
            print(f"  step {i}: loss={float(m['loss']):.4f} "
                  f"cos={float(m['cosine']):.3f}", flush=True)

    data = Batches(0, BATCH, dev)
    t0 = time.perf_counter()
    _, history = loop.run(step, {"params": params, "opt": opt.state_tree()},
                          data, loop.LoopConfig(total_steps=steps,
                                                log_every=LOG_EVERY),
                          metrics_hook=hook)
    wall = time.perf_counter() - t0
    final = {k: float(v) for k, v in last["metrics"].items()}
    print(f"  step {steps - 1}: loss={final['loss']:.4f} "
          f"cos={final['cosine']:.3f}", flush=True)
    model.requires_grad_(False)
    if report is not None:
        report.update(history=history + [(steps - 1, final)], wall_s=wall,
                      steps_per_s=steps / wall, data_s=data.data_s,
                      step_s=wall - data.data_s)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(model.state_dict(), path)
    return model


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tasks", type=int, default=128)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args()
    dev = resolve(args.device)
    cfg = nvsa.NVSAConfig()
    cbs, mask = nvsa.make_codebooks(0, cfg, device=dev)
    model = get_frontend(cfg, cbs, args.steps, device=dev)

    ds = raven.RavenDataset(raven.RavenConfig(batch_size=args.batch, seed=99))
    n_batches = max(1, args.tasks // args.batch)
    batches = [ds.next_batch() for _ in range(n_batches)]
    imgs = torch.from_numpy(np.stack([b["images"] for b in batches])).to(dev)
    cands = torch.from_numpy(
        np.stack([b["candidate_images"] for b in batches])).to(dev)
    answers = np.stack([b["answer"] for b in batches])

    # adSCH-planned pipelined stream: the engine orders the declared stage
    # graph's neural(t) and symbolic(t-1) by the scheduler's decision
    runner = engine.build_pipeline(
        nvsa.stage_graph(model, cbs, mask, cfg, batch=args.batch))
    print(f"adSCH plan: lags={runner.plan.lags} depth={runner.depth} "
          f"(modeled gain {runner.plan.gains[0]:.2f}x)")
    t0 = time.perf_counter()
    preds = runner((imgs, cands), 7).cpu().numpy()
    dt = time.perf_counter() - t0
    acc = (preds == answers).mean()
    n = n_batches * args.batch
    print(f"solved {n} RPM tasks: accuracy={acc:.3f} "
          f"({dt:.2f}s total, {dt / n * 1e3:.1f} ms/task on {dev}; "
          f"paper's accelerator target: <0.3 s/task)")
    t0 = time.perf_counter()
    it_mean, it_max = [], []
    for b in batches:
        out = nvsa.solve(model, b, cbs, mask, 7, cfg)
        it_mean.append(float(out["fact_mean_iters"]))
        it_max.append(int(out["fact_max_iters"]))
    dt_seq = time.perf_counter() - t0
    print(f"sequential solver: {dt_seq:.2f}s -> pipelined speedup "
          f"{dt_seq / dt:.2f}x (adSCH software analogue)")
    print(f"factorizer iterations/query: mean {np.mean(it_mean):.1f} "
          f"vs batch-max {max(it_max)} (masked queries freeze early)")


if __name__ == "__main__":
    main()
