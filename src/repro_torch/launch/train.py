"""LM training entry point: --arch <id> [--smoke] --steps N [--device cpu].

The port of ``repro/launch/train.py``: the model in the training layout
(fp32 masters, :func:`repro_torch.nn.transformer.init` with
``trainable=True``), the synthetic token stream of
:mod:`repro_torch.data.tokens`, and the real loop
(:func:`repro_torch.train.loop.run`): optimizer and schedule per
``ArchSpec``, gradient clipping, checkpoints every 10 steps when a
directory is given, the straggler watchdog, a resumable data position.
Full configs run at full width on one card where they fit (Llama 3.2 3B:
57.7 GB of masters, gradients and AdamW moments); ``--smoke`` runs the
reduced same-family config.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --smoke --steps 30 --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.data.tokens import TokenConfig, TokenDataset
from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.nn import transformer as T
from repro_torch.train import optimizer as optim
from repro_torch.train.loop import LoopConfig, run


def build_train_step(model: T.LM, spec, total_steps: int) -> tuple:
    """(optimizer, ``train_step(state, batch) -> (state, metrics)``) for a
    model in the training layout.

    A step is the reference's: ``loss_fn`` with gradients, the gradients
    clipped to global norm 1.0 in place, the optimizer's update of every
    leaf in place, then the gradients set to None (so the next backward
    allocates them afresh and nothing leaf-sized lingers between steps).
    ``state`` passes through untouched (the model and the optimizer hold
    the tensors; :func:`repro_torch.train.loop.run` checkpoints them).
    Metrics: ``ce``, the MoE aux terms, ``loss`` and ``grad_norm``, on the
    device (no host sync).

    The optimizer is the reference's recipe for ``spec``: Adafactor at
    1e-2, or AdamW with a cosine (or WSD) schedule peaking at 3e-4 after
    ``total_steps // 20`` warmup steps (at least 1), its moments in
    ``spec.opt_state_dtype``."""
    cfg = model.cfg
    params = list(model.parameters())
    if spec.optimizer == "adafactor":
        opt = optim.adafactor(params, 1e-2)
    else:
        schedule = (optim.wsd_schedule if spec.schedule == "wsd"
                    else optim.cosine_schedule)
        dt = (torch.bfloat16 if spec.opt_state_dtype == "bf16"
              else torch.float32)
        opt = optim.adamw(params, schedule(3e-4, max(total_steps // 20, 1),
                                           total_steps), state_dtype=dt)

    def train_step(state, batch):
        loss, metrics = T.loss_fn(model, cfg, batch)
        loss.backward()
        _, gnorm = optim.clip_by_global_norm([p.grad for p in params], 1.0)
        opt.step()
        opt.zero_grad(set_to_none=True)
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        return state, {**metrics, "loss": loss.detach(), "grad_norm": gnorm}

    return opt, train_step


def batch_extras(cfg, batch: dict, generator: torch.Generator) -> dict:
    """The arch's extra inputs: M-RoPE positions (every stream 0..S-1) and
    Gaussian bf16 vision patches, or bf16 encoder frames, drawn from
    ``generator`` on its device."""
    b = dict(batch)
    B, S = b["tokens"].shape
    dev = b["tokens"].device
    if cfg.mrope_sections is not None:
        b["positions"] = torch.arange(S, dtype=torch.int32, device=dev)[
            None, None].expand(B, 3, S).contiguous()
        b["vision_embeds"] = torch.randn(
            (B, cfg.vision_patches, cfg.d_model), generator=generator,
            device=generator.device).to(dev, torch.bfloat16)
    if cfg.encoder is not None:
        e = cfg.encoder
        b["encoder_frames"] = torch.randn(
            (B, e.n_frames, e.d_model), generator=generator,
            device=generator.device).to(dev, torch.bfloat16)
    return b


class TokenBatches:
    """The token stream as the step's batches on ``device``, with the
    arch's extras; ``state``/``restore`` are the dataset's (resume).  As in
    the reference, whose ``main`` draws every batch's extras from the same
    ``PRNGKey(1)``, the extras are the same each step: each batch draws
    them from a fresh generator of seed 1."""

    def __init__(self, cfg, ds: TokenDataset, device):
        self.cfg, self.ds, self.device = cfg, ds, resolve(device)

    def state(self) -> dict:
        return self.ds.state()

    def restore(self, s: dict) -> None:
        self.ds.restore(s)

    def __iter__(self):
        for b in self.ds:
            toks = {k: torch.from_numpy(np.asarray(v)).to(self.device)
                    for k, v in b.items()}
            yield batch_extras(self.cfg, toks,
                               torch.Generator().manual_seed(1))


def main(argv=None) -> list:
    """Train ``--arch`` for ``--steps`` steps and print the loop's log;
    returns the loop's history (every 5th step's metrics)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    spec = registry.get(args.arch)
    cfg = spec.smoke() if args.smoke else spec.full()
    dev = resolve(args.device)
    model = T.init(cfg, 0, dev, trainable=True)
    print(f"{cfg.name}: {T.param_count(model):,} params on {dev}")
    opt, train_step = build_train_step(model, spec, args.steps)
    state = {"params": list(model.parameters()), "opt": opt.state_tree()}
    data = TokenBatches(cfg, TokenDataset(
        TokenConfig(cfg.vocab, args.seq, args.batch)), dev)

    def hook(step, metrics, dt, slow):
        flag = " STRAGGLER" if slow else ""
        print(f"step {step:5d} loss={float(metrics['loss']):.4f} "
              f"ce={float(metrics['ce']):.4f} {dt*1e3:7.1f}ms{flag}",
              flush=True)

    state, history = run(train_step, state, data,
                         LoopConfig(total_steps=args.steps, log_every=5,
                                    checkpoint_every=10,
                                    checkpoint_dir=args.ckpt_dir),
                         metrics_hook=hook)
    first, last = history[0][1]["ce"], history[-1][1]["ce"]
    print(f"ce: {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return history


if __name__ == "__main__":
    main()
