#!/usr/bin/env python3
"""The JAX reference's training figures on the CPU, for ``chip_smoke.py``'s
training phase to be held against.

This script runs the reference package (``src/repro``) on the CPU and never
runs on the card.  It trains, with the reference's own example code (its
step, optimizer, schedule, clip and data seeds):

  * the NVSA/PrAE frontend (``examples/raven_abduction.py::get_frontend``,
    4000 steps, into a scratch directory, never ``artifacts/``), then scores
    it with ``prae.accuracy`` on the reference test's batch
    (``RavenConfig(batch_size=32, seed=123)``) and on the 256 tasks of
    ``RavenConfig(batch_size=256)``, and with ``nvsa.solve`` on those 256
    tasks under three keys;
  * MIMONet (``examples/mimonet_superposition.py::train_eval``) at S = 1, 2
    and 4 (600 steps at B = 64, held out on ``default_rng(10_000)``), for
    each of ``--seeds`` seeds (0, 1, ...: the seed of both the init and the
    batches).  Training is chaotic: at S = 1 the held-out accuracy moves by
    a few points between seeds, and by as much between two starts 1e-6
    apart, so one seed's figure is a sample, not a constant.

With ``--init reference`` (the default) the nets start from the reference's
own ``cnn.init`` / ``mimonet.init`` draws and NVSA's codebooks from its own
``make_codebooks``.  With ``--init port`` they start from the port's draws
(``repro_torch``'s ``cnn.init(cfg, 0)``, ``mimonet.init(cfg, 0)`` and
``nvsa.make_codebooks(0)``, which are the same on every machine), so that
the reference trains exactly what ``chip_smoke.py`` phase 25 trains on the
card: the same initial weights, codebooks and batches (MIMONet: seed 0
only).

    PYTHONPATH=src python tools/reference_train_figures.py [--init port]
        [--seeds 5]

It prints one JSON line of the figures (about 1.5 minutes for the frontend
and 45 s a MIMONet run on 8 CPU cores).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NVSA_TASKS = 256
NVSA_KEYS = (7, 8, 9)
STREAMS = (1, 2, 4)


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--init", choices=("reference", "port"),
                    default="reference")
    ap.add_argument("--seeds", type=int, default=5,
                    help="MIMONet seeds 0..N-1 (--init reference)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.data import raven
    from repro.models import nvsa, prae

    out = {"jax": jax.__version__, "backend": jax.default_backend(),
           "init": args.init}
    ra = _example("raven_abduction")
    cfg = nvsa.NVSAConfig()
    k_cb, _ = jax.random.split(jax.random.PRNGKey(0))
    cbs, mask = nvsa.make_codebooks(k_cb, cfg)
    if args.init == "port":
        from repro_torch import convert
        from repro_torch.models import cnn as tcnn
        from repro_torch.models import mimonet as tmm
        from repro_torch.models import nvsa as tnvsa

        cbs = jnp.asarray(tnvsa.make_codebooks(
            0, tnvsa.NVSAConfig(), device="cpu")[0].numpy())
        cnn0 = convert.cnn_params_to_reference(
            tcnn.init(tnvsa.NVSAConfig().cnn, 0, device="cpu"))
        ra.cnn.init = lambda key, c: jax.tree.map(jnp.asarray, cnn0)
    with tempfile.TemporaryDirectory() as scratch:
        ra.ART = scratch  # train afresh; never read or write artifacts/
        t0 = time.perf_counter()
        params = ra.get_frontend(cfg, cbs)
        out["frontend_train_s"] = time.perf_counter() - t0
    test = {k: jnp.asarray(v) for k, v in raven.RavenDataset(
        raven.RavenConfig(batch_size=32, seed=123)).next_batch().items()}
    out["prae_test_batch"] = float(prae.accuracy(params, test, cfg.cnn))
    tasks = {k: jnp.asarray(v) for k, v in raven.RavenDataset(
        raven.RavenConfig(batch_size=NVSA_TASKS)).next_batch().items()}
    out["prae_256"] = float(prae.accuracy(params, tasks, cfg.cnn))
    accs = []
    for k in NVSA_KEYS:
        res = nvsa.solve(params, tasks, cbs, mask, jax.random.PRNGKey(k), cfg)
        accs.append(float(jnp.mean(
            (res["answer"] == tasks["answer"]).astype(jnp.float32))))
    out["nvsa_image_256"] = dict(zip(map(str, NVSA_KEYS), accs))
    out["nvsa_image_256_mean"] = float(np.mean(accs))
    print(json.dumps(out), flush=True)
    mm = _example("mimonet_superposition")
    out["mimonet"] = {}
    seeds = range(args.seeds) if args.init == "reference" else (0,)
    for S in STREAMS:
        if args.init == "port":
            mm0 = convert.mimonet_params_to_reference(tmm.init(
                tmm.MIMONetConfig(num_streams=S), 0, device="cpu"))
            mm.mimonet.init = lambda key, c, p=mm0: jax.tree.map(jnp.asarray,
                                                                   p)
        accs = []
        for seed in seeds:
            accs.append(mm.train_eval(S, seed=seed)[0])
            print(json.dumps({"S": S, "seed": seed, "accuracy": accs[-1]}),
                  flush=True)
        out["mimonet"][str(S)] = {"accuracy": accs, "mean": float(np.mean(
            accs)), "min": min(accs), "max": max(accs)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
