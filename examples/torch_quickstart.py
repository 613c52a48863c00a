"""Quickstart of the PyTorch port: the CogSys core in one page.

The port of ``examples/quickstart.py``.  Builds a block-code VSA, binds a
(shape, size, color) scene into one product hypervector, and factorizes it
back with the CogSys resonator, the operation the whole framework
accelerates; then a batch of scenes, and the same scene against int8
codebooks (on the card every int8 score is one launch of
``similarity_int8``, one a factor a sweep).

:func:`main` returns every figure it prints.  ``arrays`` may supply the
codebooks (``{"codebooks": [F, M, D]}``, e.g. the reference's); without it
they are drawn from seed 0.  The stochastic sweeps draw from
``core/rng.py`` (Philox), not ``jax.random``, so iteration counts differ
from the reference's; the decoded scenes do not.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import convert
from repro_torch.core import factorizer as fz
from repro_torch.core import vsa
from repro_torch.device import DEFAULT_DEVICE, resolve

SCENE = [7, 2, 5]
SCENES = [[7, 2, 5], [1, 8, 3], [4, 4, 9], [0, 6, 1]]


def main(device=DEFAULT_DEVICE, *, arrays: dict | None = None) -> dict:
    dev = resolve(device)
    # 1. a block-code VSA: binding = block-wise circular convolution
    vcfg = vsa.VSAConfig(dim=1024, blocks=4)
    # 2. attribute codebooks: 3 factors (shape/size/color), 10 atoms each
    cfg = fz.FactorizerConfig(
        vsa=vcfg, num_factors=3, codebook_size=10, algebra="unitary",
        activation="abs", noise_std=0.3, restart_every=20,  # Sec. IV-B
        max_iters=60, conv_threshold=0.55)
    codebooks = (convert.from_numpy(arrays["codebooks"], dev)
                 if arrays is not None else
                 fz.make_codebooks(0, cfg, device=dev))

    # 3. bind a scene: shape=7, size=2, color=5 -> ONE vector in superposition
    scene = torch.tensor(SCENE, device=dev)
    q = fz.bind_combo(codebooks, scene, vcfg)
    print(f"scene {SCENE} bound into a single {vcfg.dim}-d vector")

    # 4. factorize it back (the paper's efficient factorization, Sec. IV-A)
    res = fz.factorize(q, codebooks, 1, cfg, device=dev)
    decoded = res.indices.tolist()
    print(f"decoded {decoded} in {int(res.iterations)} iterations "
          f"(reconstruction cosine {float(res.reconstruction_sim):.3f})")
    assert decoded == SCENE

    # 5. the memory story: factorized codebooks vs the exhaustive product
    mem = fz.codebook_bytes(cfg)
    print(f"memory: factorized {mem['factorized_bytes'] / 2**20:.2f} MB vs "
          f"exhaustive {mem['product_bytes'] / 2**20:.1f} MB "
          f"({mem['reduction']:.0f}x smaller)")

    # 5b. serving is batch-native: N scenes share ONE factorizer loop, and
    # each query reports its own iteration count (converged queries freeze
    # behind the per-query done mask instead of re-running to the batch max)
    scenes = torch.tensor(SCENES, device=dev)
    qs = fz.bind_combo(codebooks, scenes, vcfg)  # [4, D], batched bind
    bres = fz.factorize_batch(qs, codebooks, 1, cfg, device=dev)
    biters = bres.iterations.tolist()
    print(f"batched decode of {len(SCENES)} scenes: per-query iterations "
          f"{biters} (mean {float(bres.iterations.float().mean()):.1f} vs "
          f"max {max(biters)})")
    assert bres.indices.tolist() == SCENES

    # 6. and the low-precision story (Tab. IX): int8 codebooks, same answer
    q8 = fz.quantize_codebooks(codebooks, "int8")
    cfg8 = dataclasses.replace(cfg, codebook_fmt="int8")
    res8 = fz.factorize(q, q8, 1, cfg8, device=dev)
    decoded8 = res8.indices.tolist()
    print(f"int8 codebooks ({q8.nbytes() / 2**20:.2f} MB): decoded {decoded8}")
    assert decoded8 == SCENE
    print("OK")
    return {"scene": SCENE, "decoded": decoded,
            "iterations": int(res.iterations),
            "reconstruction_sim": float(res.reconstruction_sim),
            "codebook_bytes": mem, "batched_indices": bres.indices.tolist(),
            "batched_iterations": biters, "int8_decoded": decoded8,
            "int8_iterations": int(res8.iterations),
            "int8_bytes": q8.nbytes(), "num_factors": cfg.num_factors}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    figures = main(ap.parse_args().device)
