"""LVRF on the PyTorch port: learned rule vectors and out-of-distribution
detection (workload 3).

The port of ``examples/lvrf_ood.py``.  Rules are learned one-shot as
bundles of row encodings; abduction scores observed rows against the rule
codebook by VSA similarity; rows generated by an UNSEEN rule are flagged OOD
by the similarity threshold.

:func:`main` returns every figure it prints.  ``arrays`` may supply the
atoms (``{"atoms": {"values": [n_values, D], "positions": [3, D]}}``, e.g.
the reference's); without it they are drawn from seed 0.  The rows come
from ``numpy.random.default_rng(1)`` in the reference's order, so the same
atoms give the reference's figures.

    PYTHONPATH=src python examples/torch_lvrf_ood.py [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import vsa as vsa_mod
from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.models import lvrf

TRAIN_RULES = ("constant", "progression_p1", "arithmetic_plus")
HELDOUT_RULE = "arithmetic_minus"  # never shown at rule-learning time


def make_rows(rng, rule, n, n_values, device):
    rows = lvrf.make_rule_examples(rng, [rule], n_values, examples=n)[0]
    return torch.from_numpy(rows).to(device)


def main(device=DEFAULT_DEVICE, *, arrays: dict | None = None) -> dict:
    dev = resolve(device)
    # D = 8192 so a 256-row bundle keeps member-similarity SNR ~6 (bundle
    # capacity scales with sqrt(D)); member similarity ~1/sqrt(256) sets the
    # OOD threshold scale.
    cfg = lvrf.LVRFConfig(vsa=vsa_mod.VSAConfig(8192, 8192),
                          ood_threshold=0.03)
    atoms = (convert.lvrf_atoms_from_reference(arrays["atoms"], dev)
             if arrays is not None else lvrf.init_atoms(0, cfg, device=dev))
    rng = np.random.default_rng(1)
    # a rule vector is the bundle of its example-row encodings, so execution
    # accuracy tracks row-space coverage: 256 draws cover ~93% of the 100
    # possible arithmetic rows
    examples = lvrf.make_rule_examples(rng, TRAIN_RULES, cfg.n_values,
                                       examples=256)
    rules = lvrf.learn_rules(atoms, examples, cfg)
    print(f"learned {len(TRAIN_RULES)} rule vectors one-shot from "
          f"{examples.shape[1]} example rows each")

    # abduction accuracy on in-distribution rows
    correct = 0
    for ri, rname in enumerate(TRAIN_RULES):
        rows = make_rows(rng, rname, 64, cfg.n_values, dev).reshape(32, 2, 3)
        out = lvrf.abduce(atoms, rules, rows, cfg)
        correct += int((torch.argmax(out["posterior"], -1) == ri).sum())
    abduction = correct / (3 * 32)
    print(f"rule abduction accuracy: {abduction:.3f}")

    # execution: predict the missing third value
    rows = make_rows(rng, "arithmetic_plus", 64, cfg.n_values,
                     dev).reshape(32, 2, 3)
    out = lvrf.abduce(atoms, rules, rows, cfg)
    scores = lvrf.execute(atoms, rules, out["posterior"], rows[:, 1, :2], cfg)
    pred = torch.argmax(scores, -1)
    execution = float((pred == rows[:, 1, 2]).float().mean())
    print(f"execution (complete the row) accuracy: {execution:.3f}")

    # OOD: rows from the held-out rule should be flagged
    id_rows = make_rows(rng, "constant", 64, cfg.n_values,
                        dev).reshape(32, 2, 3)
    ood_rows = make_rows(rng, HELDOUT_RULE, 64, cfg.n_values,
                         dev).reshape(32, 2, 3)
    id_flag = lvrf.abduce(atoms, rules, id_rows, cfg)["ood"]
    ood_flag = lvrf.abduce(atoms, rules, ood_rows, cfg)["ood"]
    id_rate = float(id_flag.float().mean())
    ood_rate = float(ood_flag.float().mean())
    print(f"OOD flag rate: in-dist={id_rate:.2f} held-out-rule={ood_rate:.2f} "
          "(LVRF's OOD pathway: high on unseen rules)")
    return {"rules": len(TRAIN_RULES), "examples": int(examples.shape[1]),
            "abduction_accuracy": abduction,
            "execution_accuracy": execution,
            "ood_rate_in_dist": id_rate, "ood_rate_held_out": ood_rate}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    figures = main(ap.parse_args().device)
