"""LVRF: probabilistic abduction via learned rules in VSA (paper Sec. II-D, workload 3).

The port of ``repro/models/lvrf.py``.  A row of panel attributes
(v1, v2, v3) is encoded as the Hadamard product of the value atoms, each
rolled by its slot's permutation; a rule's vector is the bundle of all row
encodings consistent with it, learned one-shot from examples.  Abduction
scores observed rows against the rule codebook by VSA similarity; execution
scores each candidate value by the similarity of the completed row under the
abduced rule.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import vsa
from repro_torch.device import DEFAULT_DEVICE, generator as as_generator


@dataclasses.dataclass(frozen=True)
class LVRFConfig:
    vsa: vsa.VSAConfig = vsa.VSAConfig(dim=2048, blocks=2048)  # bipolar MAP
    n_values: int = 10  # attribute cardinality
    ood_threshold: float = 0.12  # max rule similarity below this -> abstain


def init_atoms(generator, cfg: LVRFConfig, device=DEFAULT_DEVICE) -> dict:
    """Value and position atoms from a ``torch.Generator`` or an int seed."""
    generator = as_generator(generator)
    return {
        "values": vsa.random_bipolar(generator, (cfg.n_values,), cfg.vsa,
                                     device=device),
        "positions": vsa.random_bipolar(generator, (3,), cfg.vsa,
                                        device=device),
    }


def encode_row(atoms: dict, values, cfg: LVRFConfig) -> torch.Tensor:
    """values [..., 3] ints -> row vector [..., D].

    Positions bind by PERMUTATION (cyclic roll), not by multiplication: the
    Hadamard product is commutative, so multiplying position vectors in
    would make the encoding order-invariant.  rho^i(A(v_i)) keeps the
    value-to-slot pairing.
    """
    table = atoms["values"]
    values = torch.as_tensor(values, device=table.device).long()
    v_atoms = table[values]  # [..., 3, D]
    rolled = torch.stack([torch.roll(v_atoms[..., i, :], 17 * (i + 1), dims=-1)
                          for i in range(3)], dim=-2)
    return torch.prod(rolled, dim=-2)


def row_codebooks(atoms: dict, cfg: LVRFConfig) -> torch.Tensor:
    """Factorizer codebooks [3, n_values, D] for decoding row encodings.

    Position i's codebook holds the value atoms pre-rolled by that slot's
    permutation, so binding one atom per factor reproduces
    :func:`encode_row` exactly.
    """
    return torch.stack([torch.roll(atoms["values"], 17 * (i + 1), dims=-1)
                        for i in range(3)])


def row_factorizer_config(cfg: LVRFConfig, *, max_iters: int = 40,
                          conv_threshold: float = 0.8,
                          synchronous: bool = False,
                          fused_step: bool = False):
    """FactorizerConfig for :func:`row_codebooks` (MAP/bipolar, lanes == 1).

    ``synchronous=True`` switches the sweep to Jacobi — required by
    ``fused_step=True``, which then runs the whole sweep in the fused kernel.
    """
    from repro_torch.core import factorizer as fz
    return fz.FactorizerConfig(
        vsa=cfg.vsa, num_factors=3, codebook_size=cfg.n_values,
        algebra="bipolar", max_iters=max_iters, conv_threshold=conv_threshold,
        synchronous=synchronous, fused_step=fused_step)


def learn_rules(atoms: dict, rule_rows, cfg: LVRFConfig) -> torch.Tensor:
    """One-shot rule learning: bundle example-row encodings per rule.

    rule_rows: [R, E, 3] int — E example rows per rule. Returns [R, D].
    """
    enc = encode_row(atoms, rule_rows, cfg)  # [R, E, D]
    return vsa.normalize_sign(torch.sum(enc, dim=1))


def abduce(atoms: dict, rules: torch.Tensor, rows, cfg: LVRFConfig) -> dict:
    """Infer the rule governing observed rows [..., K, 3] (K complete rows).

    Returns posterior over rules plus an OOD flag when no rule explains the
    rows.
    """
    enc = encode_row(atoms, rows, cfg)  # [..., K, D]
    sims = vsa.similarity(enc[..., None, :], rules)  # [..., K, R]
    score = torch.sum(sims, dim=-2)  # evidence across rows
    post = torch.softmax(score * 8.0, dim=-1)
    ood = torch.amax(score, dim=-1) / enc.shape[-2] < cfg.ood_threshold
    return {"posterior": post, "scores": score, "ood": ood}


def execute(atoms: dict, rules: torch.Tensor, post: torch.Tensor, prefix,
            cfg: LVRFConfig) -> torch.Tensor:
    """Score each candidate completion v of row (v1, v2, ?) under the posterior.

    prefix: [..., 2] int. Returns [..., n_values] candidate scores.
    """
    prefix = torch.as_tensor(prefix, device=rules.device).long()
    cand = torch.arange(cfg.n_values, device=rules.device)
    pre = prefix[..., None, :].expand(*prefix.shape[:-1], cfg.n_values, 2)
    rows = torch.cat([pre, cand[:, None].expand(pre.shape[:-1] + (1,))],
                     dim=-1)  # [..., n, 3]
    enc = encode_row(atoms, rows, cfg)  # [..., n, D]
    sims = vsa.similarity(enc[..., None, :], rules)  # [..., n, R]
    return torch.einsum("...nr,...r->...n", sims, post)


def make_rule_examples(rng, rules, n_values: int, examples: int = 64):
    """Training rows for the synthetic rule set (host-side, numpy rng)."""
    from repro_torch.data.raven import apply_rule
    out = np.zeros((len(rules), examples, 3), dtype=np.int32)
    for r_i, r in enumerate(rules):
        for e in range(examples):
            row = np.zeros(3, dtype=np.int64)
            row[0] = rng.integers(0, n_values)
            if r == "distribute_three":
                vals = rng.choice(n_values, size=3, replace=False)
                out[r_i, e] = vals
            else:
                out[r_i, e] = apply_rule(r, row, n_values, rng)
    return out
