"""The numbers that decide ``correct``, and their limits.

A system's ``compare`` (``systems/*.py``) holds the program's outcomes of a
sample of requests against what the plain reference works out from the same
inputs, and builds its numbers from the functions here.  Each number has its
limit in the configuration's file (``limits``), set from two readings: the
largest that sound runs give over a dozen seeds or more, and the smallest
that the control (the reference one precision lower, in the program's place)
or a planted fault gives (``PERF.md`` lists both).  A number is within its
limit when it does not exceed it.

A stochastic row's trajectory turns on the last bit of a score: the sign
of a near-zero spectral bin or an argmax near a tie.  Rows that settle in a
few sweeps follow the reference's path exactly; longer ones leave it under
any change of rounding (the same query in a batch of another size does).
So each row is held to what holds whatever its path, the sample's
statistics to the reference's on the same rows, and scores to the
reference's on the rows whose path it reproduced.  Over the sampled rows of
a factorization:

* ``wrong_decode_excess``: the share of the rows that the program reports
  converged whose indices are not the atoms bound into their query, less
  the reference's share on the same rows.  The share itself is not 0 in a
  sound run: convergence is tested on a sweep's argmax atoms, and the
  indices come from a final scoring of the frozen estimates, which on some
  1 % of converged rows picks other atoms, in the reference as in the port;
* ``score_gap``: over the rows that converged after as many sweeps as the
  reference's, the ``SCORE_QUANTILE`` quantile of each row's gap: its widest
  score gap as a share of its largest reference score (masked atoms left
  out), or 1 where its decoded indices differ from the reference's;
* ``converged_gap``: over the rows drawn from the seed (not those added for
  their many sweeps), the program's converged share less the reference's,
  in absolute value: a restart or a noise draw that departs from the
  configuration moves it, where rows' paths differ anyway;
* ``iterations_gap``: over the same rows, the program's mean sweeps less the
  reference's, in absolute value, over the reference's.
"""
from __future__ import annotations

import numpy as np

MASKED = 1e8  # scores at or beyond this magnitude are masked atoms
SCORE_QUANTILE = 0.9


def row_gaps(p: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Per row ``[S, k]``: max |p - r| / max |r| over unmasked entries."""
    real = np.abs(r) < MASKED
    diff = np.where(real, np.abs(p.astype(np.float64) - r), 0.0)
    scale = np.where(real, np.abs(r.astype(np.float64)), 0.0)
    return diff.max(axis=(-2, -1)) / np.maximum(scale.max(axis=(-2, -1)),
                                                1e-30)


def wrong_share(x: dict, truth: np.ndarray) -> float:
    """Share of the rows ``x`` reports converged whose indices are not
    ``truth``."""
    bad = x["converged"] & (x["indices"] != truth).any(-1)
    return float(bad.sum() / max(int(x["converged"].sum()), 1))


def factorization(prog: dict, ref: dict, truth: np.ndarray,
                  drawn: np.ndarray) -> tuple:
    """``(numbers, diagnostics)`` of sampled rows.  ``prog`` and ``ref`` hold
    outcomes ``[S, k, ...]`` (``indices``, ``iterations``, ``converged``,
    ``scores``), ``truth [S, k, F]`` the indices bound into each query,
    ``drawn [S]`` which requests were drawn from the seed."""
    same_idx = (prog["indices"] == ref["indices"]).all(-1)  # [S, k]
    same_path = ((prog["converged"] == ref["converged"])
                 & (prog["iterations"] == ref["iterations"]))
    gaps = np.where(same_idx, row_gaps(prog["scores"], ref["scores"]), 1.0)
    compared = gaps[same_path & ref["converged"]]
    conv = [float(x["converged"][drawn].mean()) for x in (prog, ref)]
    its = [float(x["iterations"][drawn].mean()) for x in (prog, ref)]
    wrong = [wrong_share(x, truth) for x in (prog, ref)]
    out = {"wrong_decode_excess": wrong[0] - wrong[1],
           "score_gap": (float(np.quantile(compared, SCORE_QUANTILE))
                         if compared.size else 1.0),
           "converged_gap": abs(conv[0] - conv[1]),
           "iterations_gap": abs(its[0] - its[1]) / max(its[1], 1e-30)}
    q = (np.quantile(compared, [0.5, 0.95, 0.99]) if compared.size
         else [1.0] * 3)
    diag = {"rows": int(same_idx.size),
            "rows_differ": float(1.0 - (same_idx & same_path).mean()),
            "rows_compared": int(compared.size),
            "score_gap_p50": float(q[0]), "score_gap_p95": float(q[1]),
            "score_gap_p99": float(q[2]),
            "score_gap_max": float(compared.max(initial=0.0)),
            "wrong_decode_share": wrong[0], "ref_wrong_decode_share": wrong[1],
            "drawn_rows": int(prog["converged"][drawn].size),
            "converged": conv[0], "ref_converged": conv[1],
            "mean_iterations": its[0], "ref_mean_iterations": its[1]}
    return out, diag


def checks(values: dict, limits: dict) -> dict:
    """``{name: {"value", "limit"}}`` of every number that has a limit."""
    return {k: {"value": v, "limit": limits[k]} for k, v in values.items()
            if limits.get(k) is not None}


def passed(chk: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in chk.values())
