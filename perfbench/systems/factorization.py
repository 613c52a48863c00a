"""Factorization serving: one query hypervector a request, decoded into one
atom index per factor by the port's ``Engine`` over a ``ServeSpec`` of the
configuration's factorizer.

Inputs from the seed: unitary block-code atoms ``[F, M, D]`` drawn on the
device, and a pool of ``traffic["pool"]`` queries, each the binding of one
random atom per factor plus ``query_noise`` x the pool's standard deviation
of Gaussian noise (as the paper's accuracy tables send them); request i asks
for query ``i mod pool``.  Served in
the configuration's ``codebook_fmt``: int8 books are the port's own
quantisation of the atoms, which the reference works out again.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.bench import counts, inputs, judge
from perfbench.reference import quant
from perfbench.reference.factorizer import Factorizer

REF_BLOCK = 16384  # rows the reference sweeps at once


def factorizer_config(c: dict):
    """The port's ``FactorizerConfig`` of configuration ``c``."""
    from repro_torch.core import factorizer as fz
    from repro_torch.core import vsa

    return fz.FactorizerConfig(
        vsa=vsa.VSAConfig(c["dim"], c["blocks"]), num_factors=c["num_factors"],
        codebook_size=c["codebook_size"], algebra=c["algebra"],
        max_iters=c["max_iters"], noise_std=c["noise_std"],
        proj_noise_std=c["proj_noise_std"], activation=c["activation"],
        conv_threshold=c["conv_threshold"], codebook_fmt=c["codebook_fmt"],
        synchronous=c["synchronous"], restart_every=c["restart_every"])


def reference_rows(atoms, mask, cfg: dict, q, keys, fmt: str) -> dict:
    """The reference's outcome of query rows ``q [R, D]`` with keys
    ``[R, 2]``, atoms served in ``fmt`` (``int8``, ``int4``, ``fp32`` or
    ``tf32``), in blocks of rows."""
    fac = Factorizer(quant.dequantized(atoms, fmt), mask, cfg,
                     "tf32" if fmt == "tf32" else "fp32")
    parts = [fac.run(q[s:s + REF_BLOCK], keys[s:s + REF_BLOCK])
             for s in range(0, q.shape[0], REF_BLOCK)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


class System:
    rows = 1  # query rows a request

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.seed, self.device = config, seed, device
        F, M = config["num_factors"], config["codebook_size"]
        D, B = config["dim"], config["blocks"]
        gen = inputs.device_generator(seed, 1, device)
        self.atoms = inputs.unitary_atoms(gen, (F, M), D, B, device)
        self.mask = torch.ones((F, M), dtype=torch.bool, device=device)
        self.pool = int(traffic["pool"])
        idx = torch.randint(0, M, (self.pool, F), generator=gen, device=device)
        self.bound = idx.cpu().numpy()
        q = inputs.bind_indices(self.atoms, idx, B)
        z = torch.randn(q.shape, generator=gen, device=device)
        self.queries = q + config["query_noise"] * q.std() * z
        self.requests = self.queries[:, None].unbind(0)  # [1, D] views
        self.row_flops = counts.row_sweep_flops(F, M, D)

    def fields(self) -> dict:
        F, M = self.config["num_factors"], self.config["codebook_size"]
        k = self.rows
        return {"keys": ((k, 2), np.int64), "indices": ((k, F), np.int32),
                "iterations": ((k,), np.int32), "converged": ((k,), np.bool_),
                "scores": ((k, F, M), np.float32)}

    def spec(self, tail=None):
        """The port's ``ServeSpec`` (``tail`` is unused: no postprocess)."""
        from repro_torch import engine
        from repro_torch.core import factorizer as fz

        cfg = factorizer_config(self.config)
        books = (fz.quantize_codebooks(self.atoms, cfg.codebook_fmt)
                 if cfg.codebook_fmt != "fp32" else self.atoms)
        return engine.ServeSpec(self.config["serve_name"], codebooks=books,
                                cfg=cfg)

    def request(self, i: int):
        """``(queries [k, D], meta)`` of request ``i``."""
        return self.requests[i % self.pool], None

    def outcome(self, f, result) -> dict:
        """The program's outcome of a request from its ``factorization``."""
        return {"indices": f.indices, "iterations": f.iterations,
                "converged": f.converged, "scores": f.scores}

    def _rows(self, sample: dict):
        idx = torch.as_tensor(sample["i"] % self.pool, device=self.device)
        q = self.queries[idx].reshape(-1, self.config["dim"])
        return q, torch.as_tensor(sample["keys"].reshape(-1, 2),
                                  device=self.device)

    def reference(self, sample: dict, fmt: str | None = None,
                  overrides: dict | None = None) -> dict:
        """The reference's own outcomes of the sampled requests (their ``i``
        and ``keys``), served in ``fmt`` (default: the configuration's
        ``codebook_fmt``) under the configuration with ``overrides`` (a
        planted fault), shaped as the program's."""
        q, keys = self._rows(sample)
        out = reference_rows(self.atoms, self.mask,
                             {**self.config, **(overrides or {})}, q, keys,
                             fmt or self.config["codebook_fmt"])
        S = len(sample["i"])
        return {k: v.reshape(S, self.rows, *v.shape[1:]) for k, v in out.items()}

    def compare(self, prog: dict, drawn) -> tuple:
        """``(numbers, diagnostics)``: the sampled requests ``prog`` against
        the reference's own rows and the atoms bound into their queries."""
        truth = self.bound[prog["i"] % self.pool][:, None]
        return judge.factorization(prog, self.reference(prog), truth, drawn)
