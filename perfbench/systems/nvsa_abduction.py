"""NVSA abduction on RAVEN: a request is one task, the 8 context panels'
query hypervectors with the 8 candidates' in ``meta``, served by the port's
``nvsa_abduction`` pipeline (factorization, then the abduction tail in its
postprocess).

Inputs from the seed: unitary atoms ``[F, M, D]`` (M padded, attribute
sizes in ``attr_sizes``) drawn on the device, and ``traffic["pool"]`` RAVEN
tasks whose panels are the bound target queries plus ``query_noise`` x the
queries' standard deviation of Gaussian noise (oracle perception, as a
trained frontend's queries look); request i is task ``i mod pool``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.bench import counts, inputs, judge
from perfbench.reference import nvsa as ref_nvsa
from perfbench.systems.factorization import factorizer_config, reference_rows


class System:
    rows = 8  # context panels a task

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.seed, self.device = config, seed, device
        F, M = config["num_factors"], config["codebook_size"]
        D, B = config["dim"], config["blocks"]
        self.sizes = tuple(config["attr_sizes"])
        gen = inputs.device_generator(seed, 2, device)
        self.atoms = inputs.unitary_atoms(gen, (F, M), D, B, device)
        self.mask = torch.stack([torch.arange(M, device=device) < n
                                 for n in self.sizes])
        self.pool = int(traffic["pool"])
        ctx, cand, self.truth = inputs.raven_tasks(seed, self.pool)
        self.bound = ctx  # [pool, 8, F]: the atoms bound into each panel
        noise = config["query_noise"]
        out = []
        for a in (ctx, cand):
            q = inputs.bind_indices(self.atoms, torch.as_tensor(a, device=device),
                                    B)
            z = torch.randn(q.shape, generator=gen, device=device)
            out.append(q + noise * q.std() * z)
        self.ctx, self.cand = out  # [pool, 8, D] each
        self.requests = list(zip(self.ctx.unbind(0), self.cand.unbind(0)))
        self.row_flops = counts.row_sweep_flops(F, M, D)

    def fields(self) -> dict:
        F, M = self.config["num_factors"], self.config["codebook_size"]
        k = self.rows
        return {"keys": ((k, 2), np.int64), "indices": ((k, F), np.int32),
                "iterations": ((k,), np.int32), "converged": ((k,), np.bool_),
                "scores": ((k, F, M), np.float32), "answer": ((), np.int64),
                "sims": ((8,), np.float32)}

    def nvsa_config(self):
        from repro_torch.core import vsa
        from repro_torch.models import cnn, nvsa

        c = self.config
        v = vsa.VSAConfig(c["dim"], c["blocks"])
        return nvsa.NVSAConfig(
            vsa=v, cnn=cnn.CNNConfig(vsa_dim=c["dim"], attr_sizes=self.sizes),
            factorizer=factorizer_config(c), belief_temp=c["belief_temp"])

    def spec(self, tail=None):
        """The port's ``nvsa_abduction`` ServeSpec over this run's atoms;
        ``tail`` (a context-manager factory) wraps its postprocess."""
        from repro_torch.engine import registry

        spec = registry.build("nvsa_abduction", inputs.stream_seed(self.seed, 3),
                              cfg=self.nvsa_config(), codebooks=self.atoms,
                              mask=self.mask, device=self.device)
        if tail is None:
            return spec
        post = spec.postprocess

        def timed(queries, res, meta):
            with tail():
                return post(queries, res, meta)

        return dataclasses.replace(spec, postprocess=timed)

    def request(self, i: int):
        ctx, cand = self.requests[i % self.pool]
        return ctx, {"cand": cand}

    def outcome(self, f, r) -> dict:
        """The program's outcome of a task from its ``factorization`` and
        the postprocess's ``result``."""
        return {"indices": f.indices, "iterations": f.iterations,
                "converged": f.converged, "scores": f.scores,
                "answer": r["answer"], "sims": r["sims"]}

    def _tail(self, t, q, scores, fmt: str) -> tuple:
        """The reference's abduction tail over scores ``[S * 8, F, M]``."""
        S = t.shape[0]
        bel = ref_nvsa.beliefs(q, scores, self.mask, self.config["belief_temp"])
        answer, sims = ref_nvsa.answers(
            bel.reshape(S, 8, len(self.sizes), -1), self.cand[t], self.atoms,
            self.sizes, self.config["blocks"], fmt)
        return answer.cpu().numpy(), sims.cpu().numpy()

    def _rows(self, sample: dict):
        t = torch.as_tensor(sample["i"] % self.pool, device=self.device)
        return t, self.ctx[t].reshape(t.shape[0] * 8, -1), torch.as_tensor(
            sample["keys"].reshape(-1, 2), device=self.device)

    def reference(self, sample: dict, fmt: str | None = None,
                  overrides: dict | None = None) -> dict:
        """The reference's own outcomes of the sampled tasks, computed in
        ``fmt`` under the configuration with ``overrides`` (a planted
        fault): the factorization of their context rows, then beliefs,
        abduction and ranking over its own scores."""
        fmt = fmt or self.config["codebook_fmt"]
        t, q, keys = self._rows(sample)
        rows = reference_rows(self.atoms, self.mask,
                              {**self.config, **(overrides or {})}, q, keys,
                              fmt)
        S = t.shape[0]
        answer, sims = self._tail(t, q, torch.as_tensor(rows["scores"],
                                                        device=self.device), fmt)
        out = {k: v.reshape(S, 8, *v.shape[1:]) for k, v in rows.items()}
        out.update(answer=answer, sims=sims)
        return out

    def compare(self, prog: dict, drawn) -> tuple:
        """``(numbers, diagnostics)``: the sampled tasks' rows against the
        reference's own and the atoms bound into their panels, and
        ``tail_gap``: the reference's tail run on the program's own scores;
        over the tasks the widest gap between candidate cosines, or 1 where
        the answer differs from the program's."""
        out, diag = judge.factorization(prog, self.reference(prog),
                                        self.bound[prog["i"] % self.pool],
                                        drawn)
        t, q, _ = self._rows(prog)
        S = t.shape[0]
        scores = torch.as_tensor(
            prog["scores"].reshape(S * 8, *prog["scores"].shape[2:]),
            device=self.device)
        answer, sims = self._tail(t, q, scores, "fp32")
        gap = np.abs(prog["sims"].astype(np.float64) - sims).max(-1)
        task = np.where(prog["answer"] == answer, gap, 1.0)
        out["tail_gap"] = float(task.max(initial=0.0))
        diag.update(tasks=int(task.size),
                    answers_differ=int((prog["answer"] != answer).sum()))
        return out, diag
