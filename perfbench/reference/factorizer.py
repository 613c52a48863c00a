"""The stochastic resonator factorizer (CogSys Sec. IV-A/B), plain PyTorch.

For unitary block codes: each sweep visits the F factors in turn
(Gauss-Seidel; Jacobi where ``synchronous``), and for factor i

1. unbinds the other factors' estimates from the query (Fourier domain),
2. scores the unbound vector against factor i's M atoms, masked rows at
   -1e9, plus ``noise_std`` x the scores' spread x a standard normal,
3. applies the activation and projects back onto the atoms (plus
   ``proj_noise_std`` noise), and re-normalises each block's spectrum.

A row is active until it converges (the bound argmax atoms reconstruct the
query with cosine >= ``conv_threshold``) or has run ``max_iters`` sweeps;
an inactive row keeps its estimate, similarity and sweep count.  A row still
active and unconverged every ``restart_every`` sweeps restarts from normals
of its own.  All noise is drawn by :func:`.philox.normal` at the row's own
sweep index, so a row's trajectory does not depend on the rows beside it.
"""
from __future__ import annotations

import torch

from perfbench.reference import philox, quant, vsa

NEG = -1e9


class Factorizer:
    """Sweeps over dense float32 atoms ``[F, M, D]`` with a mask ``[F, M]``;
    matrix products in float32, or TF32 where ``fmt == "tf32"``."""

    def __init__(self, atoms: torch.Tensor, mask: torch.Tensor, cfg: dict,
                 fmt: str = "fp32"):
        if cfg["algebra"] != "unitary":
            raise ValueError("the reference covers the unitary algebra only")
        self.cfg = cfg
        self.atoms = atoms.float()
        # Operands of matrix products: as they are, or rounded to TF32.
        self.rnd = quant.tf32 if fmt == "tf32" else (lambda x: x)
        self.mm_atoms = self.rnd(self.atoms)
        self.mask = mask.to(device=atoms.device, dtype=torch.bool)
        self.b = cfg["blocks"]
        self.fids = torch.arange(atoms.shape[0], device=atoms.device)
        init = torch.einsum("fm,fmd->fd", self.mask.float(), self.mm_atoms)
        self.init = vsa.normalize_unitary(init, self.b)

    def _activation(self, a: torch.Tensor) -> torch.Tensor:
        kind = self.cfg["activation"]
        if kind == "abs":
            return torch.abs(a)
        if kind == "identity":
            return a
        if kind == "relu":
            return torch.relu(a)
        raise ValueError(f"activation {kind!r} is not in the reference")

    def _unbind(self, q, est, i=None):
        b = self.b
        q_spec = torch.fft.rfft(vsa.blocks(q.float(), b), dim=-1)
        est_spec = torch.fft.rfft(vsa.blocks(est.float(), b), dim=-1)
        prod = torch.prod(est_spec, dim=-3)
        if i is None:
            out = (q_spec[..., None, :, :] * torch.conj(prod)[..., None, :, :]
                   * est_spec)
        else:
            out = q_spec * torch.conj(prod) * est_spec[..., i, :, :]
        return vsa.flat(torch.fft.irfft(out, n=q.shape[-1] // b, dim=-1))

    def _update(self, q, est, i, z_sim, z_proj):
        cfg, mk = self.cfg, self.mask[i]
        a = self.rnd(self._unbind(q, est, i)) @ self.mm_atoms[i].T
        a = torch.where(mk, a, torch.tensor(NEG, device=a.device))
        if z_sim is not None:
            sigma = cfg["noise_std"] * torch.std(torch.where(mk, a, 0.0), dim=-1,
                                                 keepdim=True, correction=0)
            a = torch.where(mk, a + sigma * z_sim, a)
        new = self.rnd(self._activation(a) * mk) @ self.mm_atoms[i]
        if z_proj is not None:
            sigma = cfg["proj_noise_std"] * torch.std(new, dim=-1, keepdim=True,
                                                      correction=0)
            new = new + sigma * z_proj
        return a, vsa.normalize_unitary(new, self.b)

    def run(self, q: torch.Tensor, keys: torch.Tensor) -> dict:
        """Factorize queries ``[N, D]`` with keys int64 ``[N, 2]`` until every
        row is inactive; returns numpy ``indices [N, F]``, ``iterations``,
        ``converged``, ``scores [N, F, M]``."""
        cfg = self.cfg
        N = q.shape[0]
        F, M, D = self.atoms.shape
        dev = q.device
        est = self.init.expand(N, F, D).clone()
        iters = torch.zeros(N, dtype=torch.int32, device=dev)
        done = torch.zeros(N, dtype=torch.bool, device=dev)
        sim = torch.full((N,), -1.0, device=dev)
        keys = keys.to(device=dev, dtype=torch.int64)
        while bool((~done & (iters < cfg["max_iters"])).any()):
            z_sim = (philox.normal(keys, iters, philox.SCORES, F, M).unbind(1)
                     if cfg["noise_std"] else [None] * F)
            z_proj = (philox.normal(keys, iters, philox.PROJECTION, F, D)
                      .unbind(1) if cfg["proj_noise_std"] else [None] * F)
            if cfg["synchronous"]:
                outs = [self._update(q, est, i, z_sim[i], z_proj[i])
                        for i in range(F)]
                alpha = torch.stack([o[0] for o in outs], dim=1)
                new = torch.stack([o[1] for o in outs], dim=1)
            else:
                new = est.clone()
                alphas = []
                for i in range(F):
                    a_i, new[:, i] = self._update(q, new, i, z_sim[i],
                                                  z_proj[i])
                    alphas.append(a_i)
                alpha = torch.stack(alphas, dim=1)
            idx = torch.argmax(alpha, dim=-1)
            s = vsa.similarity(vsa.bind_all(self.atoms[self.fids, idx], self.b), q)
            act = ~done & (iters < cfg["max_iters"])
            est = torch.where(act[:, None, None], new, est)
            sim = torch.where(act, s, sim)
            iters = iters + act.to(torch.int32)
            done = done | (sim >= cfg["conv_threshold"])
            if cfg["restart_every"] > 0:
                rows = torch.nonzero(act & ~done
                                     & (iters % cfg["restart_every"] == 0)
                                     ).squeeze(1)
                if rows.numel():
                    z = philox.normal(keys[rows], iters[rows], philox.RESTART,
                                      F, D)
                    est[rows] = vsa.normalize_unitary(z, self.b)
        alpha = torch.einsum("nfd,fmd->nfm", self.rnd(self._unbind(q, est)),
                             self.mm_atoms)
        alpha = torch.where(self.mask[None], alpha,
                            torch.tensor(NEG, device=dev))
        idx = torch.argmax(alpha, dim=-1)
        return {"indices": idx.to(torch.int32).cpu().numpy(),
                "iterations": iters.cpu().numpy(),
                "converged": done.cpu().numpy(),
                "scores": alpha.cpu().numpy()}
