"""NVSA abduction served through the port's ``Engine``
(``registry.build("nvsa_abduction", ...)``): one RPM task equals the port's
``solve`` bit for bit, ``fused_step`` is a no-op on the unitary default, and
a bipolar fused spec dispatches the masked sweep once per sweep and serves
the reference ``Engine``'s answers bitwise."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import engine as R
from repro.core import vsa as rv
from repro.models import nvsa as rn
from repro_torch import convert
from repro_torch import engine as P
from repro_torch.core import factorizer as fz
from repro_torch.core import vsa as tv
from repro_torch.kernels.resonator_step import ops as rs_ops
from repro_torch.models import cnn, nvsa


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bipolar(cfg):
    return dataclasses.replace(cfg, factorizer=dataclasses.replace(
        cfg.factorizer, noise_std=0.0, restart_every=0, synchronous=True))


def test_registry_builds_nvsa_and_defaults_to_cuda():
    assert "nvsa_abduction" in P.registry.available()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            P.registry.build("nvsa_abduction", 0)
    spec = P.registry.build("nvsa_abduction", 0, device="cpu")
    assert spec.codebooks.shape == (3, nvsa.MAX_M, 1024)
    assert spec.valid_mask.sum(1).tolist() == list(nvsa.ATTR_SIZES)
    assert spec.graph is not None and not spec.graph.runnable


def test_engine_request_answers_bit_equal_solve():
    """One RPM task through Engine.submit/drain == nvsa.solve: answer and
    per-query iterations bit for bit, sims at rtol 1e-5, with fewer slots
    than queries (tests/test_engine.py:135-156)."""
    cfg = nvsa.NVSAConfig()
    model = cnn.init(cfg.cnn, 1, device="cpu")
    spec = P.registry.build("nvsa_abduction", 0, cfg=cfg, params=model,
                            batch=1, device="cpu")
    assert spec.graph.runnable
    gen = torch.Generator().manual_seed(2)
    batch = {"images": torch.rand((1, 9, 32, 32), generator=gen),
             "candidate_images": torch.rand((1, 8, 32, 32), generator=gen)}
    want = nvsa.solve(model, batch, spec.codebooks, spec.valid_mask, 11, cfg)
    ctx = nvsa.perceive(model, batch["images"][:, :8], cfg, spec.codebooks)[0]
    cand = nvsa.perceive(model, batch["candidate_images"], cfg,
                         spec.codebooks)[0]
    keys = fz.draw_keys(11, 8)  # solve's per-query keys
    eng = P.Engine(spec, slots=3, device="cpu")
    eng.submit(ctx, keys=keys, meta={"cand": cand})
    (req,) = eng.drain()
    assert req.result["answer"] == int(want["answer"][0])
    np.testing.assert_array_equal(req.iterations, want["fact_iters"][0].numpy())
    # sims: the engine's tail runs at B = 1, solve's at the task batch
    np.testing.assert_allclose(req.result["sims"], want["sims"][0].numpy(),
                               rtol=1e-5)


def test_nvsa_fused_flag_is_a_noop_for_unitary():
    """tests/test_engine.py:360-380: the default config is unitary and
    stochastic, so the fused flag changes nothing."""
    spec_f = P.registry.build("nvsa_abduction", 0, fused_step=True,
                              device="cpu")
    spec_p = P.registry.build("nvsa_abduction", 0, device="cpu")
    assert spec_f.cfg.fused_step and not spec_p.cfg.fused_step
    assert not fz.fused_sweep_eligible(spec_f.cfg)
    attrs = np.random.default_rng(0).integers(0, (5, 6, 10), (2, 3))
    qs = fz.bind_combo(spec_f.codebooks, torch.from_numpy(attrs),
                       spec_f.cfg.vsa)
    keys = fz.draw_keys(3, 2)
    got = []
    for spec in (spec_f, spec_p):
        eng = P.Engine(spec, slots=2, sweeps_per_step=4, device="cpu")
        assert eng.kernel_launches_per_sweep == 0
        ids = [eng.submit(qs[i], keys=keys[i][None]) for i in range(2)]
        done = {r.id: r for r in eng.drain()}
        got.append([done[i].factorization for i in ids])
        np.testing.assert_array_equal(
            np.stack([done[i].factorization.indices[0] for i in ids]), attrs)
    for a, b in zip(*got):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_bipolar_fused_spec_dispatches_the_masked_sweep_once_a_sweep(
        monkeypatch):
    """On the CPU the masked sweep's dispatch goes to its plain version (no
    launch is counted); a counting wrapper around the ops entry point shows
    one dispatch per sweep."""
    cfg = _bipolar(nvsa.NVSAConfig(vsa=tv.VSAConfig(1024, 1024)))
    spec = P.registry.build("nvsa_abduction", 0, cfg=cfg, fused_step=True,
                            device="cpu")
    assert fz.fused_sweep_eligible(spec.cfg)
    calls = []
    real = rs_ops.fused_resonator_step_batch_masked
    monkeypatch.setattr(rs_ops, "fused_resonator_step_batch_masked",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(1)
    attrs = np.stack([rng.integers(0, n, 24) for n in nvsa.ATTR_SIZES], -1)
    qs = nvsa.target_query(spec.codebooks, torch.from_numpy(attrs), cfg)
    eng = P.Engine(spec, slots=16, sweeps_per_step=3, device="cpu")
    assert eng.kernel_launches_per_sweep == 1
    before = rs_ops.masked_launches
    for i in range(3):
        eng.submit(qs[8 * i:8 * i + 8])
    done = eng.drain()
    assert len(calls) == eng.sweeps_total > 0
    assert rs_ops.masked_launches == before  # CPU tensors launch nothing
    got = np.concatenate([r.factorization.indices for r in done])
    np.testing.assert_array_equal(got, attrs)


def test_bipolar_fused_engine_bit_equals_the_reference_engine():
    """Same converted codebooks and +-1 target queries: per-request indices,
    iterations, converged, scores bitwise and equal answers."""
    cfg_r = _bipolar(rn.NVSAConfig(vsa=rv.VSAConfig(1024, 1024)))
    cfg_t = _bipolar(nvsa.NVSAConfig(vsa=tv.VSAConfig(1024, 1024)))
    spec_r = R.registry.build("nvsa_abduction", jax.random.PRNGKey(0),
                              cfg=cfg_r, fused_step=True)
    cbs, mask = convert.spec_arrays_from_reference(
        np.asarray(spec_r.codebooks), np.asarray(spec_r.valid_mask),
        device="cpu")
    spec_t = P.registry.build("nvsa_abduction", 0, cfg=cfg_t, fused_step=True,
                              codebooks=cbs, mask=mask, device="cpu")
    rng = np.random.default_rng(2)
    tasks = 3
    attrs = np.stack([rng.integers(0, n, (tasks, 16)) for n in nvsa.ATTR_SIZES],
                     -1)
    qs = nvsa.target_query(cbs, torch.from_numpy(attrs), cfg_t).numpy()
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(5), tasks * 8))
    out = []
    for E, spec in ((R, spec_r), (P, spec_t)):
        kw = {} if E is R else {"device": "cpu"}
        eng = E.Engine(spec, slots=8, sweeps_per_step=2, **kw)
        ids = [eng.submit(qs[t, :8], keys=keys[8 * t:8 * t + 8],
                          meta={"cand": qs[t, 8:]}) for t in range(tasks)]
        done = {r.id: r for r in eng.drain()}
        out.append([done[i] for i in ids])
    for a, b in zip(*out):
        for f in ("indices", "iterations", "converged", "scores"):
            np.testing.assert_array_equal(np.asarray(getattr(b.factorization, f)),
                                          np.asarray(getattr(a.factorization, f)),
                                          err_msg=f)
        assert b.result["answer"] == a.result["answer"]
        np.testing.assert_allclose(b.result["sims"], np.asarray(a.result["sims"]),
                                   rtol=1e-5, atol=1e-6)
