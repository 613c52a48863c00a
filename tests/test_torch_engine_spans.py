"""The spans the port's ``Engine`` records inside a step: ``slot-scan`` in
its fill, ``rng`` / ``factor-update`` / ``settle`` / ``restart`` inside each
sweep of a burst, ``decode`` and ``finalize`` in its retire, and
``postprocess`` inside ``finalize``.  Each nests where it should and counts
what it should, and with a live ``Recorder`` against the ``NULL`` default
the engine dispatches the same aten operations in the same order and
returns bit-equal results.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import engine as P
from repro_torch import obs
from repro_torch.core import factorizer as fz
from repro_torch.core import rng
from repro_torch.core import vsa


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _AtenLog(TorchDispatchMode):
    """Every aten operation dispatched inside the mode, by name, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _int8_spec(synchronous: bool = False):
    """Tab. VII's stochastic unitary int8 resonator at a small width, with
    restarts every 3 sweeps: noisy queries, 9 of them, restart often."""
    cfg = fz.FactorizerConfig(
        vsa=vsa.VSAConfig(256, 4), num_factors=3, codebook_size=10,
        algebra="unitary", activation="abs", noise_std=0.3, restart_every=3,
        max_iters=24, conv_threshold=0.8, codebook_fmt="int8",
        synchronous=synchronous)
    dense = fz.make_codebooks(3, cfg, device="cpu")
    gen = np.random.default_rng(5)
    qs = fz.bind_combo(dense, torch.from_numpy(gen.integers(0, 10, (9, 3))),
                       cfg.vsa)
    qs = qs + 0.7 * qs.std() * torch.from_numpy(
        gen.standard_normal(tuple(qs.shape)).astype(np.float32))
    spec = P.ServeSpec("int8_rows", codebooks=fz.quantize_codebooks(
        dense, "int8"), cfg=cfg)
    return spec, [(q[None], None) for q in qs], fz.draw_keys(9, 9)[:, None]


def _nvsa_spec():
    """NVSA abduction at ``NVSAConfig()``: 3 tasks of 8 noisy context
    queries, 8 candidates each in ``meta``."""
    spec = P.registry.build("nvsa_abduction", 0, device="cpu")
    gen = np.random.default_rng(6)
    sizes = spec.valid_mask.sum(1).tolist()
    attrs = np.stack([gen.integers(0, n, (3, 16)) for n in sizes], -1)
    qs = fz.bind_combo(spec.codebooks, torch.from_numpy(attrs), spec.cfg.vsa)
    qs = qs + 0.3 * qs.std() * torch.from_numpy(
        gen.standard_normal(tuple(qs.shape)).astype(np.float32))
    tasks = [(qs[t, :8], {"cand": qs[t, 8:]}) for t in range(3)]
    return spec, tasks, fz.draw_keys(7, 24).reshape(3, 8, 2)


SPECS = {"int8_gauss_seidel": _int8_spec,
         "int8_jacobi": lambda: _int8_spec(synchronous=True),
         "nvsa": _nvsa_spec}


def _serve(spec, requests, keys, rec=None, slots=4, sweeps=2):
    eng = P.Engine(spec, slots=slots, sweeps_per_step=sweeps, obs=rec,
                   device="cpu")
    for (q, meta), k in zip(requests, keys):
        eng.submit(q, keys=k, meta=meta)
    return eng, eng.drain()


def _children(spans, parent, name):
    return [s for s in spans if s.parent == parent.sid and s.name == name]


@pytest.mark.parametrize("kind", sorted(SPECS))
def test_step_spans_nest_and_count(kind):
    spec, requests, keys = SPECS[kind]()
    rec = obs.Recorder()
    _, done = _serve(spec, requests, keys, rec)
    assert len(done) == len(requests)
    spans = rec.spans.snapshot()
    assert obs.validate(spans) == []
    F = spec.cfg.num_factors
    bursts = [s for s in spans if s.name == "sweep-burst"]
    assert bursts and sum(b.args["sweeps"] for b in bursts) > 0
    for b in bursts:
        n = b.args["sweeps"]
        assert len(_children(spans, b, "rng")) == n
        assert len(_children(spans, b, "settle")) == n
        updates = _children(spans, b, "factor-update")
        assert len(updates) == n * F
        assert [u.args["factor"] for u in updates] == list(range(F)) * n
    by_id = {s.sid: s for s in spans}
    restarts = [s for s in spans if s.name == "restart"]
    assert all(by_id[s.parent].name == "settle" for s in restarts)
    assert all(s.args["rows"] > 0 and "fft_plans" not in s.args
               for s in restarts)
    if kind != "nvsa":  # NVSA's rows settle before a restart is due
        assert restarts
    scans = [s for s in spans if s.name == "slot-scan"]
    assert all(by_id[s.parent].name == "step" for s in scans)
    rows = sum(q.shape[0] for q, _ in requests)
    assert sum(s.args["rows"] for s in scans) == rows
    assert scans[0].args["queued"] == rows
    for s in scans:  # each scan closes before its fill opens
        fills = _children(spans, by_id[s.parent], "fill")
        assert all(f.t0 >= s.t1 for f in fills)
    decodes = [s for s in spans if s.name == "decode"]
    finals = [s for s in spans if s.name == "finalize"]
    assert decodes and all(by_id[s.parent].name == "retire" for s in decodes)
    assert [by_id[s.parent] for s in finals] == [by_id[s.parent]
                                                 for s in decodes]
    assert all(f.t0 >= d.t1 for d, f in zip(decodes, finals))
    post = [s for s in spans if s.name == "postprocess"]
    assert len(post) == (len(done) if kind == "nvsa" else 0)
    assert all(by_id[s.parent].name == "finalize" for s in post)


def _count_dispatches(eng) -> dict:
    """Wrap the engine's three device programs with call counters."""
    counts = {"sweeps": 0, "refill": 0, "decode": 0}

    def w(tag, fn):
        def wrapped(*a, **k):
            counts[tag] += 1
            return fn(*a, **k)
        return wrapped

    eng._sweeps = w("sweeps", eng._sweeps)
    eng._refill_many = w("refill", eng._refill_many)
    eng._decode = w("decode", eng._decode)
    return counts


@pytest.mark.parametrize("kind", sorted(SPECS))
def test_tracing_is_zero_overhead_bit_equal_restarting(kind):
    """The zero-overhead contract of ``tests/test_torch_obs.py`` on specs
    that draw noise and restart rows: with a live Recorder against the NULL
    default the same device-program calls, the same aten operations in the
    same order, and bit-equal results."""
    spec, requests, keys = SPECS[kind]()
    runs = []
    for rec in (obs.Recorder(), None):
        eng = P.Engine(spec, slots=4, sweeps_per_step=2, obs=rec,
                       device="cpu")
        counts = _count_dispatches(eng)
        with _AtenLog() as log:
            for (q, meta), k in zip(requests, keys):
                eng.submit(q, keys=k, meta=meta)
            done = eng.drain()
        runs.append((counts, log.ops, done))
    (c_on, ops_on, on), (c_off, ops_off, off) = runs
    assert c_on == c_off and c_on["sweeps"] > 0
    assert ops_on == ops_off
    assert len(on) == len(off) == len(requests)
    for a, b in zip(on, off):
        for x, y in zip(a.factorization, b.factorization):
            np.testing.assert_array_equal(x, y)
        if kind == "nvsa":
            assert a.result["answer"] == b.result["answer"]
            np.testing.assert_array_equal(a.result["sims"], b.result["sims"])


def test_sweep_spans_follow_the_recorder_through_bind_resize_recover():
    """The resonator's span factory reads the engine's recorder when the
    sweep runs: a recorder bound after construction, and the programs
    rebuilt by ``resize`` and ``recover``, keep recording sweep spans on the
    engine's track."""
    spec, requests, keys = _int8_spec()
    eng = P.Engine(spec, slots=4, sweeps_per_step=1, device="cpu")
    for (q, meta), k in zip(requests, keys):
        eng.submit(q, keys=k, meta=meta)
    eng.step()
    rec = obs.Recorder()
    eng.bind_obs(rec, track="bound")
    eng.step()
    eng.resize(6)
    eng.step()
    eng.recover()
    eng.step()
    spans = rec.spans.snapshot()
    assert obs.validate(spans) == []
    rngs = [s for s in spans if s.name == "rng"]
    assert len(rngs) == eng.steps_total - 1 == 3
    assert {s.track for s in spans} == {"bound"}


def test_one_sweeps_draws_dispatch_a_fixed_number_of_operations():
    """A sweep's ``rng`` span holds the same aten operations whatever the
    number of rows, so its kernels a sweep on the card are one integer in
    every run and at every slot count."""
    counts = []
    for n in (4, 64):
        keys = fz.draw_keys(1, n)
        sweep = torch.zeros(n, dtype=torch.int32)
        with _AtenLog() as log:
            rng.normal(keys, sweep, rng.SCORES, 4, 10)
        counts.append(log.ops)
    assert counts[0] == counts[1] and len(counts[0]) > 100
