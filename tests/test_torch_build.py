"""``repro_torch.engine.build`` (adSCH-planned pipeline) against the
reference's ``repro.engine.build``: ports of ``tests/test_engine.py``'s
``build_pipeline`` cases on its toy graph, plans equal to the reference's, and NVSA's
pipelined stream equal to per-batch ``solve`` calls."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.scheduler import Op as ROp
from repro.engine import build as rb
from repro.engine.stage import Stage as RStage, StageGraph as RStageGraph
from repro_torch import engine
from repro_torch.core.scheduler import Op
from repro_torch.engine import build as tb
from repro_torch.engine.stage import Stage, StageGraph
from repro_torch.models import cnn, nvsa


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy_graph(sym_dims=(2048, 256), n_sym=8, ref=False, log=None):
    """tests/test_engine.py's 3-stage graph with closed-form fns; ``log``
    collects (stage, first element) per call."""
    O, S, G = (ROp, RStage, RStageGraph) if ref else (Op, Stage, StageGraph)

    def fn(name, f):
        def run(x, g):
            if log is not None:
                log.append((name, float(x.reshape(-1)[0])))
            return f(x)
        return run

    sym_ops, prev = [], ()
    for i in range(n_sym):  # a chain of sweeps, like the resonator loop
        op = O(f"c{i}", "circconv", sym_dims, deps=prev, symbolic=True)
        sym_ops.append(op)
        prev = (op.name,)
    return G("toy", (
        S("n1", fn("n1", lambda x: x * 2.0), symbolic=False,
          cost_ops=(O("g1", "gemm", (4096, 512, 512)),)),
        S("n2", fn("n2", lambda x: x + 1.0), symbolic=False,
          cost_ops=(O("g2", "gemm", (4096, 512, 512)),)),
        S("s1", fn("s1", lambda x: x * x), symbolic=True,
          cost_ops=tuple(sym_ops)),
    ))


def _per_batch(graph, xs, generator):
    gens = tb.batch_generators(generator, xs.shape[0])
    outs = []
    for t in range(xs.shape[0]):
        x = xs[t]
        for st in graph.stages:
            x = st.fn(x, gens[t])
        outs.append(x)
    return torch.stack(outs)


@pytest.mark.parametrize("lags", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_pipeline_matches_per_batch_chain_at_every_depth(lags):
    g = _toy_graph()
    plan = tb.PipelinePlan(lags, (1.0,) * len(lags), 0.0, 0.0)
    runner = tb.build_pipeline(g, plan=plan)
    assert runner.depth == 1 + sum(lags)
    assert sum(len(p) for p in runner.phase_names) == 3
    xs = np.random.default_rng(0).standard_normal((5, 4, 8)).astype(np.float32)
    got = runner(torch.from_numpy(xs), 1)
    torch.testing.assert_close(got, _per_batch(g, torch.from_numpy(xs), 1),
                               rtol=0, atol=0)
    want = rb.build_pipeline(_toy_graph(ref=True), plan=rb.PipelinePlan(
        lags, (1.0,) * len(lags), 0.0, 0.0))(jnp.asarray(xs),
                                             jax.random.PRNGKey(1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_short_stream_deeper_than_the_pipeline():
    g = _toy_graph()
    runner = tb.build_pipeline(g, plan=tb.PipelinePlan((1, 1), (1.0, 1.0),
                                                       0.0, 0.0))
    assert runner.depth == 3
    xs = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 4, 8)).astype(np.float32))
    torch.testing.assert_close(runner(xs, 1), _per_batch(g, xs, 1), rtol=0,
                               atol=0)


def test_phase_j_works_on_batch_s_minus_j():
    log = []
    g = _toy_graph(log=log)
    runner = tb.build_pipeline(g, plan=tb.PipelinePlan((1, 1), (1.0, 1.0),
                                                       0.0, 0.0))
    xs = torch.arange(3, dtype=torch.float32)[:, None].repeat(1, 2) + 10.0
    runner(xs, 0)
    # step s runs phase 0 on batch s, phase 1 on s-1, phase 2 on s-2
    batches = [0, 1, 0, 2, 1, 0, 2, 1, 2]
    assert [name for name, _ in log] == ["n1", "n1", "n2", "n1", "n2", "s1",
                                         "n2", "s1", "s1"]
    first = {0: 10.0, 1: 11.0, 2: 12.0}
    assert [v for n, v in log if n == "n1"] == [first[b] for b in (0, 1, 2)]
    assert len(batches) == len(log)


def test_plan_interleave_is_cost_driven_and_equals_the_reference():
    """The lag is an adSCH estimate, not a constant (tests/test_engine.py)."""
    cases = {"mid": ((2048, 256), 8), "tiny": ((64, 64), 1),
             "huge": ((8192, 512), 8)}
    plans = {}
    for name, (dims, n) in cases.items():
        plans[name] = tb.plan_interleave(_toy_graph(dims, n))
        want = rb.plan_interleave(_toy_graph(dims, n, ref=True))
        assert plans[name].lags == want.lags
        np.testing.assert_allclose(plans[name].gains, want.gains, rtol=1e-9)
    assert plans["mid"].lags[-1] == 1
    assert plans["tiny"].lags[-1] == 0
    assert plans["huge"].lags[-1] == 0
    assert tb.build_pipeline(_toy_graph((2048, 256), 8)).depth > \
        tb.build_pipeline(_toy_graph((8192, 512), 8)).depth


@pytest.mark.parametrize("shards,fused", [(None, True), (None, False),
                                          ((2, 2), None), ((1, 4), False)])
def test_fused_and_sharded_plans_follow_the_reference(shards, fused):
    """Fused pricing equals the reference's plan; sharded plans price the
    collectives on NVLink (the port's ``launch/mesh.py``) where the
    reference prices ICI, so there only the lag verdict is compared."""
    from repro.models import nvsa as rn
    g_t = nvsa.stage_graph(None, None, None, nvsa.NVSAConfig(), batch=8)
    g_r = rn.stage_graph(None, None, None, rn.NVSAConfig(), batch=8)
    p_t = tb.plan_interleave(g_t, shards=shards, fused=fused)
    p_r = rb.plan_interleave(g_r, shards=shards, fused=fused)
    assert p_t.lags == p_r.lags
    if shards is None:
        np.testing.assert_allclose(p_t.gains, p_r.gains, rtol=1e-9)


def test_batch_generators_are_seeded():
    a = [torch.randint(0, 9, (4,), generator=g) for g in tb.batch_generators(3, 3)]
    b = [torch.randint(0, 9, (4,), generator=g) for g in tb.batch_generators(3, 3)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])


# NVSA's stream -------------------------------------------------------------

@pytest.fixture(scope="module")
def nvsa_setup():
    cfg = nvsa.NVSAConfig()
    cbs, mask = nvsa.make_codebooks(0, cfg, device="cpu")
    return cfg, cbs, mask, cnn.init(cfg.cnn, 1, device="cpu")


def test_pipelined_stream_bit_equals_per_batch_solve(nvsa_setup):
    cfg, cbs, mask, model = nvsa_setup
    B, T = 2, 3
    runner = engine.build_pipeline(nvsa.stage_graph(model, cbs, mask, cfg,
                                                    batch=B))
    assert runner.depth == 2  # the scheduler-chosen one-batch lag
    gen = torch.Generator().manual_seed(2)
    imgs = torch.rand((T, B, 9, 32, 32), generator=gen)
    cands = torch.rand((T, B, 8, 32, 32), generator=gen)
    got = runner((imgs, cands), 7)
    gens = engine.batch_generators(7, T)
    want = torch.stack([nvsa.solve(model, {"images": imgs[t],
                                           "candidate_images": cands[t]},
                                   cbs, mask, gens[t], cfg)["answer"]
                        for t in range(T)])
    assert got.shape == (T, B)
    assert torch.equal(got, want)


def test_pipelined_solve_scan_is_a_deprecated_wrapper(nvsa_setup):
    cfg, cbs, mask, model = nvsa_setup
    gen = torch.Generator().manual_seed(2)
    imgs = torch.rand((2, 1, 9, 32, 32), generator=gen)
    cands = torch.rand((2, 1, 8, 32, 32), generator=gen)
    with pytest.warns(DeprecationWarning):
        ans = nvsa.pipelined_solve_scan(model, imgs, cands, cbs, mask, 5, cfg)
    assert ans.shape == (2, 1)
