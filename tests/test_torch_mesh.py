"""The port's mesh (``launch/mesh.py``) and the sharded engine's cost side
(``engine/sharding/{costs,autotune}.py``) against the reference.

The cost transforms and the autotuner are copies of jax-free reference
code: on the same op graphs they must give the same op names, kinds, dims
and dependencies, and ``choose_slots`` the same verdicts where no collective
is priced.  Collectives are priced on NVLink (the port's constants) where
the reference prices them on the TPU's ICI, so there the test holds the
port to its own constants.
"""
import jax
import pytest
import torch

from repro.core import factorizer as rfz
from repro.core import scheduler as rsch
from repro.core import vsa as rv
from repro.engine import registry as rreg
from repro.engine import sharding as rsh
from repro.engine import stage as rstage
from repro.engine.engine import derive_sweeps_per_step as r_derive
from repro_torch import engine as P
from repro_torch.cogsim.model import COGSYS
from repro_torch.core import factorizer as tfz
from repro_torch.core import scheduler as tsch
from repro_torch.core import vsa as tv
from repro_torch.engine import sharding as tsh
from repro_torch.engine import stage as tstage
from repro_torch.launch import mesh as tmesh


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the mesh ----------------------------------------------------------------

def test_reduce_sums_in_shard_order_per_axis_and_counts_calls():
    mesh = tmesh.make_host_mesh(2, 3, device="cpu")
    assert mesh.shape == {"data": 2, "model": 3}
    # fp32: (1e8 + 1) - 1e8 is 0 in shard order, 1 in any order that adds
    # the two large terms first
    vals = [[1e8, 1.0, -1e8], [2.0, 3.0, 4.0]]
    parts = [[torch.tensor([v], dtype=torch.float32) for v in row]
             for row in vals]
    out = mesh.reduce("model", parts)
    assert [[float(t) for t in row] for row in out] == [[0.0] * 3, [9.0] * 3]
    out = mesh.reduce("data", parts)
    assert [float(t) for t in out[0]] == [
        float(parts[0][m] + parts[1][m]) for m in range(3)]
    assert mesh.reductions == {"data": 1, "model": 1}
    # shards of a group on one device share one result tensor
    assert out[0][0] is out[1][0]
    with pytest.raises(ValueError, match="grid"):
        mesh.reduce("model", parts[:1])
    with pytest.raises(ValueError, match="axes"):
        mesh.reduce("pod", parts)
    assert mesh.reductions == {"data": 1, "model": 1}


def test_mesh_grid_and_axis_handle():
    mesh = tmesh.Mesh([["cpu", "cpu"], ["cpu", "cpu"], ["cpu", "cpu"]])
    assert mesh.shape == {"data": 3, "model": 2}
    assert all(d == torch.device("cpu") for row in mesh.devices for d in row)
    axis = mesh.axis("model")
    assert axis.size == 2 and axis.mesh is mesh
    ones = [[torch.ones(2) for _ in range(2)] for _ in range(3)]
    assert float(axis.reduce(ones)[2][1][0]) == 2.0
    assert mesh.reductions["model"] == 1
    for bad in ([], [["cpu"], ["cpu", "cpu"]]):
        with pytest.raises(ValueError, match="rectangular"):
            tmesh.Mesh(bad)
    with pytest.raises(ValueError, match="axes"):
        mesh.axis("pod")
    with pytest.raises(ValueError, match="at least one"):
        tmesh.make_host_mesh(0, 2, device="cpu")


def test_make_host_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh.make_host_mesh()


# -- collective pricing ------------------------------------------------------

def test_collective_op_cycles_match_the_nvlink_model():
    nbytes, p = 4 * 32 * (10 + 2048), 4
    op = tsch.Op("ps", "collective", (nbytes, p), collective="psum")
    want = tmesh.collective_seconds(nbytes, p, "psum") * COGSYS.freq_hz
    assert tsch.op_cycles(op, COGSYS, 0) == pytest.approx(want)
    assert want == pytest.approx(
        (tmesh.NVLINK_LATENCY_S + 2 * 3 / 4 * nbytes / 450e9)
        * COGSYS.freq_hz)
    assert op.flops() == 0.0
    assert op.bytes_moved() == float(nbytes)
    ag = tmesh.collective_seconds(nbytes, p, "all_gather")
    ps = tmesh.collective_seconds(nbytes, p, "psum")
    assert ps - tmesh.NVLINK_LATENCY_S == \
        pytest.approx(2 * (ag - tmesh.NVLINK_LATENCY_S))
    assert tmesh.collective_seconds(nbytes, 1) == 0.0
    assert tmesh.collective_seconds(nbytes, 2, "ppermute") == pytest.approx(
        tmesh.NVLINK_LATENCY_S + nbytes / tmesh.NVLINK_BW)
    with pytest.raises(ValueError, match="unknown collective"):
        tmesh.collective_seconds(nbytes, 2, "bcast")


def test_schedule_places_collectives_off_the_cell_pool():
    ops = [tsch.Op("g", "gemm", (256, 256, 256), symbolic=True),
           tsch.Op("ps", "collective", (1 << 20, 4), deps=("g",),
                   symbolic=True)]
    s = tsch.schedule(ops, COGSYS)
    tsch.validate(s, ops)
    by_name = {p.op.name: p for p in s.placements}
    assert by_name["ps"].cells == ()
    assert s.makespan >= by_name["g"].end + tsch.op_cycles(ops[1], COGSYS, 0)


# -- cost transforms: the same graphs in both packages -----------------------

def _ops(mod, decl):
    return tuple(mod.Op(name, kind, dims, **kw) for name, kind, dims, kw
                 in decl)


def _graph(sch_mod, stage_mod, name, stages):
    return stage_mod.StageGraph(name, tuple(
        stage_mod.Stage(sname, None, symbolic=sym, cost_ops=_ops(sch_mod, ops))
        for sname, sym, ops in stages))


def _sig(graph):
    return (graph.name, [(st.name, st.symbolic, [
        (o.name, o.kind, tuple(o.dims), tuple(o.deps), o.symbolic,
         o.weight_resident, o.collective) for o in st.cost_ops])
        for st in graph.stages])


_SYM = dict(symbolic=True)
GRAPHS = {
    "toy": [("n", False, [("g1", "gemm", (4096, 512, 512), {})]),
            ("s", True, [("score", "gemm", (512, 1024, 32), _SYM),
                         ("norm", "simd", (512 * 1024,),
                          dict(deps=("score",), **_SYM))])],
    "pair": [("s", True, [("score", "gemm", (64, 1024, 16), _SYM),
                          ("project", "gemm", (64, 16, 1024),
                           dict(deps=("score",), **_SYM)),
                          ("conv", "simd", (64,),
                           dict(deps=("project",), **_SYM))])],
    "rev": [("s", True, [("project", "gemm", (64, 16, 1024),
                          dict(deps=("score",), weight_resident=True,
                               **_SYM)),
                         ("score", "gemm", (64, 1024, 16), _SYM),
                         ("argmax", "simd", (64 * 16,),
                          dict(deps=("score",), **_SYM))])],
    "chain": [("s", True, [("g1", "gemm", (64, 512, 32), _SYM),
                           ("g2", "gemm", (64, 32, 512),
                            dict(deps=("g1",), weight_resident=True, **_SYM)),
                           ("g3", "gemm", (64, 512, 32),
                            dict(deps=("g2",), weight_resident=True, **_SYM)),
                           ("use_g1", "simd", (64,),
                            dict(deps=("g1",), **_SYM))])],
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("shards", [(1, 2), (4, 1), (4, 2), (3, 4)])
@pytest.mark.parametrize("fused", [None, True, False])
def test_shard_graph_and_mark_fused_equal_the_reference(name, shards, fused):
    gr = _graph(rsch, rstage, name, GRAPHS[name])
    gt = _graph(tsch, tstage, name, GRAPHS[name])
    if fused is not None:
        gr, gt = rsh.costs.mark_fused(gr, fused), tsh.costs.mark_fused(gt,
                                                                       fused)
        assert _sig(gt) == _sig(gr)
    assert _sig(tsh.shard_graph(gt, *shards)) == _sig(rsh.shard_graph(gr,
                                                                      *shards))


def test_shard_ops_equals_the_reference():
    decl = [("c", "circconv", (120, 256), _SYM), ("s", "simd", (1000,), {}),
            ("g", "gemm", (100, 64, 32), {}), ("k", "conv2d", (9, 8, 7), {}),
            ("ps", "collective", (4096, 2), {})]
    for n in (1, 3, 8):
        want = rsh.shard_ops(list(_ops(rsch, decl)), n)
        got = tsh.shard_ops(list(_ops(tsch, decl)), n)
        assert [(o.name, tuple(o.dims)) for o in got] == \
            [(o.name, tuple(o.dims)) for o in want]


@pytest.mark.parametrize("algebra", ["bipolar", "unitary"])
@pytest.mark.parametrize("shards", [(1, 1), (4, 1), (4, 2), (2, 5)])
def test_sweep_cost_ops_equal_the_reference(algebra, shards):
    dims = (1024, 1024) if algebra == "bipolar" else (1024, 4)
    kw = dict(num_factors=3, codebook_size=10, algebra=algebra,
              synchronous=True, fused_step=algebra == "bipolar")
    rc = rfz.FactorizerConfig(vsa=rv.VSAConfig(*dims), **kw)
    tc = tfz.FactorizerConfig(vsa=tv.VSAConfig(*dims), **kw)
    d, m = shards
    want = rfz.sweep_cost_ops(rc, 64, data_shards=d, model_shards=m)
    got = tfz.sweep_cost_ops(tc, 64, data_shards=d, model_shards=m)
    assert [(o.name, o.kind, tuple(o.dims), tuple(o.deps), o.weight_resident)
            for o in got] == \
        [(o.name, o.kind, tuple(o.dims), tuple(o.deps), o.weight_resident)
         for o in want]


# -- autotune ----------------------------------------------------------------

@pytest.fixture(scope="module")
def lvrf_specs():
    return (rreg.build("lvrf_rows", jax.random.PRNGKey(0)),
            P.registry.build("lvrf_rows", 0, device="cpu"))


@pytest.mark.parametrize("data", [1, 4])
@pytest.mark.parametrize("rps", [None, 1.0, 1e3, 1e5, 1e7, 1e9])
def test_choose_slots_equals_the_reference_without_model_shards(lvrf_specs,
                                                                data, rps):
    spec_r, spec_t = lvrf_specs
    assert tsh.choose_slots(spec_t, arrival_rps=rps, data_shards=data) == \
        rsh.choose_slots(spec_r, arrival_rps=rps, data_shards=data)
    assert tsh.service_rate_rps(spec_t, 32, data_shards=data) == \
        pytest.approx(rsh.service_rate_rps(spec_r, 32, data_shards=data))


@pytest.mark.parametrize("slots", [8, 32, 256])
def test_derived_sweeps_per_step_with_data_shards_equal_the_reference(
        lvrf_specs, slots):
    spec_r, spec_t = lvrf_specs
    assert P.derive_sweeps_per_step(spec_t, slots, data_shards=4) == \
        r_derive(spec_r, slots, data_shards=4)
    # model shards add collectives, priced on NVLink here: the burst follows
    # the port's own schedule of the sharded sweep
    t_sweep = tsch.schedule(P.step_unit_ops(spec_t, slots, data_shards=4,
                                            model_shards=2), COGSYS).makespan
    assert t_sweep > tsch.schedule(P.step_unit_ops(
        spec_t, slots, data_shards=4), COGSYS).makespan
    assert 1 <= P.derive_sweeps_per_step(spec_t, slots, data_shards=4,
                                         model_shards=2) <= 64


def test_measured_sweep_cost_drives_choose_slots(lvrf_specs):
    _, spec_t = lvrf_specs
    t = tsh.measure_sweep_seconds(spec_t, 4, iters=2, device="cpu")
    assert 0 < t < 10
    calls = []

    def measured(n):
        calls.append(n)
        return 1e-3 * n  # linear cost: flat throughput, knee at the smallest

    assert tsh.choose_slots(spec_t, measured_sweep_s=measured) == \
        min(tsh.autotune.DEFAULT_CANDIDATES)
    assert calls


def test_retune_slots_measured_step_unit_is_wall_clock_basis(lvrf_specs):
    """Port of the reference test: an analytic re-tune at a wall-clock
    arrival rate never moves slots; a measured step cost does, for Engine
    and ShardedEngine alike."""
    _, spec_t = lvrf_specs
    from repro_torch.engine.sharding.autotune import retune_slots

    eng = P.Engine(spec_t, slots=4, sweeps_per_step=2, device="cpu")
    assert retune_slots(eng, 50.0) is None
    verdict = retune_slots(eng, 50.0, measured_step_unit_s=0.05)
    assert verdict is not None and verdict > eng.slots
    sharded = P.ShardedEngine(spec_t, mesh=tmesh.make_host_mesh(
        4, 2, device="cpu"), slots=8, sweeps_per_step=2)
    verdict = retune_slots(sharded, 50.0, measured_step_unit_s=0.05)
    assert verdict is not None and verdict % 4 == 0 and verdict > 8


def test_modeled_sweep_prices_the_fused_path_no_dearer():
    cfg = tfz.FactorizerConfig(vsa=tv.VSAConfig(1024, 1024), num_factors=3,
                               codebook_size=16, synchronous=True)
    assert tsh.modeled_sweep_seconds(cfg, 64, fused=True) <= \
        tsh.modeled_sweep_seconds(cfg, 64, fused=False)
    assert tsh.modeled_sweep_seconds(cfg, 64, data_shards=4, model_shards=2) \
        > 0
