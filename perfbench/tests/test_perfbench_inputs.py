"""The benchmark's inputs come from ``--seed`` alone, and its files are
found by name and agree with ``BENCHMARK.json``."""
import json
import re

import numpy as np
import pytest
import torch

from perfbench.tests.common import ROOT, small_cell
from perfbench.bench import inputs, spec

BIG = 2 ** 31 + 977  # seeds may exceed 32 signed bits


def test_row_keys_are_a_counter_hash_of_the_seed():
    a = inputs.row_keys(BIG, 0, 64)
    assert a.dtype == np.int64 and a.shape == (64, 2)
    np.testing.assert_array_equal(inputs.row_keys(BIG, 5, 10), a[5:15])
    np.testing.assert_array_equal(inputs.row_keys(BIG, 0, 64), a)
    assert (a >= 0).all() and (a < 2 ** 62).all()
    assert not np.array_equal(inputs.row_keys(BIG + 1, 0, 64), a)


def test_raven_tasks_repeat_for_a_seed_and_follow_the_rules():
    ctx, cand, ans = inputs.raven_tasks(BIG, 32)
    ctx2, cand2, ans2 = inputs.raven_tasks(BIG, 32)
    np.testing.assert_array_equal(ctx, ctx2)
    np.testing.assert_array_equal(cand, cand2)
    np.testing.assert_array_equal(ans, ans2)
    assert ctx.shape == (32, 8, 3) and cand.shape == (32, 8, 3)
    sizes = np.array([5, 6, 10])
    assert (ctx < sizes).all() and (cand < sizes).all()
    for c in cand:  # 8 distinct candidates
        assert len({tuple(r) for r in c}) == 8
    other = inputs.raven_tasks(BIG + 1, 32)[0]
    assert not np.array_equal(other, ctx)


def test_raven_copy_draws_what_the_ports_generator_draws():
    from repro_torch.data import raven

    for t in range(16):
        mine = inputs.raven_task(np.random.default_rng([7, t]))
        theirs = raven.generate_task(np.random.default_rng([7, t]),
                                     render=False)
        ctx = np.stack([theirs.grid[a].reshape(9)[:8] for a in raven.ATTRS], -1)
        cand = np.stack([theirs.candidates[a] for a in raven.ATTRS], -1)
        np.testing.assert_array_equal(mine[0], ctx)
        np.testing.assert_array_equal(mine[1], cand)
        assert mine[2] == theirs.answer


def test_unitary_atoms_have_unit_spectra_and_repeat():
    gen = inputs.device_generator(BIG, 1, "cpu")
    x = inputs.unitary_atoms(gen, (3, 10), 1024, 4, "cpu")
    y = inputs.unitary_atoms(inputs.device_generator(BIG, 1, "cpu"), (3, 10),
                             1024, 4, "cpu")
    assert torch.equal(x, y)
    mag = torch.abs(torch.fft.rfft(x.reshape(3, 10, 4, 256).double(), dim=-1))
    torch.testing.assert_close(mag * 2.0, torch.ones_like(mag), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("name", ["tab7-int8.closed-256",
                                  "nvsa-raven.serve-256"])
def test_system_inputs_repeat_for_a_seed(name):
    cell = small_cell(name)
    mod = spec.load_module("systems", cell.config["system"])
    a = mod.System(cell.config, cell.traffic, BIG, torch.device("cpu"))
    b = mod.System(cell.config, cell.traffic, BIG, torch.device("cpu"))
    c = mod.System(cell.config, cell.traffic, BIG + 1, torch.device("cpu"))
    assert torch.equal(a.atoms, b.atoms) and not torch.equal(a.atoms, c.atoms)
    qa, qb, qc = (s.request(5)[0] for s in (a, b, c))
    assert torch.equal(qa, qb) and not torch.equal(qa, qc)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_its_schema():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    names = [c["name"] for c in bench["configs"]]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    cells = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
        cells.add(w["name"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "workloads" in m
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for w in cells:  # every cell: setup_s, another end-to-end, a per-layer
        cell = spec.cell(w, bench)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_part_is_found_by_name_and_agrees():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.cell(w["name"], bench)
        spec.load_module("systems", cell.config["system"]).System
        spec.load_module("generators", cell.traffic["generator"]).run
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.load_module("metrics", m["name"]).read)
    assert (spec.load_module("metrics", "sweep.ms.task")
            is spec.load_module("metrics", "sweep.ms.decode"))
    with pytest.raises(KeyError):
        spec.load_module("metrics", "no_such.metric")
