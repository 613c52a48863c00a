"""The port's runtime-serving, fleet-overload and tracing examples
(``examples/torch_{runtime_serving,fleet_overload,tracing}.py``) against the
reference's own scripts on the CPU, fed the reference's arrays.

Each reference script runs once, as a user runs it (``runpy``, its trace
under ``tmp_path``).  The contracts:

  * runtime_serving: the LVRF decodes equal the reference's and the truth;
    the LM tokens equal the reference's ``ServeEngine`` run op by op
    (``jax.disable_jit()``) on the same weights and prompts, bit for bit:
    the jitted reference may part from both at a near tie (ROADMAP, "Jitted
    RoPE near tie"); the paged engine (``REPRO_LM_PAGED=1``) gives the same
    tokens and decodes; every request completes;
  * tracing: ``faults`` and ``recoveries`` equal the reference's (the seeded
    ``FaultPlan`` draws from numpy streams in both), every future resolves,
    the trace's track names equal the reference's, ``obs.validate`` finds
    nothing, and the LVRF decodes and LM tokens are as above;
  * fleet_overload: every request of both runs resolves to a result,
    ``obs.validate`` finds nothing, and the interactive rows decode to the
    truth.  Attainment, p95, re-tunes and the fleet's counts follow the
    host's clock: printed, not compared.
"""
import contextlib
import importlib.util
import io
import os
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def port_example(name: str):
    """``examples/torch_<name>.py`` as a module (its work sits behind
    ``__main__``)."""
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", EXAMPLES / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_run(name: str, *argv) -> dict:
    """Run ``examples/<name>.py`` as ``__main__`` (output swallowed): its
    globals."""
    saved = sys.argv
    sys.argv = [str(EXAMPLES / f"{name}.py"), *argv]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            return runpy.run_path(str(EXAMPLES / f"{name}.py"),
                                  run_name="__main__")
    finally:
        sys.argv = saved


@contextlib.contextmanager
def port_run(paged: bool = False):
    """One intra-op thread (several test workers share the box), and the
    LM pool as ``REPRO_LM_PAGED`` sets it."""
    n = torch.get_num_threads()
    saved = os.environ.pop("REPRO_LM_PAGED", None)
    torch.set_num_threads(1)
    if paged:
        os.environ["REPRO_LM_PAGED"] = "1"
    try:
        yield
    finally:
        torch.set_num_threads(n)
        os.environ.pop("REPRO_LM_PAGED", None)
        if saved is not None:
            os.environ["REPRO_LM_PAGED"] = saved


def reference_tokens(cfg, params, prompts) -> list:
    """Greedy 8-token streams of the reference's contiguous ``ServeEngine``
    at the examples' 2 slots and max_len 48, run op by op: prompts 0 and 1
    together, then prompt 2."""
    from repro.launch.serve import ServeEngine

    out = []
    with jax.disable_jit():
        eng = ServeEngine(cfg, params, 2, 48)
        for group in ([0, 1], [2]):
            for slot, i in enumerate(group):
                eng.add_request(slot, prompts[i])
            for _ in range(8):
                eng.step()
            out += [eng.generated[slot][1:9] for slot in range(len(group))]
            for slot in range(len(group)):
                eng.release_slot(slot)
    return out


def lm_arrays(g: dict) -> dict:
    """The reference script's NVSA books, LVRF atoms, LM weights and
    prompts, as numpy."""
    return {"nvsa_codebooks": np.asarray(g["nspec"].codebooks),
            "nvsa_mask": np.asarray(g["nspec"].valid_mask),
            "lvrf_atoms": jax.tree.map(np.asarray, g["atoms"]),
            "lm_params": jax.tree.map(np.asarray, g["params"]),
            "prompts": [np.asarray(p) for p in g["prompts"]]}


# ---------------------------------------------------------------------------
# runtime_serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runtime_serving():
    g = reference_run("runtime_serving")
    arrays = lm_arrays(g)
    tokens = reference_tokens(g["mcfg"], g["params"], g["prompts"])
    mod = port_example("runtime_serving")
    with port_run():
        port = mod.main(device="cpu", arrays=arrays)
    with port_run(paged=True):
        paged = mod.main(device="cpu", arrays=arrays)
    return g, tokens, port, paged


def test_runtime_serving_lvrf_decodes_equal(runtime_serving):
    g, _, port, paged = runtime_serving
    truth = np.asarray(g["vals"]).tolist()
    assert g["decoded"] == truth
    assert port["lvrf_truth"] == truth
    assert port["lvrf_decoded"] == paged["lvrf_decoded"] == g["decoded"]


def test_runtime_serving_lm_tokens_equal_the_reference_op_by_op(
        runtime_serving):
    _, tokens, port, paged = runtime_serving
    assert not port["lm_paged"] and paged["lm_paged"]
    assert port["lm_tokens"] == tokens
    assert paged["lm_tokens"] == tokens


def test_runtime_serving_completes_every_request(runtime_serving):
    g, _, port, paged = runtime_serving
    for run in (port, paged):
        assert {k: v["completed"] for k, v in run["stats"].items()} == \
            {"nvsa": 1, "lvrf": 12, "lm": 3}
    ref_req = g["req"]
    if np.asarray(ref_req.result["converged"]).all() and \
            all(port["nvsa"]["converged"]):
        assert port["nvsa"]["answer"] == int(ref_req.result["answer"])


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tracing(tmp_path_factory, runtime_serving):
    tmp = tmp_path_factory.mktemp("tracing")
    g = reference_run("tracing", str(tmp / "reference.json"))
    with port_run():
        port = port_example("tracing").main(
            device="cpu", arrays=lm_arrays(g),
            out_path=str(tmp / "port.json"))
    return g, runtime_serving[1], port


def test_tracing_faults_and_recoveries_equal(tracing):
    g, _, port = tracing
    tel = g["stats"]["lvrf"]["telemetry"]
    assert (port["faults"], port["recoveries"]) == \
        (tel["faults"], tel["recoveries"]) == (1, 1)


def test_tracing_every_future_resolves_and_the_trace_validates(tracing):
    g, _, port = tracing
    assert port["resolved"] == len(g["done"]) == 16
    assert port["structured_faults"] == sum(
        isinstance(d, Exception) for d in g["done"])
    assert port["validate_errors"] == []
    assert sorted(port["tracks"]) == sorted(g["per_track"])
    assert os.path.getsize(port["trace"]) > 0


def test_tracing_decodes_and_tokens(tracing):
    g, tokens, port = tracing
    assert port["lvrf_decoded"] == port["lvrf_truth"] == \
        np.asarray(g["vals"]).tolist()
    assert port["lm_tokens"] == tokens


# ---------------------------------------------------------------------------
# fleet_overload
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet")
    g = reference_run("fleet_overload", str(tmp / "reference.json"))
    with port_run():
        port = port_example("fleet_overload").main(
            device="cpu",
            arrays={"lvrf_atoms": jax.tree.map(np.asarray, g["atoms"])},
            out_path=str(tmp / "port.json"))
    return g, port


def test_fleet_every_request_resolves_and_the_trace_validates(fleet):
    g, port = fleet
    n = g["N_JUNK"] + g["N_GOOD"]
    assert len(g["reqs_p"]) == len(g["reqs_b"]) == port["requests"] == n
    assert port["resolved"] == 2 * n
    assert port["validate_errors"] == []
    assert os.path.getsize(port["trace"]) > 0


def test_fleet_interactive_rows_decode_to_the_truth(fleet):
    g, port = fleet
    assert port["interactive_decoded"] == np.asarray(g["vals"]).tolist()
