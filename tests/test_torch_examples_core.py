"""The port's quickstart, LVRF OOD and engine-serving examples
(``examples/torch_{quickstart,lvrf_ood,engine_serving}.py``) against the
reference's own scripts on the CPU, fed the reference's arrays.

Each reference script runs once, as a user runs it (``runpy``; its printed
figures are read from its globals, or from its output where it keeps
none).  The contracts:

  * quickstart: the decoded scene (scalar, batched of 4, int8) is the scene
    in both packages, and ``codebook_bytes`` and the int8 codebook's bytes
    are equal.  Its sweeps are stochastic (noise 0.3, restarts) and the two
    packages draw from different generators (Philox against
    ``jax.random``), so iterations are held to the stochastic contract:
    each run within the budget of 60;
  * lvrf_ood, the reference's inputs rebuilt from its keys: abduction
    accuracy, execution accuracy and both OOD flag rates equal, exactly
    (each is a count over 32 or 96 rows);
  * engine_serving: the LVRF decodes bitwise the reference's and the truth;
    the adSCH plan equal (lags, gain to the printed 2 decimals, depth); the
    NVSA answers equal on every task whose 8 queries converged in both.
"""
import contextlib
import importlib.util
import io
import re
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


def reference_run(name: str, *argv) -> tuple:
    """Run ``examples/<name>.py`` as ``__main__``: (its globals, its
    output)."""
    out = io.StringIO()
    saved = sys.argv
    sys.argv = [str(EXAMPLES / f"{name}.py"), *argv]
    try:
        with contextlib.redirect_stdout(out):
            g = runpy.run_path(str(EXAMPLES / f"{name}.py"),
                               run_name="__main__")
    finally:
        sys.argv = saved
    return g, out.getvalue()


@contextlib.contextmanager
def one_thread():
    """One intra-op thread: with several test workers the default threads
    make the examples' small ops many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def quickstart():
    g, _ = reference_run("quickstart")
    with one_thread():
        port = port_example("quickstart").main(
            device="cpu", arrays={"codebooks": np.asarray(g["codebooks"])})
    return g, port


def test_quickstart_decodes_the_scene_in_both_packages(quickstart):
    g, port = quickstart
    scene = [7, 2, 5]
    scenes = np.asarray(g["scenes"]).tolist()
    assert np.asarray(g["res"].indices).tolist() == scene
    assert np.asarray(g["bres"].indices).tolist() == scenes
    assert np.asarray(g["res8"].indices).tolist() == scene
    assert port["decoded"] == port["int8_decoded"] == scene
    assert port["batched_indices"] == scenes
    # the stochastic contract: both packages settle within the budget
    budget = g["cfg"].max_iters
    for its in ([int(g["res"].iterations), int(g["res8"].iterations)]
                + np.asarray(g["bres"].iterations).tolist(),
                [port["iterations"], port["int8_iterations"]]
                + port["batched_iterations"]):
        assert all(1 <= i <= budget for i in its)


def test_quickstart_memory_figures_equal(quickstart):
    g, port = quickstart
    assert port["codebook_bytes"] == dict(g["mem"])
    assert port["int8_bytes"] == g["q8"].nbytes()


# ---------------------------------------------------------------------------
# lvrf_ood
# ---------------------------------------------------------------------------

_LVRF_FIGURES = (r"rule abduction accuracy: ([\d.]+)",
                 r"execution \(complete the row\) accuracy: ([\d.]+)",
                 r"in-dist=([\d.]+)", r"held-out-rule=([\d.]+)")


@pytest.fixture(scope="module")
def lvrf_ood():
    from repro.core import vsa as rvsa
    from repro.models import lvrf as rlvrf

    _, out = reference_run("lvrf_ood")
    ref = [float(re.search(p, out).group(1)) for p in _LVRF_FIGURES]
    # the reference's inputs rebuilt from its keys (its main keeps none)
    cfg = rlvrf.LVRFConfig(vsa=rvsa.VSAConfig(8192, 8192), ood_threshold=0.03)
    atoms = jax.tree.map(np.asarray,
                         rlvrf.init_atoms(jax.random.PRNGKey(0), cfg))
    with one_thread():
        port = port_example("lvrf_ood").main(device="cpu",
                                             arrays={"atoms": atoms})
    return ref, port


def test_lvrf_ood_figures_equal_the_reference(lvrf_ood):
    ref, port = lvrf_ood
    got = [port["abduction_accuracy"], port["execution_accuracy"],
           port["ood_rate_in_dist"], port["ood_rate_held_out"]]
    # printed at 3, 3, 2 and 2 decimals; each is a count over 96 or 32 rows
    assert [f"{got[0]:.3f}", f"{got[1]:.3f}", f"{got[2]:.2f}",
            f"{got[3]:.2f}"] == [f"{ref[0]:.3f}", f"{ref[1]:.3f}",
                                 f"{ref[2]:.2f}", f"{ref[3]:.2f}"]
    assert got[0] * 96 == round(got[0] * 96)
    assert got[1] * 32 == round(got[1] * 32)


def test_lvrf_ood_flags_the_held_out_rule(lvrf_ood):
    _, port = lvrf_ood
    assert port["ood_rate_held_out"] > port["ood_rate_in_dist"]
    assert port["abduction_accuracy"] == 1.0


# ---------------------------------------------------------------------------
# engine_serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine_serving():
    from repro.models import cnn as rcnn

    g, _ = reference_run("engine_serving")
    # the CNN the reference built its spec with (its script keeps no handle)
    params = jax.tree.map(np.asarray,
                          rcnn.init(jax.random.PRNGKey(1), g["cfg"].cnn))
    arrays = {"nvsa_codebooks": np.asarray(g["cbs"]),
              "nvsa_mask": np.asarray(g["mask"]), "cnn_params": params,
              "lvrf_atoms": jax.tree.map(np.asarray, g["atoms"]),
              "images": np.asarray(g["imgs"]),
              "candidates": np.asarray(g["cands"])}
    with one_thread():
        port = port_example("engine_serving").main(device="cpu",
                                                   arrays=arrays)
    return g, port


def test_engine_serving_lvrf_decodes_bitwise(engine_serving):
    g, port = engine_serving
    truth = np.asarray(g["vals"]).tolist()
    assert g["decoded"] == truth
    assert port["lvrf"]["truth"] == truth
    assert port["lvrf"]["decoded"] == g["decoded"]


def test_engine_serving_plan_equals_the_reference(engine_serving):
    g, port = engine_serving
    plan = g["plan"]
    assert port["stream"]["lags"] == list(plan.lags) == [1]
    assert f"{port['stream']['gain']:.2f}" == f"{plan.gains[0]:.2f}"
    assert port["stream"]["depth"] == plan.depth == 2
    answers = np.asarray(port["stream"]["answers"])
    assert answers.shape == np.asarray(g["answers"]).shape == (3, 2)
    assert ((answers >= 0) & (answers < 8)).all()


def test_engine_serving_nvsa_answers_agree_where_both_converged(
        engine_serving):
    g, port = engine_serving
    ref_reqs = [g["eng"].completed[i] for i in sorted(g["eng"].completed)]
    assert len(ref_reqs) == len(port["nvsa"]["answers"]) == 4
    compared = 0
    for req, ans, conv in zip(ref_reqs, port["nvsa"]["answers"],
                              port["nvsa"]["converged"]):
        if np.asarray(req.result["converged"]).all() and all(conv):
            assert ans == int(req.result["answer"])
            compared += 1
    # target queries settle in a sweep or two in both packages
    assert compared >= 3
