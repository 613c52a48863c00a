"""The port's boundary: ``repro_torch``, ``chip_smoke.py``, the port's
examples (``examples/torch_*.py``, the six user examples among them) and
the single-phase tools (``tools/{train,lm_stack,lm_train,dist,
examples}_phase.py``) use no JAX and nothing of the reference package
``repro``.

Importing is checked in a fresh subprocess, because this test process has
already imported JAX for the parity tests.
"""
import ast
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
CHIP_SMOKE = ROOT / "chip_smoke.py"
EXAMPLES = ["quickstart", "lvrf_ood", "engine_serving", "runtime_serving",
            "fleet_overload", "tracing"]
SCRIPTS = [CHIP_SMOKE, ROOT / "examples" / "torch_raven_abduction.py",
           ROOT / "examples" / "torch_mimonet_superposition.py",
           *(ROOT / "examples" / f"torch_{name}.py" for name in EXAMPLES),
           ROOT / "tools" / "train_phase.py",
           ROOT / "tools" / "lm_stack_phase.py",
           ROOT / "tools" / "lm_train_phase.py",
           ROOT / "tools" / "dist_phase.py",
           ROOT / "tools" / "examples_phase.py"]

_IMPORT_ALL = """
import importlib, importlib.util, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
for i, path in enumerate(sys.argv[1:]):
    spec = importlib.util.spec_from_file_location(f"script_{i}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
"""


def test_importing_every_module_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL,
                          *map(str, SCRIPTS)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 105  # every package and module of the port, the LM
    # serving slice's (nn, configs, lm, launch, runtime, flash_decode), the
    # sharded engine's (launch.mesh, engine.sharding), MIMONet's
    # (kernels.circconv, models.mimonet, core.superposition), NVSA's
    # (core.symbolic, models.cnn, models.nvsa, engine.build) and the
    # supervised runtime's (runtime.{protocol,telemetry,faults,fleet,
    # runtime}, obs.{slo,report}) and training's (train, train.{optimizer,
    # checkpoint,loop}, models.prae) and the rest of the LM stack's
    # (nn.{moe,mamba,xlstm} and the nine other architectures' configs) and
    # LM training's (data.tokens, launch.train, distributed,
    # distributed.compression) and distribution and modelling's (compat,
    # distributed.pipeline, nn.common, launch.{costmodel,roofline,dryrun,
    # dryrun_matrix,roofline_table}) included
    assert bad == "[]"


def _imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_no_source_of_the_port_imports_jax_or_the_reference():
    port = sorted(PORT.rglob("*.py"))
    assert len(port) >= 102
    files = port + SCRIPTS
    names = {p.relative_to(PORT).as_posix() for p in port}
    assert {"nn/layers.py", "nn/transformer.py", "lm/model.py",
            "lm/paging.py", "lm/sampling.py", "launch/serve.py",
            "runtime/lm.py", "configs/registry.py",
            "kernels/flash_decode/ops.py", "launch/mesh.py",
            "engine/sharding/__init__.py", "engine/sharding/engine.py",
            "engine/sharding/costs.py",
            "engine/sharding/autotune.py", "kernels/circconv/ops.py",
            "kernels/circconv/kernel.py", "kernels/circconv/ref.py",
            "models/mimonet.py", "core/superposition.py",
            "core/symbolic.py", "models/cnn.py", "models/nvsa.py",
            "engine/build.py", "data/raven.py", "runtime/protocol.py",
            "runtime/telemetry.py", "runtime/faults.py", "runtime/fleet.py",
            "runtime/runtime.py", "obs/slo.py", "obs/report.py",
            "train/__init__.py", "train/optimizer.py", "train/checkpoint.py",
            "train/loop.py", "models/prae.py", "nn/moe.py", "nn/mamba.py",
            "nn/xlstm.py", "configs/common.py", "configs/dbrx_132b.py",
            "configs/granite_moe_3b_a800m.py",
            "configs/jamba_1_5_large_398b.py", "configs/minicpm_2b.py",
            "configs/qwen2_5_32b.py", "configs/qwen2_vl_72b.py",
            "configs/starcoder2_3b.py", "configs/whisper_small.py",
            "configs/xlstm_125m.py", "compat.py", "distributed/pipeline.py",
            "nn/common.py", "launch/costmodel.py", "launch/roofline.py",
            "launch/dryrun.py", "launch/dryrun_matrix.py",
            "launch/roofline_table.py"} <= names
    for path in files:
        for name in _imported(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"


def test_an_example_asks_for_the_card_and_raises_without_one():
    """The examples default to the card and raise where there is none, before
    any work (``device.resolve``)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    path = ROOT / "examples" / "torch_quickstart.py"
    spec = importlib.util.spec_from_file_location("torch_quickstart", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main(device="cuda")
