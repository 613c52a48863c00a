"""The port's boundary: ``repro_torch`` and ``chip_smoke.py`` use no JAX and
nothing of the reference package ``repro``.

Importing is checked in a fresh subprocess, because this test process has
already imported JAX for the parity tests.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
CHIP_SMOKE = ROOT / "chip_smoke.py"

_IMPORT_ALL = """
import importlib, importlib.util, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
"""


def test_importing_every_module_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL, str(CHIP_SMOKE)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 76  # every package and module of the port, the LM
    # serving slice's (nn, configs, lm, launch, runtime, flash_decode), the
    # sharded engine's (launch.mesh, engine.sharding), MIMONet's
    # (kernels.circconv, models.mimonet, core.superposition), NVSA's
    # (core.symbolic, models.cnn, models.nvsa, engine.build) and the
    # supervised runtime's (runtime.{protocol,telemetry,faults,fleet,
    # runtime}, obs.{slo,report}) included
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
    files = sorted(PORT.rglob("*.py")) + [CHIP_SMOKE]
    assert len(files) >= 78
    names = {p.relative_to(PORT).as_posix() for p in files[:-1]}
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
            "runtime/runtime.py", "obs/slo.py", "obs/report.py"} <= names
    for path in files:
        for name in _imported(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"
