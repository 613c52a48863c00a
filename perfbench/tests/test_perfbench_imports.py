"""What the benchmark loads: no JAX and not the JAX package (``repro``),
compared by the whole top-level name, since the port's name begins with
it; and a reference that imports nothing of the port."""
import ast
import json
import subprocess
import sys

from perfbench.tests.common import ROOT

CHECK = r"""
import json, sys
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]
from perfbench.bench import harness, spec
from perfbench import reference
from perfbench.reference import factorizer, nvsa, philox, quant, vsa
bench = spec.load_benchmark()
for w in bench["workloads"]:
    cell = spec.cell(w["name"], bench)
    spec.load_module("systems", cell.config["system"])
    spec.load_module("generators", cell.traffic["generator"])
for m in bench["end_to_end"] + bench["per_layer"]:
    spec.load_module("metrics", m["name"])
import repro_torch.engine, repro_torch.models.nvsa
print(json.dumps(sorted(sys.modules)))
"""


def test_no_jax_and_no_jax_package_in_a_run():
    out = subprocess.run([sys.executable, "-c", CHECK, str(ROOT)],
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    tops = {m.split(".")[0] for m in mods}
    assert "repro_torch" in tops and "perfbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, \
        sorted(tops & {"jax", "jaxlib", "flax", "repro"})


def test_the_harness_refuses_foreign_modules_by_whole_name():
    from perfbench.bench import harness

    saved = dict(sys.modules)
    try:
        sys.modules["repro_torch_probe"] = object()
        assert "repro_torch_probe" not in harness.foreign_modules()
        sys.modules["repro.core"] = object()
        assert "repro.core" in harness.foreign_modules()
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]


def test_reference_imports_nothing_of_the_port():
    for path in (ROOT / "perfbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in ("torch", "numpy", "math",
                                           "__future__", "perfbench"), (path, n)
                if n.startswith("perfbench"):
                    assert n.startswith("perfbench.reference"), (path, n)
