"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name.

* a configuration: ``BENCHMARK.json``'s ``configs`` entry and its ``file``
  (a JSON object of sizes; ``system`` names the adapter in ``systems/``);
* a traffic mix: ``traffic/<name>.json`` (``generator`` names the module
  in ``generators/``);
* the cell's end-to-end metrics: those without ``workloads`` and those that
  list the cell;
* each per-layer metric that lists the cell: ``metrics/<name>.py``, or where
  there is none, the reader of the name without its last dotted part (one
  reader serves ``sweep.ms.decode`` and ``sweep.ms.task``: ``sweep.ms.py``).

Adding a configuration, a mix, a generator, a system or a metric adds a file
and an entry; nothing here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
ROOT = PACKAGE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    bench = bench if bench is not None else load_benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                       f"{sorted(by_name)}")
    w = by_name[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((PACKAGE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    e2e = [m for m in bench["end_to_end"] if _listed(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer)


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module (names may hold dots); a
    metric without a file of its own is read by its name's less its last
    dotted part."""
    path = PACKAGE / kind / f"{name}.py"
    if not path.is_file() and kind == "metrics" and "." in name:
        return load_module(kind, name.rsplit(".", 1)[0])
    if not path.is_file():
        raise KeyError(f"no {kind} module {name!r} at {path}")
    key = f"perfbench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod
