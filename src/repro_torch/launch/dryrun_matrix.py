"""Run the full (arch x shape x mesh) dry-run matrix, one subprocess per cell.

The port of ``repro/launch/dryrun_matrix.py``; host-only, no card needed.
Process isolation keeps one cell's memory or crash from poisoning the rest
(and gives each its own fake process group), and lets a wall-clock budget
apply per cell.  Results aggregate into ``artifacts/dryrun_torch/
matrix.json``, which :mod:`repro_torch.launch.roofline_table` renders.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_matrix --timeout 900
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))
OUT_DIR = os.path.join(ROOT, "artifacts", "dryrun_torch")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--timeout", type=int, default=900)
    ap.add_argument("--only-failed", action="store_true")
    args = ap.parse_args(argv)
    from repro_torch.configs.common import SHAPES
    from repro_torch.configs.registry import ARCHS

    os.makedirs(OUT_DIR, exist_ok=True)
    matrix_path = os.path.join(OUT_DIR, "matrix.json")
    results = {}
    if os.path.exists(matrix_path):
        with open(matrix_path) as f:
            results = {tuple(k.split("|")): v for k, v in json.load(f).items()}

    cells = [(a, s, mp) for a in ARCHS for s in SHAPES for mp in (False, True)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    for aid, shp, mp in cells:
        key = (aid, shp, "2x16x16" if mp else "16x16")
        if args.only_failed and key in results and \
                "error" not in results[key] and "timeout" not in results[key]:
            continue
        cell_out = os.path.join(OUT_DIR, f"cell_{aid}_{shp}_{key[2]}.json")
        if os.path.exists(cell_out):
            os.remove(cell_out)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               aid, "--shape", shp, "--out", cell_out] + \
            (["--multipod"] if mp else [])
        t0 = time.time()
        try:
            proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                                  timeout=args.timeout)
            if os.path.exists(cell_out):
                with open(cell_out) as f:
                    cell = json.load(f)[0]
            else:
                cell = {"arch": aid, "shape": shp, "mesh": key[2],
                        "error": proc.stderr[-800:]}
        except subprocess.TimeoutExpired:
            cell = {"arch": aid, "shape": shp, "mesh": key[2],
                    "timeout": args.timeout}
        cell["wall_s"] = round(time.time() - t0, 1)
        results[key] = cell
        status = "SKIP" if "skipped" in cell else (
            "FAIL" if ("error" in cell or "timeout" in cell) else "OK")
        print(f"[{status}] {aid} {shp} {key[2]} ({cell['wall_s']}s)", flush=True)
        with open(matrix_path, "w") as f:
            json.dump({"|".join(k): v for k, v in results.items()}, f, indent=1,
                      default=str)
    n_ok = sum(1 for v in results.values()
               if "error" not in v and "timeout" not in v and "skipped" not in v)
    n_skip = sum(1 for v in results.values() if "skipped" in v)
    print(f"done: {n_ok} ok, {n_skip} skipped, {len(results)-n_ok-n_skip} failed")


if __name__ == "__main__":
    main()
