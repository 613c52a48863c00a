"""Render the roofline table from ``artifacts/dryrun_torch/matrix.json``.

The port of ``repro/launch/roofline_table.py``; host-only, no card needed.
Every figure in it is the H100 model's (data-sheet peaks), not a
measurement.

    PYTHONPATH=src python -m repro_torch.launch.roofline_table
"""
from __future__ import annotations

import json
import os

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))


def load():
    with open(os.path.join(ROOT, "artifacts", "dryrun_torch", "matrix.json")) as f:
        return json.load(f)


def fmt_table(mesh_filter: str = "16x16") -> str:
    m = load()
    lines = [
        "| arch | shape | comp (s) | mem (s) | coll (s) | bottleneck | "
        "useful frac | 6ND/active FLOPs | mem/dev (args+temp GiB) |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for key, v in sorted(m.items()):
        aid, shp, mesh = key.split("|")
        if mesh != mesh_filter:
            continue
        if "skipped" in v:
            lines.append(f"| {aid} | {shp} | — | — | — | SKIP | — | — | "
                         f"{v['skipped'][:60]} |")
            continue
        if "error" in v or "timeout" in v:
            lines.append(f"| {aid} | {shp} | — | — | — | FAIL | — | — | — |")
            continue
        t = v["terms"]
        mem = v["memory"]
        lines.append(
            f"| {aid} | {shp} | {t['compute_s']:.3e} | {t['memory_s']:.3e} | "
            f"{t['collective_s']:.3e} | {t['bottleneck']} | "
            f"{v['useful_frac']:.1%} | {v['model_flops']['model_flops_active']:.2e} | "
            f"{mem['argument_bytes']/2**30:.2f}+{mem['temp_bytes']/2**30:.2f} |")
    return "\n".join(lines)


def pick_hillclimb() -> list:
    """Worst useful fraction, most collective-bound, and the most
    memory-over-budget cell (the technique-representative target)."""
    m = load()
    cells = {k: v for k, v in m.items()
             if "terms" in v and k.endswith("16x16") and "|" in k}
    worst_frac = min(cells.items(), key=lambda kv: kv[1]["useful_frac"])
    most_coll = max(cells.items(),
                    key=lambda kv: kv[1]["terms"]["collective_s"]
                    / max(kv[1]["terms"]["compute_s"],
                          kv[1]["terms"]["memory_s"], 1e-12))
    over_mem = max(cells.items(),
                   key=lambda kv: kv[1]["memory"]["temp_bytes"])
    return [("worst-useful-frac", *worst_frac),
            ("most-collective-bound", *most_coll),
            ("largest-temp-memory", *over_mem)]


if __name__ == "__main__":
    print(fmt_table("16x16"))
    print()
    for tag, key, v in pick_hillclimb():
        print(f"HILLCLIMB[{tag}]: {key} useful={v['useful_frac']:.1%} "
              f"coll={v['terms']['collective_s']:.3e}s "
              f"temp={v['memory']['temp_bytes']/2**30:.1f}GiB")
