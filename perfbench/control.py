"""Readings that set the limits of ``correct``: the program's and the
control's, over many seeds in one process.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 --seconds 5

For each seed: one short window of the cell at its own load, the program's
numbers against the reference (a sound run's reading), and the control's:
the reference computed one precision below the configuration's (its
``control``: int4 books for int8, TF32 matmuls for fp32) put in the
program's place over the same sample; and each planted fault's: the
reference in the program's place under the configuration with the fault
(``FAULTS``: restarts never taken, the sweep's noise at half and at twice
its scale).  Prints one JSON line a seed.  The benchmark's own runs do not
run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


FAULTS = {
    "restart_off": lambda c: {"restart_every": 0},
    "noise_half": lambda c: {"noise_std": c["noise_std"] * 0.5},
    "noise_double": lambda c: {"noise_std": c["noise_std"] * 2.0},
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--stand-ins", type=int, default=1,
                    help="0: the program's numbers alone")
    args = ap.parse_args(argv)

    from perfbench.bench import harness, spec

    cell = spec.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        system, win, _ = harness.measure(cell, seed, args.seconds, False)
        sound, sdiag = harness.judged(cell, system, win, seed)
        sdiag.pop("per_second", None)
        line = {"workload": cell.name, "seed": seed, "program": sound,
                "program_diag": sdiag}
        if args.stand_ins:
            fmt = cell.config["control"]
            line["control_fmt"] = fmt
            line["control"], _ = harness.judged(cell, system, win, seed, fmt=fmt)
            for name, fault in FAULTS.items():
                line[name], _ = harness.judged(cell, system, win, seed,
                                               overrides=fault(cell.config))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
