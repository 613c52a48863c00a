"""Readings that set the limits of ``correct`` in a language-model cell: the
program's, the control's and each planted fault's, over many seeds in one
process.

    python3 perfbench/control_lm.py --workload starcoder2-3b.azure-code \\
        --seeds 1,2,3 --seconds 30

For each seed: one short window of the cell at its own load and the
program's numbers against the reference (a sound run's reading); then, over
the same sample, fed the same prompts and the program's own output tokens,
the numbers of each stand-in put in the program's place, which reads the
token it puts first at every output position: the control (the reference
one precision below the configuration's bf16, every product's operands and
K/V in float8 e4m3: ``fp8``), K/V alone in float8 or int8 beside it
(``fp8_kv``, ``int8_kv``), and the reference with each fault of
``reference/lm.py`` planted (queries rotated one position ahead, the
query's own KV block left out, a layer skipped, LayerNorm without its
bias).  With
``--kv-cache-dtype int8`` the program itself serves from its int8 KV pool
(its own lower-precision path), and its numbers are those of that path.
Prints one JSON line a seed.  The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--stand-ins", type=int, default=1,
                    help="0: the program's numbers alone")
    ap.add_argument("--kv-cache-dtype", default=None,
                    help="serve the program from a KV pool of this type")
    args = ap.parse_args(argv)

    from perfbench.bench import harness, spec
    from perfbench.reference import lm as ref

    cell = spec.cell(args.workload)
    if args.kv_cache_dtype:
        cell.config["kv_cache_dtype"] = args.kv_cache_dtype
    for seed in (int(s) for s in args.seeds.split(",")):
        system, win, _ = harness.measure(cell, seed, args.seconds, False)
        sound, sdiag = harness.judged(cell, system, win, seed)
        sdiag.pop("per_second", None)
        line = {"workload": cell.name, "seed": seed,
                "kv_cache_dtype": cell.config["kv_cache_dtype"],
                "program": sound, "program_diag": sdiag}
        if args.stand_ins:
            for fmt in ref.FORMATS:
                line[fmt] = harness.judged(cell, system, win, seed,
                                           fmt=fmt)[0]
            for fault in ref.FAULTS:
                line[fault] = harness.judged(cell, system, win, seed,
                                             overrides={"fault": fault})[0]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
