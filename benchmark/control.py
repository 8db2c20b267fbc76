#!/usr/bin/env python3
"""Read a cell's check and its control on several seeds, on one card.

    python3 benchmark/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]
        [--fault <name>]

Each seed runs the cell as ``run.py --trace 0`` does (set-up, a window of
``--seconds``), then reads the check's numbers twice on the same sample:
once of the program's output, once of the control put in its place (the
frozen decoder's picture made without the in-loop filter as the
reconstruction, and in the fractal cells the search recomputed in
bfloat16).  With ``--fault`` the program runs with that fault of
``benchmark/faults.py`` planted, and only its readings are taken.  Prints
one JSON line per seed and a summary line: the largest reading of the
program and the smallest of the control for every number, from which
``PERF.md`` sets the limits.  The benchmark's own runs never run the
control or a fault.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark.run import set_cache_dirs
    set_cache_dirs()
    import torch
    torch.set_num_threads(4)
    from benchmark.faults import plant
    from benchmark.harness.cell import run_cell
    from benchmark.harness.registry import Registry

    if not torch.cuda.is_available():
        print("[control] needs a CUDA card", file=sys.stderr)
        return 2
    reg = Registry(BENCH_DIR)
    program, control = {}, {}
    for seed in args.seeds:
        with plant(args.fault):
            r = run_cell(args.workload, seed, args.seconds, False, "cuda", 1,
                         reg, controls=args.fault is None)
        line = dict(seed=seed, fault=args.fault, correct=r["correct"],
                    control_correct=r.get("control_correct"),
                    program={k: c["value"] for k, c in r["checks"].items()},
                    control={k: c["value"] for k, c in
                             r.get("control_checks", {}).items()})
        print(json.dumps(line), flush=True)
        for k, v in line["program"].items():
            program.setdefault(k, []).append(v)
        for k, v in line["control"].items():
            control.setdefault(k, []).append(v)
    summary = dict(workload=args.workload, seeds=args.seeds, fault=args.fault,
                   program_max={k: max(v, key=_num) for k, v in program.items()},
                   program_min={k: min(v, key=_num) for k, v in program.items()},
                   control_min={k: min(v, key=_num) for k, v in control.items()})
    print(json.dumps(summary), flush=True)
    return 0


def _num(v):
    return float("inf") if v is None else v


if __name__ == "__main__":
    sys.exit(main())
