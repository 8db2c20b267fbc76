#!/usr/bin/env python3
"""What the program's tracer (``h264tpu_torch.trace``) costs when it is on:
alternate tracer-off and tracer-on windows of a benchmark cell on one card.

    python3 tools/trace_cost.py <cell> [--seed N] [--pairs 3] [--seconds 20]

Builds and warms the cell's encoder as ``benchmark/run.py`` does, then runs
``--pairs`` pairs of ``--seconds`` windows (``benchmark.harness.window``),
off then on in the first pair, on then off in the next, and so on; the
records of an on window are resolved and dropped after it.  Prints one
JSON line per window (frames, seconds, fps, trace records) and a last one
with the median on/off ``fps`` ratio.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cell")
    ap.add_argument("--seed", type=int, default=3000000019)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark.harness.registry import Registry
    from benchmark.harness.window import run_window
    from h264tpu_torch import trace

    reg = Registry()
    cell = reg.cell(args.cell)
    config = reg.config(cell["config"])
    traffic = reg.traffic(cell["traffic"])
    system = reg.system(config["system"])
    s = config["settings"]
    pool = reg.generator(traffic["generator"]).make_pool(
        traffic, s["height"], s["width"], args.seed)
    codec = system.build(s, torch.device("cuda"))
    system.encode(codec, iter(pool[0][:int(cell["warm_frames"])]))
    fps = {False: [], True: []}
    for k in range(args.pairs):
        for on in ((False, True) if k % 2 == 0 else (True, False)):
            trace.reset()
            (trace.enable if on else trace.disable)()
            win = run_window(system, codec, pool, args.seconds,
                             torch.cuda.synchronize)
            trace.disable()
            n = sum(len(t) for t in win["takes"])
            secs = win["t_end"] - win["t_start"]
            fps[on].append(n / secs)
            print(json.dumps(dict(
                cell=args.cell, pair=k, tracing=on, frames=n, seconds=secs,
                fps=n / secs, records=len(trace.records()))), flush=True)
    ratio = statistics.median(a / b for a, b in zip(fps[True], fps[False]))
    print(json.dumps(dict(cell=args.cell, device=torch.cuda.get_device_name(0),
                          fps_on_over_off=ratio)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
