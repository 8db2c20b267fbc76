#!/usr/bin/env python3
"""Name the card's idle gaps in steady P frames of a benchmark cell by the
program's own spans (``h264tpu_torch.trace``).

    python3 tools/trace_gaps.py <cell> [--seed N] [--frames 3]

Builds the cell's encoder as ``benchmark/run.py`` does, warms it on the
cell's warm clip, then profiles the card (``benchmark.harness.profile``)
from the take of a clip's third frame to the return, with the tracer on,
and passes ``trace.intervals()`` to the profile as its spans.  Prints one
JSON line: the card, the profile's busy and window seconds, launches, top
device ops and the ten longest idle gaps, each named by the innermost
program span and CUDA runtime call around its middle.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cell")
    ap.add_argument("--seed", type=int, default=3000000019)
    ap.add_argument("--frames", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark.harness.profile import Profile
    from benchmark.harness.registry import Registry
    from benchmark.harness.window import feed
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
    prof = Profile()

    def on_take(i):
        if i == 2:
            prof.start()

    trace.enable()
    system.encode(codec, feed(pool[0][:2 + args.frames], [], float("inf"),
                              on_take))
    prof.stop()
    trace.disable()
    out = prof.summary(args.frames, trace.intervals())
    out.update(cell=args.cell, seed=args.seed,
               device=torch.cuda.get_device_name(0))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
