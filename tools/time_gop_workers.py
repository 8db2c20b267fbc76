#!/usr/bin/env python3
"""Time GOP-parallel fractal encoding on one card, in turns.

    python3 tools/time_gop_workers.py [--reps 2]

Encodes chip_smoke.py's 8 blocky CIF frames in 2 GOPs of 4 with
``gop_workers.fractal_factory`` on the card: sequentially, with 2 threads
on the default stream (``GOPEncoder`` as it is), and with 2 threads that
each run their GOP unit on a CUDA stream of its own, then sequentially
again, ``--reps`` times.  Every stream must equal the first; prints
frames/s per run (host clock, synchronised).
"""

from __future__ import annotations

import argparse
import functools
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from h264tpu_torch.models import gop_parallel as GP  # noqa: E402
from h264tpu_torch.models.gop_workers import fractal_factory  # noqa: E402


class StreamPerUnitGOPEncoder(GP.GOPEncoder):
    """``GOPEncoder`` whose units each run on a CUDA stream of their own."""

    def _encode_unit(self, gi, frames):
        with torch.cuda.stream(torch.cuda.Stream()):
            return super()._encode_unit(gi, frames)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    chip_smoke.phase_device_and_build()
    H, W, n = 288, 352, 8
    frames = chip_smoke.blocky_frames(n, H, W, 0)
    fac = functools.partial(fractal_factory, W, H, 24, search_range=7,
                            device="cuda")
    GP.GOPEncoder(fac, 4).encode(frames[:2])                # warm-up
    first = None
    for rep in range(args.reps):
        for label, cls, kw in (
                ("sequential", GP.GOPEncoder, {}),
                ("threads, default stream", GP.GOPEncoder,
                 dict(workers=2)),
                ("threads, a stream per unit", StreamPerUnitGOPEncoder,
                 dict(workers=2)),
                ("sequential", GP.GOPEncoder, {})):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, stream = cls(fac, 4).encode(frames, **kw)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            first = first or stream
            chip_smoke.check(stream == first, f"{label}: stream differs")
            print(f"[gop workers] rep {rep} {label}: {n / sec:.3f} frames/s",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
