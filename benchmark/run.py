#!/usr/bin/env python3
"""The benchmark of ``h264tpu_torch``: one run of one cell on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The run makes its clips from the seed,
builds the cell's encoder and warms it on this cell's shapes (set-up), feeds
clips through the encoder's ``encode_sequence`` for ``--seconds``, checks
what the window produced against the plain reference under
``benchmark/reference``, and prints one JSON line last on standard output:
the cell's end-to-end metrics with ``--trace 0``, its per-layer metrics
(spans, counters and a short profile) with ``--trace 1``.  It exits non-zero
and prints no result without a CUDA card, or if JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE_DIR = BENCH_DIR / "_cache"


def set_cache_dirs(env=os.environ):
    """Fixed cache directories inside the checkout, so that only the first
    run of a cell in a checkout builds and compiles."""
    for key, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        env[key] = str(CACHE_DIR / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    set_cache_dirs()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch
    torch.set_num_threads(4)
    from benchmark.harness.cell import emit, guarded_exit_code, run_cell
    from benchmark.harness.registry import Registry

    reg = Registry(BENCH_DIR)
    chips = int(reg.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", chips, reg)
    code = guarded_exit_code()
    if code:
        return code
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
