#!/usr/bin/env python3
"""Time the cross_cells kernel of checkouts of the port on one card, in turns.

    python3 tools/time_cross_cells.py TREE_A [TREE_B ...]

Each TREE is the root of a checkout of this repository; its own
``h264tpu_torch`` builds and launches its own kernel.  The turns run the
trees in order and then in reverse (A, B, B, A for two), each in its own
process on the same card.  A turn
checks the kernel against its plain version and times it at chip_smoke.py's
cases cif_luma, cif_chroma and 1080p_luma with chip_smoke.py's device timing
(torch.profiler kernel events) and wrapper timing, times ``fill_`` of a
tensor of cross4's size as the card's practical write rate, and prints one
JSON line per case.  A checkout whose wrapper takes no slot table (before
``offset_tables`` existed) is called without one.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CASES = ("cif_luma", "cif_chroma", "1080p_luma")


def _timing_module():
    spec = importlib.util.spec_from_file_location("chip_smoke_timing",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def turn(tree: str, label: str):
    """Time one checkout's kernel; runs in its own process."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch
    from h264tpu_torch.ops import fractal as F
    cs = _timing_module()
    cs.check(torch.cuda.is_available(), "no CUDA device")
    rng = np.random.default_rng(1)
    for name, H, W, sr, R, mode in cs.KERNEL_CASES:
        if name not in CASES:
            continue
        org, refs_pad = cs.cross_cells_inputs(rng, H, W, sr, R)
        offs_np = F.candidate_offsets(sr, mode)
        if hasattr(F, "offset_tables"):
            offs, slots = F.offset_tables(offs_np, sr, "cuda")
            extra = (slots,)
        else:
            offs, extra = torch.as_tensor(offs_np).cuda(), ()

        def call():
            return F.cross_cell_sums(org, refs_pad, offs, sr, *extra)
        got = call()
        want = F.cross_cell_sums_reference(org, refs_pad, offs, sr)
        torch.cuda.synchronize()
        cs.check(torch.equal(got, want), f"{label}: kernel != plain at {name}")
        del want
        ms = cs.kernel_device_ms(call, 20)
        call_ms = cs.cuda_ms(call, 50)
        buf = torch.empty_like(got)
        fill_ms = cs.kernel_device_ms(lambda: buf.fill_(1), 20,
                                      "elementwise_kernel")
        del buf
        bound_ms, bound_by = cs.cross_cells_bound_ms(H, W, R, sr, len(offs_np))
        print(json.dumps({"tree": label, "case": name, "device_ms": ms,
                          "wrapper_call_ms": call_ms, "fill_ms": fill_ms,
                          "bound_ms": bound_ms,
                          "bound_by": bound_by}), flush=True)


def main(argv) -> int:
    if len(argv) >= 3 and argv[0] == "--turn":
        turn(argv[1], argv[2])
        return 0
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    labels = [chr(ord("A") + i) for i in range(len(argv))]
    for label, tree in zip(labels, argv):
        print(f"{label} = {tree}", flush=True)
    order = list(range(len(argv))) + list(reversed(range(len(argv))))
    for i in order:
        rc = subprocess.run([sys.executable, __file__, "--turn", argv[i],
                             labels[i]]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
