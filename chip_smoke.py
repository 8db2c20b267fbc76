#!/usr/bin/env python3
"""Drive the PyTorch port (h264tpu_torch) of the fractal codec on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero before the result line:

1. device and build: the card's name and power limit, then the hand-written
   kernels of ``h264tpu_torch/csrc`` built with nvcc (ptxas register and
   shared-memory report printed);
2. every kernel against its plain PyTorch version on the card at the shapes
   of the main path (exact int32 equality), timed with CUDA events;
3. the main path at full size: ``FractalCodec.encode_sequence`` of 1 I + 7 P
   CIF frames (QP 24, IPPP, SR 7, half-pel, deblock, CAVLC, FVC) with the
   kernel launch counters reset just before and read just after, then
   ``FractalDecoder.decode`` of the stream, which must reproduce the encoder's
   reconstruction exactly; per-frame PSNR and bits, steady-state P-frame fps,
   per-stage times of one P frame, and one I + one P frame at 1920x1088;
4. the QCIF stream encoded on the card must equal the one encoded on the CPU
   byte for byte (the CPU path is the one the tests hold against the JAX
   package).

The line before the last is a JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``.  Frames are a blocky random texture made
from ``--seed``, shifted per frame.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM rate, and the float32
# rate outside the tensor cores, which bounds the CUDA cores' int32 work
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str):
    if not cond:
        fail(msg)


def blocky_frames(n: int, H: int, W: int, seed: int):
    """A blocky random texture per plane (8x8 blocks plus mild noise),
    shifted by (s, -s) pels with s = i % 3, as bench.py's synthetic
    fallback shifts its frames."""
    rng = np.random.default_rng(seed)
    base = []
    for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2)):
        tex = np.kron(rng.integers(16, 240, (h // 8, w // 8)),
                      np.ones((8, 8), np.int64))
        base.append(np.clip(tex + rng.integers(-4, 5, (h, w)), 0, 255)
                    .astype(np.uint8))
    return [tuple(np.roll(p, (i % 3, -(i % 3)), axis=(0, 1)) for p in base)
            for i in range(n)]


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    import torch
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_device_and_build():
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    from h264tpu_torch import kernels
    t0 = time.time()
    logs = kernels.build_all()
    print(f"[build] {len(logs)} kernel source(s) compiled in "
          f"{time.time() - t0:.1f} s", flush=True)
    for name in kernels.SOURCES:
        log = logs.get(name)
        if log is None:
            log = kernels.library_path(name).with_suffix(".log").read_text()
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}", flush=True)
        kernels.load(name)
    return card


def phase_kernels(seed: int):
    """cross_cells against its plain version at the main path's shapes."""
    import torch
    from h264tpu_torch.ops import fractal as F
    rng = np.random.default_rng(seed + 1)
    cases = [("cif_luma", 288, 352, 7, 4), ("cif_chroma", 144, 176, 7, 4),
             ("odd_sr4_r8", 72, 88, 4, 8)]
    rows = {}
    for name, H, W, sr, R in cases:
        org = torch.as_tensor(rng.integers(0, 256, (H, W)), dtype=torch.int32)
        refs = torch.as_tensor(rng.integers(0, 256, (R, H, W)), dtype=torch.int32)
        org, refs = org.cuda(), refs.cuda()
        refs_pad = torch.nn.functional.pad(refs, (sr, sr, sr, sr)).contiguous()
        offs_np = F.spiral_offsets(sr)
        offs = torch.as_tensor(offs_np).cuda()
        got = F.cross_cell_sums(org, refs_pad, offs, sr)
        want = F.cross_cell_sums_reference(org, refs_pad, offs, sr)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        check(err == 0 and got.shape == want.shape,
              f"cross_cells != plain version at {name}: max abs err {err}")
        launches0 = F.cross_cell_sums.launches
        ms = cuda_ms(lambda: F.cross_cell_sums(org, refs_pad, offs, sr), 50)
        timed = F.cross_cell_sums.launches - launches0
        plain_ms = cuda_ms(
            lambda: F.cross_cell_sums_reference(org, refs_pad, offs, sr), 5, 1)
        n_off = len(offs_np)
        nbytes = 4 * (org.numel() + refs_pad.numel() + offs.numel() + got.numel())
        ops = 2 * R * n_off * H * W            # one multiply + one add per MAC
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                          bound_by="bytes" if t_bytes >= t_ops else "operations",
                          max_abs_err=err)
        print(f"[kernel cross_cells {name}] H={H} W={W} sr={sr} R={R} "
              f"n_off={n_off}: exact; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
              f"bound {max(t_bytes, t_ops):.4f} ms "
              f"(bytes {t_bytes:.4f}, ops {t_ops:.4f}); {timed} timed "
              f"launches counted", flush=True)
    return rows


def cif_config(H: int, W: int):
    from h264tpu_torch.utils.config import CodecConfig, FractalConfig
    return CodecConfig(width=W, height=H, qp=24, intra_period=0, deblock=True,
                       fractal=FractalConfig(search_range=7,
                                             use_halfpel_refs=True))


def p_frame_stages(codec, frame, ref):
    """Device ms of each stage of one P frame (CUDA events around the same
    calls FractalCodec._p_plane makes), plus the host entropy coding ms."""
    import torch
    from h264tpu_torch.models import fractal_codec as FC
    from h264tpu_torch.ops import fractal as F, transform as T, deblock as DB
    orgs = FC._as_planes(frame, codec.device)
    refs = FC._as_planes(ref, codec.device)
    qps = (codec.cfg.qp,) + (T.chroma_qp(codec.cfg.qp),) * 2
    names = ("search", "fractal_recon", "residual", "deblock")
    totals = dict.fromkeys(names, 0.0)
    for i, (org, rf) in enumerate(zip(orgs, refs)):
        h, w = org.shape
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        orgp, refp = FC._pad16(org), FC._pad16(rf)
        hp, wp = orgp.shape
        tree = F.search_plane(orgp, refp, **codec._search_kw)
        ev[1].record()
        maps = F.leaf_maps(tree, hp, wp)
        frec = F.reconstruct_from_maps(maps, refp, hp, wp)[:h, :w]
        ev[2].record()
        zz, rec = T.residual_code_plane(org, frec, qps[i], i == 0)
        ev[3].record()
        nz = (zz != 0).any(dim=-1).reshape(h // 4, w // 4)
        bs_v, bs_h = DB.strengths_fractal(
            {k: m[:h // 4, :w // 4] for k, m in maps.items()}, nz)
        DB.deblock_plane_grouped(rec, bs_v, bs_h, qps[i], i == 0, 1)
        ev[4].record()
        ev[4].synchronize()
        for k, name in enumerate(names):
            totals[name] += ev[k].elapsed_time(ev[k + 1])
    pending = codec.dispatch_frame(frame, ref, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    codec.finalize_frame(pending)
    totals["host_entropy"] = (time.perf_counter() - t0) * 1e3
    return totals


def device_kernel_ms(codec, frame, ref, profile_dir=None):
    """Summed kernel time on the card of one P frame (torch.profiler, device
    events only) and the number of kernels; (None, 0) when the profiler
    records no device time.  The profiler's table is written to
    ``profile_dir`` when one is given."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        codec.encode_frame(frame, ref, 1)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    n_kernels = sum(e.count for e in kernels)
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        with open(os.path.join(profile_dir, "pframe_profile_cif.txt"), "w") as f:
            f.write(events.table(sort_by="self_device_time_total", row_limit=40))
    return (dev_us / 1e3 if dev_us > 0 else None), n_kernels


def phase_main_path(seed: int, profile_dir=None):
    import torch
    from h264tpu_torch.models.fractal_codec import FractalCodec, FractalDecoder
    from h264tpu_torch.ops import fractal as F

    H, W = 288, 352
    frames = blocky_frames(8, H, W, seed)
    codec = FractalCodec(cif_config(H, W), device="cuda")
    codec.encode_sequence(frames[:2])                  # warm-up (allocator)
    torch.cuda.synchronize()

    F.cross_cell_sums.launches = 0
    t0 = time.perf_counter()
    results, stream = codec.encode_sequence(frames)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    launches = {"cross_cells": F.cross_cell_sums.launches}
    check(launches["cross_cells"] > 0,
          "the main path launched cross_cells no time")
    for i, r in enumerate(results):
        print(f"[cif] frame {i} {r.frame_type} PSNR Y {r.psnr_y:.3f} "
              f"U {r.psnr_u:.3f} V {r.psnr_v:.3f} bits {r.bits}", flush=True)
        check(all(np.isfinite([r.psnr_y, r.psnr_u, r.psnr_v])),
              f"non-finite PSNR at frame {i}")
    check([r.frame_type for r in results] == ["I"] + ["P"] * 7,
          "unexpected frame types")
    print(f"[cif] encode_sequence 1I+7P: {seq_s:.3f} s, stream "
          f"{len(stream)} bytes, cross_cells launches {launches['cross_cells']}",
          flush=True)

    t0 = time.perf_counter()
    decoded = FractalDecoder(device="cuda").decode(stream)
    dec_s = time.perf_counter() - t0
    check(len(decoded) == len(results), "decoder returned a wrong frame count")
    for i, (r, planes) in enumerate(zip(results, decoded)):
        for p in range(3):
            check(planes[p].shape == r.recon[p].shape
                  and np.array_equal(planes[p], r.recon[p]),
                  f"decoded frame {i} plane {p} != encoder recon")
    print(f"[cif] decode: bit-exact with the encoder recon, {dec_s:.3f} s",
          flush=True)

    # steady-state P frames, pipelined as encode_sequence runs them
    ref = results[0].recon_dev
    pending = None
    marks = [time.perf_counter()]
    for i in range(1, 8):
        disp = codec.dispatch_frame(frames[i], ref, i)
        ref = disp["recs"]
        if pending is not None:
            codec.finalize_frame(pending)
            marks.append(time.perf_counter())
        pending = disp
    codec.finalize_frame(pending)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    p_fps = 7 / (marks[-1] - marks[0])
    gaps = np.diff(marks[1:]) * 1e3            # frame-to-frame, pipelined
    print(f"[cif] steady-state P-frame encode: {p_fps:.3f} fps over 7 frames "
          f"(host clock, synchronised); frame interval median "
          f"{np.median(gaps):.1f} ms, max {gaps.max():.1f} ms, n={len(gaps)}",
          flush=True)

    stages = p_frame_stages(codec, frames[1], results[0].recon_dev)
    print("[cif] one P frame by stage (ms): " + json.dumps(
        {k: round(v, 3) for k, v in stages.items()}), flush=True)
    dev_ms, n_kernels = device_kernel_ms(codec, frames[1],
                                         results[0].recon_dev, profile_dir)
    p_wall_ms = 1e3 / p_fps
    busy = "not measured" if dev_ms is None else \
        f"{dev_ms:.3f} ms in {n_kernels} kernels, busy share " \
        f"{dev_ms / p_wall_ms:.4f} of the {p_wall_ms:.1f} ms steady-state frame"
    print(f"[cif] one P frame on the card: {busy}", flush=True)
    return launches


def phase_1080p(seed: int):
    import torch
    from h264tpu_torch.models.fractal_codec import FractalCodec
    H, W = 1088, 1920
    frames = blocky_frames(2, H, W, seed)
    codec = FractalCodec(cif_config(H, W), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    i_res, _ = codec.encode_frame(frames[0], None, 0)
    torch.cuda.synchronize()
    i_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p_res, _ = codec.encode_frame(frames[1], i_res.recon_dev, 1)
    torch.cuda.synchronize()
    p_s = time.perf_counter() - t0
    check(np.isfinite(p_res.psnr_y) and p_res.frame_type == "P",
          "1080p P frame failed")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[1080p] I frame {i_s:.3f} s (PSNR Y {i_res.psnr_y:.3f}, "
          f"{i_res.bits} bits); P frame {p_s:.3f} s (PSNR Y "
          f"{p_res.psnr_y:.3f}, {p_res.bits} bits); peak device memory "
          f"{peak:.2f} GiB", flush=True)
    stages = p_frame_stages(codec, frames[1], i_res.recon_dev)
    print("[1080p] one P frame by stage (ms): " + json.dumps(
        {k: round(v, 3) for k, v in stages.items()}), flush=True)


def phase_card_vs_cpu(seed: int):
    from h264tpu_torch.models.fractal_codec import FractalCodec
    H, W = 144, 176
    frames = blocky_frames(3, H, W, seed)
    cfg = cif_config(H, W)
    _, s_gpu = FractalCodec(cfg, device="cuda").encode_sequence(frames)
    _, s_cpu = FractalCodec(cfg, device="cpu").encode_sequence(frames)
    check(s_gpu == s_cpu, "QCIF stream from the card != stream from the CPU")
    print(f"[qcif] card stream == CPU stream ({len(s_gpu)} bytes)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile-dir", default=None,
                    help="write the P-frame torch.profiler table here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: FAILED: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.time()
    phase_device_and_build()
    krows = phase_kernels(args.seed)
    launches = phase_main_path(args.seed, args.profile_dir)
    phase_1080p(args.seed)
    phase_card_vs_cpu(args.seed)
    main_row = krows["cif_luma"]
    record = {"kernels": [{
        "name": "cross_cells", "route": "cuda",
        "source": "h264tpu_torch/csrc/cross_cells.cu",
        "replaces": "h264tpu/ops/fractal.py:338",
        "launches": launches["cross_cells"],
        "max_abs_err": max(r["max_abs_err"] for r in krows.values()),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None}]}
    print(f"[done] {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
