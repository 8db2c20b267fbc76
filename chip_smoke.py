#!/usr/bin/env python3
"""Drive the PyTorch port (h264tpu_torch) on one CUDA card: the fractal codec,
the conformant H.264 encoder and the modules around them.

    python3 chip_smoke.py [--seed 0] [--trace] [--profile-dir DIR]

Phases, in order; any failure exits non-zero before the result line:

1. device and build: the card's name and power limit, the native host
   stages (``csrc/avc_native.cpp``, ``csrc/fvc_native.cpp``) built with
   g++, then the hand-written kernels of ``h264tpu_torch/csrc`` built with
   nvcc (ptxas register and shared-memory report printed);
2. every kernel against its plain PyTorch version on the card (exact int32
   equality) at the shapes of the main path (CIF luma and chroma, 1080p
   luma, CIF luma and chroma with the 3-view side views' eight reference
   planes, the row tiles of the sharded step with real halo rows: CIF luma
   and chroma over 9 tiles, 1080p luma over 2) and
   of the search's other options (search modes 1-3, SR 16, one reference
   plane, ragged tiles); each case reports the kernel's device
   time per launch (torch.profiler kernel events) and, apart from it, the
   wrapper's call time (CUDA events around back-to-back calls);
3. the fractal main path at full size: ``FractalCodec.encode_sequence`` of
   1 I + 7 P CIF frames (QP 24, IPPP, SR 7, half-pel, deblock, CAVLC, FVC)
   with the kernel launch counters reset just before and read just after,
   then ``FractalDecoder.decode`` of the stream, which must reproduce the
   encoder's reconstruction exactly; per-frame PSNR and bits, steady-state
   P-frame fps, per-stage times of one P frame, and one I + one P frame at
   1920x1088;
4. the fractal QCIF stream encoded on the card must equal the one encoded on
   the CPU byte for byte (the CPU path is the one the tests hold against the
   JAX package);
5. the conformant H.264 encoder (``DeviceAVCCodec``, IPPP CAVLC) at the
   ``bench.py`` AVC settings (QP 28, SR 8, one reference): 1 IDR + 4 P CIF
   frames in 9 slices, decoded bit-exactly by the port's ``AVCDecoder``, with
   per-frame bits and PSNR, steady-state P fps, kbps at 30 fps, device ms per
   stage, host ms of the packer and the deblock, and with ``--trace`` the
   kernel launches and summed kernel time of one P frame (torch.profiler,
   off by default: the High CIF trace alone takes ~190 s); a QCIF stream in 3
   slices encoded on the card and on the CPU, which must be equal byte for
   byte; and 1 IDR + 1 P 1920x1088 frames in 17 slices, encode only, with
   the same stages and the peak device memory;
6. the encoder's High-profile P path at the ``tools/bdrate.py``
   configuration (High, per-MB 8x8 transform, P_8x8 sub-partitions, QP 28,
   SR 8, one reference, one slice): 1 IDR + 4 P CIF frames decoded
   bit-exactly, per-frame counts of 8x8-transform and sub-partitioned MBs
   (both must occur), stages, host ms, fps, and with ``--trace`` launches
   and summed kernel time of one P frame; QCIF in 3 slices on the card and
   on the CPU, equal
   byte for byte, with (i) 8x8 + sub-8x8 + default scaling lists and (ii)
   the 8x8 transform alone (packed by the C packer); 1 IDR + 1 P 1080p in
   17 slices, encode only, with stages and peak device memory;
7. the encoder's hierarchical-B CABAC path at ``bench.py``'s
   ``avc_cif_hierb_cabac`` configuration (CIF, QP 28, Main, CABAC, 3
   references, SR 8, 9 slices, bframes=3 hierarchical, 9 frames, after a
   warm encode of 5): the stream decodes bit-exactly with the port's
   ``AVCDecoder``, frame types in display order ``IDR B B B P B B B P``,
   some B frame has direct or skip MBs and some has Bi MBs; sequence fps
   as bench defines it (frames / seconds), ms per B frame, and one B
   frame's device stages (Stage A and B per list, the scan's eager first
   step, capture and replays) with its CABAC pack and deblock host ms;
   with ``--trace`` the launches of one B frame;
8. QCIF B streams on the card and on the CPU, equal byte for byte:
   hierarchical-B CABAC in 3 slices (5 frames) and IbbP CAVLC with
   ``bframes=2`` (4 frames);
9. hierarchical-B CABAC at 1920x1088 in 17 slices (level 4.2), IDR plus
   one GOP of 4, encode only: per-frame host ms of the CABAC packer and
   the deblock, the device stages of the P anchor and of one B frame, and
   the peak device memory;
10. explicit weighted prediction at the CIF settings of phase 5 (Main,
   CAVLC, 2 references, 9 slices) on an additive fade (luma +6 a frame),
   1 IDR + 4 P, with the DC-ratio and the least-squares estimators: each
   stream decodes bit-exactly; reference 0's luma weight and offset per
   frame, steady-state P fps;
11. quadratic rate control at the CIF settings on frames whose top third is
   flat, 1 IDR + 5 P: ``rc_mode`` 1 (one QP per frame), then ``rc_mode`` 3
   with the 9 slices as basic units, which must give some P frame more
   than one slice QP; QPs, bits against the budget, P fps, bit-exact
   decode;
12. data partitioning (Extended profile) at the CIF settings, 1 IDR + 4 P
   with a forced-intra MB row in frame 2: NAL types 2, 3 and 4, a partition
   B with residual, bit-exact decode;
13. QCIF in 3 slices, card stream == CPU stream and decoded: WP (LMS), rate
   control ``rc_mode`` 3, data partitioning;
14. ``rc_mode`` 3 at 1920x1088 in 17 slices, IDR + 2 P, encode only: the
   last P frame's 17 slice QPs (split), its stages at those QPs, and the
   peak device memory;
15. the native host stages (``csrc/avc_native.cpp``, built with g++ in
   phase 1) against their numpy twins on frames of phases 5 and 6: equal
   planes and bytes, with both times;
16. the fractal codec's classic H.264-style inter at phase 3's CIF
   configuration (ME search range 16): 1 I + 4 P decoded bit-exactly, the
   P-frame interval and one P frame's device ms for the full search,
   sub-pel refinement, MC + residual and deblock;
17. fractal rate control at CIF, 1 I + 5 P, the budget the fixed-QP-24
   rate of the same frames: QPs, P bits against the budget, bit-exact
   decode;
18. the Annex-B and RTP containers at CIF, 1 I + 3 P each, decoded
   bit-exactly; RTP with frame 2's packet dropped, which the decoder
   conceals by a copy of frame 1;
19. CABAC and Exp-Golomb residuals at CIF, 1 I + 3 P each, decoded
   bit-exactly, with the host entropy ms of a P frame;
20. 3-view coding at CIF (side views the centre shifted by +-4 pels), three
   views of 1 I + 3 P decoded bit-exactly, with the cross_cells launches of
   the path (R = 8 on the side views);
21. region coding at CIF (a textured square over a still background, masks
   from ``segment_sequence`` over 7 frames, every mask used holding the
   object), 1 I + 3 P decoded with the masks bit-exactly, and one region
   frame's device ms by stage;
22. one QCIF sequence per fractal option (classic, rate control, annexb,
   rtp, CABAC, Exp-Golomb, 3-view, region): card stream == CPU stream;
23. ``frame_metrics`` of a CIF reconstruction on the card (numpy input, the
   default device) against the same call with ``device="cpu"``;
24. the native FVC coders (CAVLC and CABAC residual planes, intra-mode
   resolution, emulation prevention) against their Python twins on the
   levels of phase 3's CIF I and P frames: equal bytes, both times;
25. GOP-parallel fractal encoding at CIF (``GOPEncoder`` with
   ``gop_workers.fractal_factory`` on the card), 8 frames in 2 GOPs:
   sequential, 2 threads and 2 spawned processes, each stream equal to the
   sequential one; frames/s of each and the cross_cells launches of the
   in-process runs;
26. ``KDecoderSim`` (K = 8) and ``MultiHypothesisDrift`` over phase 5's
   reconstructions: card states and drift equal the CPU's bit for bit, ms
   per step;
27. the legacy still-image codec at CIF and 1920x1088: card stream == CPU
   stream, card decode == CPU decode, encode and decode ms;
28. MVC stereo at CIF in 9 slices (view 1 view 0 shifted 4 pels, 1 IDR + 3
   P pairs), both views decoded bit-exactly by ``decode_mvc``; QCIF in 3
   slices, card stream == CPU stream;
29. the fractal codec over (1, 3) and (1, 9) meshes at phase 3's CIF
   configuration with ``tile_rows=9`` (1 I + 3 P) and over a (1, 2) mesh
   at 1920x1088 with ``tile_rows=2`` (1 I + 1 P): every stream equal to the
   unsharded one at the same ``tile_rows``, decoded bit-exactly; P
   intervals, one sharded P frame's stages, and the cross_cells launches
   (3 planes x tiles per P frame);
30. ``DeviceAVCCodec`` over 3- and 9-slot "slice" meshes at phase 5's CIF
   settings, 1 IDR + 2 P, and phase 7's hierarchical-B CABAC over 3 slots
   (5 frames): streams equal to the unsharded ones, decoded bit-exactly; P
   fps;
31. the port's ``parallel.dryrun.dryrun_multichip(8)``, stages 1-4;
32. phase 5's CIF stream with one slice NAL lost, of the IDR and of a P
   picture: the port's decoder conceals 44 MBs (2 MB rows of 22); PSNR-Y
   of the pictures against the encoder's reconstruction;
33. the cfg-file entry path: a JM-style ``encoder.cfg`` (phase 3's CIF
   configuration) read by ``config_from_cfg``, phase 3's frames written to
   disk as 8-bit 4:2:0 (``YUVWriter``) and as 10-bit 4:4:4 and read back
   (``YUVReader``, ``read_yuv_frame``), each encoded by ``FractalCodec`` on
   the card: both streams equal phase 3's byte for byte, decode bit-exactly
   on the card, 21 cross_cells launches each; the steady-state P interval
   beside phase 3's, the ``SequenceReport`` summary and a ``log.dat`` row;
34. the host conformant encoder ``AVCCodec`` (numpy on the host, as in the
   reference): 1 IDR + 2 P CIF frames at its defaults (Baseline, QP 28,
   SR 16) with host seconds per frame; at QCIF and SR 8, FMO all-IDR (map
   types 0 and 1), lossless I_PCM, IbbP, open GOP (its recovery-point SEI
   parsed back), redundant slices, UMHex, the RD picture decision, explicit
   WP over 3 references (LMS) and an explicit coding-order sequence, each
   decoded bit-exactly by the port's ``AVCDecoder``; and the FMO stream
   with one slice group's NAL lost, concealed by the decoder.

Every mesh puts slot i on card ``i % torch.cuda.device_count()`` and prints
how many distinct cards it spans.

Stage times are the device times of the spans the codecs record themselves
(``h264tpu_torch.trace``: ``fractal.*``, ``avc.scan.*``), summed by name.

The line before the last is a JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``.  Frames are made from ``--seed``: a
blocky random texture shifted per frame, and for the High phases a smooth
one with noise whose motion varies inside an 8x8 (also the hierarchical-B
CIF phase's).
"""

from __future__ import annotations

import argparse
import dataclasses
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


def smooth_frames(n: int, H: int, W: int, seed: int):
    """A smooth random texture moving (2, 3) pels a frame with noise, as
    ``tests/test_torch_avc_high.py`` makes it: its motion varies inside an
    8x8, so the High phases' sub-8x8 partitions and 8x8 transform both get
    chosen."""
    rng = np.random.default_rng(seed)
    big = rng.normal(0, 1, (H + 3 * n, W + 3 * n))
    for _ in range(3):
        big = (big + np.roll(big, 1, 0) + np.roll(big, -1, 0)
               + np.roll(big, 1, 1) + np.roll(big, -1, 1)) / 5
    big = 128 + big / big.std() * 50
    out = []
    for i in range(n):
        y = np.clip(big[3 * i:3 * i + H, 2 * i:2 * i + W]
                    + rng.normal(0, 6, (H, W)), 0, 255).astype(np.uint8)
        u = np.clip(y[::2, ::2] * 0.5 + 60 + rng.normal(0, 3, (H // 2, W // 2)),
                    0, 255).astype(np.uint8)
        v = np.clip(255 - y[1::2, 1::2] * 0.6
                    + rng.normal(0, 3, (H // 2, W // 2)), 0, 255).astype(np.uint8)
        out.append((y, u, v))
    return out


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean ms per call of ``fn`` between CUDA events around ``reps``
    back-to-back calls: for a wrapper whose launches are shorter than its
    host work, this is the wrapper's call time, not the kernel's."""
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


PROFILER_WINDOWS = 3


def kernel_device_ms(fn, reps: int, name: str = "cross_cells_kernel") -> float:
    """Mean device time in ms of one launch of the kernel whose name holds
    ``name``, from the kernel events torch.profiler records over ``reps``
    calls of ``fn`` (after one warm-up call).  A window in which the
    profiler records fewer kernel events than calls is traced again, up to
    PROFILER_WINDOWS windows; fails unless one window saw every call launch
    the kernel exactly once."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILER_WINDOWS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.device_time_total for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and name in e.name]
        if len(us) == reps and all(u > 0 for u in us):
            return sum(us) / len(us) / 1e3
        print(f"[profiler] window {attempt} of {PROFILER_WINDOWS} saw "
              f"{len(us)} {name} "
              f"launches with device time, not {reps}", flush=True)
    fail(f"the profiler saw no complete window of {reps} {name} launches "
         f"in {PROFILER_WINDOWS} tries")


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
    from h264tpu_torch.avc import native as AN
    t0 = time.time()
    AN.build()
    AN._load()
    print(f"[build] native host stages {AN.library_path().name} built and "
          f"loaded in {time.time() - t0:.1f} s", flush=True)
    from h264tpu_torch.entropy import native as FN
    t0 = time.time()
    FN.build()
    FN._load()
    print(f"[build] native FVC coders {FN.library_path().name} built and "
          f"loaded in {time.time() - t0:.1f} s", flush=True)
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


# name, H, W, search range, reference planes R, search mode
KERNEL_CASES = (
    ("cif_luma", 288, 352, 7, 4, 0),
    ("cif_chroma", 144, 176, 7, 4, 0),
    ("cif_luma_views3", 288, 352, 7, 8, 0),   # 3-view side views: two frames
    ("cif_chroma_views3", 144, 176, 7, 8, 0),
    ("1080p_luma", 1088, 1920, 7, 4, 0),
    ("cif_luma_mode1", 288, 352, 7, 4, 1),
    ("cif_luma_mode2", 288, 352, 7, 4, 2),
    ("cif_luma_mode3", 288, 352, 7, 4, 3),
    ("cif_luma_sr16", 288, 352, 16, 4, 0),
    ("cif_luma_r1", 288, 352, 7, 1, 0),
    ("odd_sr4_r8", 72, 88, 4, 8, 0),
    ("ragged_sr2_r1", 36, 44, 2, 1, 0),
    # a row tile of the sharded step: real halo rows above and below
    ("cif_luma_tiled9", 32, 352, 7, 4, 0),
    ("cif_chroma_tiled9", 16, 176, 7, 4, 0),
    ("1080p_luma_tiled2", 544, 1920, 7, 4, 0),
)
# the cases whose window rows are a tile's halo (the columns stay zero)
HALO_CASES = ("cif_luma_tiled9", "cif_chroma_tiled9", "1080p_luma_tiled2")


def cross_cells_inputs(rng, H: int, W: int, sr: int, R: int,
                       halo: bool = False):
    """(org [H, W], refs_pad [R, H+2sr, W+2sr]) int32 pixels on the card;
    with ``halo`` the sr rows above and below are pixels too, as a row
    tile's window holds its neighbours' rows."""
    import torch
    org = torch.as_tensor(rng.integers(0, 256, (H, W)), dtype=torch.int32)
    rows = H + 2 * sr if halo else H
    refs = torch.as_tensor(rng.integers(0, 256, (R, rows, W)),
                           dtype=torch.int32)
    refs_pad = torch.nn.functional.pad(
        refs, (sr, sr) if halo else (sr, sr, sr, sr))
    return org.cuda(), refs_pad.contiguous().cuda()


def cross_cells_bound_ms(H: int, W: int, R: int, sr: int, n_off: int):
    """(bound ms, "bytes" or "operations"): each input read once (org,
    refs_pad, the slot table) and cross4 written once at the HBM rate,
    against 2*R*n_off*H*W operations at the CUDA cores' rate."""
    nbytes = 4 * (H * W + R * (H + 2 * sr) * (W + 2 * sr) + (2 * sr + 1) ** 2
                  + R * n_off * (H // 4) * (W // 4))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * R * n_off * H * W / CUDA_CORE_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(seed: int):
    """cross_cells against its plain version (exact int32 equality) at the
    main path's shapes and the search's other options; device time of one
    launch (torch.profiler), the wrapper's call time, the plain version's."""
    import torch
    from h264tpu_torch.ops import fractal as F
    rng = np.random.default_rng(seed + 1)
    rows = {}
    for name, H, W, sr, R, mode in KERNEL_CASES:
        org, refs_pad = cross_cells_inputs(rng, H, W, sr, R,
                                           name in HALO_CASES)
        offs_np = F.candidate_offsets(sr, mode)
        offs, slots = F.offset_tables(offs_np, sr, "cuda")
        got = F.cross_cell_sums(org, refs_pad, offs, sr, slots)
        want = F.cross_cell_sums_reference(org, refs_pad, offs, sr)
        torch.cuda.synchronize()
        check(got.shape == want.shape,
              f"cross_cells shape {tuple(got.shape)} at {name}")
        err = int((got - want).abs().max())
        check(err == 0, f"cross_cells != plain version at {name}: "
              f"max abs err {err}")
        del want

        def call():
            return F.cross_cell_sums(org, refs_pad, offs, sr, slots)
        ms = kernel_device_ms(call, 20)
        call_ms = cuda_ms(call, 50)
        plain_ms = cuda_ms(
            lambda: F.cross_cell_sums_reference(org, refs_pad, offs, sr), 3, 1)
        n_off = len(offs_np)
        bound_ms, bound_by = cross_cells_bound_ms(H, W, R, sr, n_off)
        rows[name] = dict(ms=ms, wrapper_call_ms=call_ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          max_abs_err=err)
        print(f"[kernel cross_cells {name}] H={H} W={W} sr={sr} R={R} "
              f"mode={mode} n_off={n_off}: exact; device {ms:.4f} ms "
              f"(bound {bound_ms:.4f} ms by {bound_by}, share "
              f"{bound_ms / ms:.3f}); wrapper call {call_ms:.4f} ms; "
              f"plain {plain_ms:.3f} ms", flush=True)
        del got
    return rows


def cif_config(H: int, W: int):
    from h264tpu_torch.utils.config import CodecConfig, FractalConfig
    return CodecConfig(width=W, height=H, qp=24, intra_period=0, deblock=True,
                       fractal=FractalConfig(search_range=7,
                                             use_halfpel_refs=True))


def fractal_codec(H: int, W: int, device: str = "cuda", **kw):
    """The fractal main path's codec (``cif_config``) with config fields
    ``kw`` replaced."""
    import dataclasses
    from h264tpu_torch.models.fractal_codec import FractalCodec
    return FractalCodec(dataclasses.replace(cif_config(H, W), **kw),
                        device=device)


def fractal_decode_check(label: str, stream: bytes, results, masks=None):
    """The port's fractal decoder reproduces the encoder's reconstruction of
    every frame (of every view); returns the decode seconds."""
    from h264tpu_torch.models.fractal_codec import FractalDecoder
    t0 = time.perf_counter()
    decoded = FractalDecoder(device="cuda").decode(stream, masks=masks)
    dec_s = time.perf_counter() - t0
    views = (results, decoded) if not isinstance(results[0], list) else \
        (sum(results, []), sum(decoded, []))
    check(len(views[0]) == len(views[1]), f"{label}: decoder frame count")
    for i, (r, planes) in enumerate(zip(*views)):
        for c in range(3):
            check(np.array_equal(planes[c], r.recon[c]),
                  f"{label}: decoded frame {i} plane {c} != encoder recon")
    return dec_s


# printed stage name -> the codec's span of it
P_STAGES = {"search": "fractal.search", "fractal_recon": "fractal.recon",
            "residual": "fractal.residual", "deblock": "fractal.deblock"}
TILE_STAGES = {k: v.replace("fractal.", "fractal.tile.")
               for k, v in P_STAGES.items()}
CLASSIC_STAGES = {k: "fractal.classic." + k
                  for k in ("full_search", "subpel", "mc_residual", "deblock")}
REGION_STAGES = {"region_search": "fractal.region.search",
                 "region_recon": "fractal.region.recon",
                 "luma_residual": "fractal.region.residual",
                 "chroma_fractal": "fractal.region.chroma"}


def traced(fn):
    """(``fn()``, the records of the codecs' spans made during it): the
    tracer is on for the call alone."""
    from h264tpu_torch import trace
    trace.reset()
    trace.enable()
    try:
        out = fn()
    finally:
        trace.disable()
    recs = trace.records()
    trace.reset()
    return out, recs


def stage_ms(records, stages: dict) -> dict:
    """Device ms of each stage: the spans named ``stages[key]`` summed
    (over planes and tiles)."""
    totals = dict.fromkeys(stages, 0.0)
    for key, name in stages.items():
        ms = [r["device_ms"] for r in records if r["name"] == name]
        check(ms and None not in ms, f"no device span {name}")
        totals[key] = sum(ms)
    return totals


def p_frame_stages(codec, frame, ref, ref2=None):
    """Device ms of each stage of one P frame (fractal, tiled or classic,
    as the codec says), summed over its planes, from the spans the codec
    records; plus the host entropy coding ms of ``finalize_frame``.
    ``ref2`` is a 3-view side view's second reference frame."""
    from h264tpu_torch.models import fractal_codec as FC
    frame = FC._as_planes(frame, codec.device)
    pending, recs = traced(
        lambda: codec.dispatch_frame(frame, ref, 1, ref2=ref2))
    totals = stage_ms(recs, CLASSIC_STAGES if codec.cfg.inter_mode ==
                      "classic" else TILE_STAGES
                      if codec.mesh is not None and ref2 is None
                      else P_STAGES)
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


def steady_p_marks(codec, frames, ref):
    """Host-clock marks of frames[1:] encoded as steady-state P frames,
    pipelined as encode_sequence runs them (frame N's host entropy beside
    frame N+1's device work): the start, then one mark as each frame
    before the last is finalized, then the synchronised end."""
    import torch
    pending, marks = None, [time.perf_counter()]
    for i in range(1, len(frames)):
        disp = codec.dispatch_frame(frames[i], ref, i)
        ref = disp["recs"]
        if pending is not None:
            codec.finalize_frame(pending)
            marks.append(time.perf_counter())
        pending = disp
    codec.finalize_frame(pending)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    return marks


def phase_main_path(seed: int, profile_dir=None):
    import torch
    from h264tpu_torch.models.fractal_codec import FractalCodec
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

    dec_s = fractal_decode_check("cif", stream, results)
    print(f"[cif] decode: bit-exact with the encoder recon, {dec_s:.3f} s",
          flush=True)

    marks = steady_p_marks(codec, frames, results[0].recon_dev)
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
    return launches, stream, float(np.median(gaps))


def phase_1080p(seed: int):
    import torch
    from h264tpu_torch.models.fractal_codec import FractalCodec
    from h264tpu_torch.ops import fractal as F
    H, W = 1088, 1920
    frames = blocky_frames(2, H, W, seed)
    codec = FractalCodec(cif_config(H, W), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    F.cross_cell_sums.launches = 0
    t0 = time.perf_counter()
    i_res, _ = codec.encode_frame(frames[0], None, 0)
    torch.cuda.synchronize()
    i_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p_res, _ = codec.encode_frame(frames[1], i_res.recon_dev, 1)
    torch.cuda.synchronize()
    p_s = time.perf_counter() - t0
    launches = F.cross_cell_sums.launches
    check(np.isfinite(p_res.psnr_y) and p_res.frame_type == "P",
          "1080p P frame failed")
    check(launches > 0, "the 1080p P frame launched cross_cells no time")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[1080p] I frame {i_s:.3f} s (PSNR Y {i_res.psnr_y:.3f}, "
          f"{i_res.bits} bits); P frame {p_s:.3f} s (PSNR Y "
          f"{p_res.psnr_y:.3f}, {p_res.bits} bits); peak device memory "
          f"{peak:.2f} GiB; cross_cells launches {launches}", flush=True)
    stages = p_frame_stages(codec, frames[1], i_res.recon_dev)
    print("[1080p] one P frame by stage (ms): " + json.dumps(
        {k: round(v, 3) for k, v in stages.items()}), flush=True)
    return launches


def phase_card_vs_cpu(seed: int):
    from h264tpu_torch.models.fractal_codec import FractalCodec
    H, W = 144, 176
    frames = blocky_frames(3, H, W, seed)
    cfg = cif_config(H, W)
    _, s_gpu = FractalCodec(cfg, device="cuda").encode_sequence(frames)
    _, s_cpu = FractalCodec(cfg, device="cpu").encode_sequence(frames)
    check(s_gpu == s_cpu, "QCIF stream from the card != stream from the CPU")
    print(f"[qcif] card stream == CPU stream ({len(s_gpu)} bytes)", flush=True)


# bench.py bench_avc: AVCParams(w, h, qp=28, num_ref_frames=1, level_idc=42),
# TPUAVCCodec(p, intra_period=0, search_range=8, n_slices=...)
AVC_QP, AVC_SR = 28, 8


def option_codec(H: int, W: int, n_slices: int, device: str, fields=None,
                 **kw):
    """``bench_avc``'s encoder (QP 28, SR 8, level 4.2) with further
    AVCParams ``fields`` and DeviceAVCCodec options ``kw``."""
    from h264tpu_torch.avc.params import AVCParams
    from h264tpu_torch.avc.device_codec import DeviceAVCCodec
    f = dict(num_ref_frames=1, level_idc=42)
    f.update(fields or {})
    p = AVCParams(width=W, height=H, qp=AVC_QP, **f)
    return DeviceAVCCodec(p, intra_period=0, search_range=AVC_SR,
                          n_slices=n_slices, device=device, **kw)


def avc_codec(H: int, W: int, n_slices: int, device: str,
              high: dict = None):
    """``bench_avc``'s encoder, or with ``high`` (AVCParams fields plus
    ``sub8x8``) the High-profile one of ``tools/bdrate.py`` run_ours:
    AVCParams(profile_idc=100, transform_8x8=True, num_ref_frames=1),
    TPUAVCCodec(search_range=8, sub8x8=True)."""
    from h264tpu_torch.avc.params import AVCParams
    from h264tpu_torch.avc.device_codec import DeviceAVCCodec
    if high is None:
        return option_codec(H, W, n_slices, device)
    high = dict(high)
    sub8x8 = high.pop("sub8x8", False)
    p = AVCParams(width=W, height=H, qp=AVC_QP, num_ref_frames=1,
                  profile_idc=100, **high)
    return DeviceAVCCodec(p, intra_period=0, search_range=AVC_SR,
                          n_slices=n_slices, sub8x8=sub8x8, device=device)


HIGH_BDRATE = dict(transform_8x8=True, sub8x8=True)


class HostStageRecorder:
    """Records, inside ``with``, every call of the native host stages and
    the host symbols of each frame that ``DeviceAVCCodec`` makes (their
    arguments and outputs), for the comparison with the numpy twins, and
    the host ms of each B frame's device encode (``b_ms``, synchronised)."""

    def __enter__(self):
        import torch
        from h264tpu_torch.avc import (native as AN, device_codec as DC,
                                       device_enc as DE)
        self.packs, self.deblocks, self.syms, self.b_ms = [], [], [], []
        self._saved = pack, deblock, host_symbols, enc_b = (
            AN.pack_slice, AN.deblock_frame, DC.host_symbols,
            DE.encode_frame_b)

        def rec_pack(*a, **k):
            out = pack(*a, **k)
            self.packs.append((a, k, out))
            return out

        def rec_deblock(*a):
            out = deblock(*a)
            self.deblocks.append((a, out))
            return out

        def rec_syms(sym, *a):
            out = host_symbols(sym, *a)
            self.syms.append(out)
            return out

        def timed_enc_b(*a, **k):
            t0 = time.perf_counter()
            out = enc_b(*a, **k)
            torch.cuda.synchronize()
            self.b_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        (AN.pack_slice, AN.deblock_frame, DC.host_symbols,
         DE.encode_frame_b) = rec_pack, rec_deblock, rec_syms, timed_enc_b
        return self

    def __exit__(self, *exc):
        from h264tpu_torch.avc import (native as AN, device_codec as DC,
                                       device_enc as DE)
        (AN.pack_slice, AN.deblock_frame, DC.host_symbols,
         DE.encode_frame_b) = self._saved

    def kinds(self):
        """Frame kind per recorded frame in decode order: "B" where the
        symbols carry list-1 fields."""
        return ["B" if "ri0" in s else "I/P" for s in self.syms]

    def frame(self, i: int):
        """(deblock call, native pack calls) of frame ``i``."""
        sym = self.syms[i]
        return (self.deblocks[i],
                [c for c in self.packs if c[0][0] is sym])


def mb_lambda_me(codec, qp):
    """lambda_me of every MB as ``device_enc.search`` passes it to Stages A
    and B: [nmb] float64 on the card, each MB at its slice's QP."""
    from h264tpu_torch.avc import device_enc as DE
    p = codec.p
    qp_l = DE.lane_qp(qp, p.mb_h, codec.n_slices, "cuda")
    return DE.lane_lambdas(qp_l)[1].repeat_interleave(p.mb_w)


def avc_stages(codec, frame, ref_rec, qp=AVC_QP):
    """Device ms of each stage of one P frame (CUDA events around the calls
    ``device_enc.encode_frame`` makes) at ``qp`` (the frame QP or one per
    slice), the second of two runs.  The decision scan's stages come from
    its spans (:func:`scan_stages`): the eager first step, the graph
    replays of the others and ``graph_capture`` between them, during which
    the card waits for the host to capture the step.  ``host_enqueue`` is
    the host clock from the first call to the return of the last, before
    the sync: when it nears the device span, the host has no time left to
    pack a frame while the card works."""
    import torch
    from h264tpu_torch.avc import device_enc as DE
    p, sr = codec.p, codec.sr
    opts = dict(transform8=p.transform_8x8, sub8x8=codec.sub8x8,
                scaling_default=p.scaling_matrix == "default")
    y, u, v = (torch.as_tensor(pl).cuda().to(torch.int32) for pl in frame)
    ups, us, vs = (x[None] for x in DE.prep_ref(
        *(torch.as_tensor(pl).cuda() for pl in ref_rec), sr))
    force = torch.zeros((p.mb_h, p.mb_w), dtype=torch.bool, device="cuda")
    lam_me = mb_lambda_me(codec, qp)

    def run():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        t0 = time.perf_counter()
        ev[0].record()
        mv_int, _, pmv2 = DE._integer_search(
            y, ups[:, 0, 0].to(torch.int32), sr, lam_me.reshape(1, 1, 1, -1),
            band_rows=p.mb_h // codec.n_slices, sub8x8=codec.sub8x8)
        ev[1].record()
        mv_q, sad_q = DE._subpel_refine(y, ups, mv_int, pmv2, sr,
                                        lam_me.reshape(1, -1, 1),
                                        sub8x8=codec.sub8x8)
        ev[2].record()
        sym, st = DE.decide(y, u, v, ups, us, vs, mv_q.permute(2, 0, 1, 3),
                            sad_q.permute(2, 0, 1), qp, 1, force, sr=sr,
                            sb_h=p.mb_h // codec.n_slices, intra_only=False,
                            **opts)
        ev[3].record()
        DE.prep_ref(*DE.assemble(sym, st, p.mb_h, p.mb_w)[0], sr)
        ev[4].record()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[4].synchronize()
        return ev, host_ms

    run()
    (ev, host_ms), recs = traced(run)
    return {"stage_a_search": ev[0].elapsed_time(ev[1]),
            "stage_b_subpel": ev[1].elapsed_time(ev[2]),
            **scan_stages(recs, ev[2].elapsed_time(ev[3])),
            "prep_ref": ev[3].elapsed_time(ev[4]),
            "device_total": ev[0].elapsed_time(ev[4]),
            "host_enqueue": host_ms}


def scan_stages(records, decide_ms: float) -> dict:
    """The decision scan's stages from its spans: the eager first step, the
    graph capture (the card waits for the host) and the replays; the scan
    is the whole ``decide`` call (``decide_ms``) less the capture."""
    got = stage_ms(records, {"decision_first_step": "avc.scan.eager",
                             "graph_capture": "avc.scan.capture",
                             "decision_replays": "avc.scan.replay"})
    return {"decision_scan": decide_ms - got["graph_capture"], **got}


def avc_profile(codec, frame, ref_rec, profile_dir=None):
    """(kernel launches, summed kernel ms) of one device P-frame encode from
    torch.profiler's device events; summed ms is None when the profiler
    records no device time."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    from h264tpu_torch.avc import device_enc as DE
    refs = [DE.prep_ref(*(torch.as_tensor(pl).cuda() for pl in ref_rec),
                        codec.sr)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        codec.encode_frame(frame, refs, AVC_QP)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        with open(os.path.join(profile_dir, "avc_pframe_profile_cif.txt"),
                  "w") as f:
            f.write(events.table(sort_by="self_device_time_total",
                                 row_limit=40))
    return sum(e.count for e in kernels), (dev_us / 1e3 if dev_us else None)


def phase_avc_cif(seed: int, profile_dir=None, trace: bool = False):
    import torch
    from h264tpu_torch.avc.slice_dec import AVCDecoder
    H, W, n = 288, 352, 5
    frames = blocky_frames(n, H, W, seed)
    codec = avc_codec(H, W, 9, "cuda")
    codec.encode_sequence(frames[:2])                  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    codec.encode_sequence(frames[:1])
    torch.cuda.synchronize()
    idr_s = time.perf_counter() - t0
    codec.host_ms = dict(pack=[], deblock=[])
    with HostStageRecorder() as rec:
        t0 = time.perf_counter()
        results, stream = codec.encode_sequence(frames)
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t0
    check([r.frame_type for r in results] == ["IDR"] + ["P"] * (n - 1),
          "unexpected AVC frame types")
    for i, r in enumerate(results):
        print(f"[avc cif] frame {i} {r.frame_type} bits {r.bits} "
              f"PSNR-Y {r.psnr_y:.3f}", flush=True)
        check(np.isfinite(r.psnr_y) and r.bits > 0, f"AVC frame {i} failed")
    t0 = time.perf_counter()
    decoded = AVCDecoder().decode(stream)
    dec_s = time.perf_counter() - t0
    check(len(decoded) == n, "AVC decoder returned a wrong frame count")
    for i, (r, planes) in enumerate(zip(results, decoded)):
        for c in range(3):
            check(np.array_equal(planes[c], r.recon[c]),
                  f"AVC decoded frame {i} plane {c} != encoder recon")
    p_fps = (n - 1) / (seq_s - idr_s)
    bits = [r.bits for r in results]
    print(f"[avc cif] 1 IDR + {n - 1} P: {seq_s:.3f} s, stream {len(stream)} "
          f"bytes; decode bit-exact with the encoder recon in {dec_s:.3f} s",
          flush=True)
    print(f"[avc cif] steady-state P frames {p_fps:.3f} fps (host clock, "
          f"synchronised; (1 IDR + {n - 1} P) - (1 IDR) runs); "
          f"{sum(bits) / n * 30 / 1e3:.3f} kbps at 30 fps over all frames, "
          f"{np.mean(bits[1:]) * 30 / 1e3:.3f} kbps for P frames", flush=True)
    print("[avc cif] host ms per P frame: pack "
          f"{np.mean(codec.host_ms['pack'][1:]):.1f}, deblock "
          f"{np.mean(codec.host_ms['deblock'][1:]):.1f}", flush=True)
    stages = avc_stages(codec, frames[1], results[0].recon)
    print("[avc cif] one P frame by stage, ms between CUDA events: " + json.dumps(
        {k: round(v, 3) for k, v in stages.items()}), flush=True)
    if not trace:
        return rec, results, stream
    t0 = time.perf_counter()
    launches, dev_ms = avc_profile(codec, frames[1], results[0].recon,
                                   profile_dir)
    busy = "not measured" if dev_ms is None else \
        f"{dev_ms:.3f} ms, busy share {dev_ms * p_fps / 1e3:.4f} of the " \
        f"{1e3 / p_fps:.1f} ms steady-state frame"
    print(f"[avc cif] one P frame: {launches} kernel launches, summed kernel "
          f"time {busy} (torch.profiler, {time.perf_counter() - t0:.1f} s "
          f"to trace)", flush=True)
    return rec, results, stream


def phase_avc_card_vs_cpu(seed: int):
    H, W = 144, 176
    frames = blocky_frames(3, H, W, seed)
    _, s_gpu = avc_codec(H, W, 3, "cuda").encode_sequence(frames)
    _, s_cpu = avc_codec(H, W, 3, "cpu").encode_sequence(frames)
    check(s_gpu == s_cpu, "AVC QCIF stream from the card != stream from the CPU")
    print(f"[avc qcif] card stream == CPU stream ({len(s_gpu)} bytes)",
          flush=True)


def phase_avc_1080p(seed: int):
    import torch
    H, W = 1088, 1920
    frames = blocky_frames(2, H, W, seed)
    codec = avc_codec(H, W, 17, "cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results, stream = codec.encode_sequence(frames)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    check([r.frame_type for r in results] == ["IDR", "P"]
          and all(np.isfinite(r.psnr_y) for r in results),
          "AVC 1080p encode failed")
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, r in enumerate(results):
        print(f"[avc 1080p] frame {i} {r.frame_type} bits {r.bits} "
              f"PSNR-Y {r.psnr_y:.3f}", flush=True)
    print(f"[avc 1080p] 1 IDR + 1 P encode {seq_s:.3f} s, stream "
          f"{len(stream)} bytes, peak device memory {peak:.3f} GiB; host ms: "
          f"pack {codec.host_ms['pack']}, deblock {codec.host_ms['deblock']}",
          flush=True)
    stages = avc_stages(codec, frames[1], results[0].recon)
    print("[avc 1080p] one P frame by stage, ms between CUDA events: " + json.dumps(
        {k: round(v, 3) for k, v in stages.items()}), flush=True)


def mb_counts(sym):
    """(MBs with the 8x8 transform, sub-partitioned P_8x8 MBs) of a frame's
    host symbols."""
    t8 = int(np.asarray(sym["t8"]).sum()) if "t8" in sym else 0
    sub = 0
    if "sub" in sym:
        sub = int(((np.asarray(sym["win"]) == 7)
                   & (np.asarray(sym["sub"]) > 0).any(-1)).sum())
    return t8, sub


def phase_avc_high_cif(seed: int, profile_dir=None, trace: bool = False):
    """The tools/bdrate.py configuration at CIF, one slice, uncut."""
    import torch
    from h264tpu_torch.avc.slice_dec import AVCDecoder
    H, W, n = 288, 352, 5
    frames = smooth_frames(n, H, W, seed)
    codec = avc_codec(H, W, 1, "cuda", HIGH_BDRATE)
    codec.encode_sequence(frames[:2])                  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    codec.encode_sequence(frames[:1])
    torch.cuda.synchronize()
    idr_s = time.perf_counter() - t0
    codec.host_ms = dict(pack=[], deblock=[])
    with HostStageRecorder() as rec:
        t0 = time.perf_counter()
        results, stream = codec.encode_sequence(frames)
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t0
    check([r.frame_type for r in results] == ["IDR"] + ["P"] * (n - 1),
          "unexpected AVC High frame types")
    counts = [mb_counts(s) for s in rec.syms]
    for i, (r, (t8, sub)) in enumerate(zip(results, counts)):
        print(f"[avc high cif] frame {i} {r.frame_type} bits {r.bits} "
              f"PSNR-Y {r.psnr_y:.3f} t8 MBs {t8} sub-partitioned P8x8 "
              f"MBs {sub}", flush=True)
        check(np.isfinite(r.psnr_y) and r.bits > 0,
              f"AVC High frame {i} failed")
    check(any(t8 > 0 for t8, _ in counts[1:]),
          "no P frame chose the 8x8 transform")
    check(any(sub > 0 for _, sub in counts[1:]),
          "no P frame chose a sub-partitioned P8x8")
    t0 = time.perf_counter()
    decoded = AVCDecoder().decode(stream)
    dec_s = time.perf_counter() - t0
    check(len(decoded) == n, "AVC High decoder returned a wrong frame count")
    for i, (r, planes) in enumerate(zip(results, decoded)):
        for c in range(3):
            check(np.array_equal(planes[c], r.recon[c]),
                  f"AVC High decoded frame {i} plane {c} != encoder recon")
    p_fps = (n - 1) / (seq_s - idr_s)
    bits = [r.bits for r in results]
    print(f"[avc high cif] 1 IDR + {n - 1} P: {seq_s:.3f} s, stream "
          f"{len(stream)} bytes; decode bit-exact with the encoder recon in "
          f"{dec_s:.3f} s", flush=True)
    print(f"[avc high cif] steady-state P frames {p_fps:.3f} fps (host "
          f"clock, synchronised; (1 IDR + {n - 1} P) - (1 IDR) runs); "
          f"{sum(bits) / n * 30 / 1e3:.3f} kbps at 30 fps over all frames",
          flush=True)
    print("[avc high cif] host ms per P frame: pack (numpy: sub-8x8) "
          f"{np.mean(codec.host_ms['pack'][1:]):.1f}, native deblock "
          f"{np.mean(codec.host_ms['deblock'][1:]):.1f}; IDR: native pack "
          f"{codec.host_ms['pack'][0]:.1f}, native deblock "
          f"{codec.host_ms['deblock'][0]:.1f}", flush=True)
    stages = avc_stages(codec, frames[1], results[0].recon)
    print("[avc high cif] one P frame by stage, ms between CUDA events: "
          + json.dumps({k: round(v, 3) for k, v in stages.items()}),
          flush=True)
    if not trace:
        return rec
    t0 = time.perf_counter()
    launches, dev_ms = avc_profile(codec, frames[1], results[0].recon,
                                   profile_dir)
    busy = "not measured" if dev_ms is None else \
        f"{dev_ms:.3f} ms, busy share {dev_ms * p_fps / 1e3:.4f} of the " \
        f"{1e3 / p_fps:.1f} ms steady-state frame"
    print(f"[avc high cif] one P frame: {launches} kernel launches, summed "
          f"kernel time {busy} (torch.profiler, "
          f"{time.perf_counter() - t0:.1f} s to trace)", flush=True)
    return rec


# the two High QCIF configurations: (i) every option of the slice; (ii) the
# 8x8 transform alone, whose P slices the C packer writes
HIGH_QCIF = {"i": dict(transform_8x8=True, sub8x8=True,
                       scaling_matrix="default"),
             "ii": dict(transform_8x8=True)}


def phase_avc_high_card_vs_cpu(seed: int):
    import torch
    H, W = 144, 176
    frames = smooth_frames(3, H, W, seed)
    recs = {}
    for name, high in HIGH_QCIF.items():
        with HostStageRecorder() as rec:
            res, s_gpu = avc_codec(H, W, 3, "cuda", high).encode_sequence(
                frames)
            torch.cuda.synchronize()
        _, s_cpu = avc_codec(H, W, 3, "cpu", high).encode_sequence(frames)
        check(s_gpu == s_cpu, f"AVC High QCIF ({name}) stream from the card "
              "!= stream from the CPU")
        counts = [mb_counts(sy) for sy in rec.syms]
        print(f"[avc high qcif {name}] card stream == CPU stream "
              f"({len(s_gpu)} bytes); bits {[r.bits for r in res]}; (t8, "
              f"sub-partitioned) MBs per frame {counts}", flush=True)
        recs[name] = rec
    return recs


def phase_avc_high_1080p(seed: int):
    import torch
    H, W = 1088, 1920
    frames = smooth_frames(2, H, W, seed)
    codec = avc_codec(H, W, 17, "cuda", dict(HIGH_BDRATE, level_idc=42))
    torch.cuda.reset_peak_memory_stats()
    with HostStageRecorder() as rec:
        t0 = time.perf_counter()
        results, stream = codec.encode_sequence(frames)
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t0
    check([r.frame_type for r in results] == ["IDR", "P"]
          and all(np.isfinite(r.psnr_y) for r in results),
          "AVC High 1080p encode failed")
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, (r, (t8, sub)) in enumerate(zip(results,
                                           map(mb_counts, rec.syms))):
        print(f"[avc high 1080p] frame {i} {r.frame_type} bits {r.bits} "
              f"PSNR-Y {r.psnr_y:.3f} t8 MBs {t8} sub-partitioned P8x8 MBs "
              f"{sub}", flush=True)
    print(f"[avc high 1080p] 1 IDR + 1 P encode {seq_s:.3f} s, stream "
          f"{len(stream)} bytes, peak device memory {peak:.3f} GiB; host ms: "
          f"pack {[round(x, 1) for x in codec.host_ms['pack']]}, native "
          f"deblock {[round(x, 1) for x in codec.host_ms['deblock']]}",
          flush=True)
    stages = avc_stages(codec, frames[1], results[0].recon)
    print("[avc high 1080p] one P frame by stage, ms between CUDA events: "
          + json.dumps({k: round(v, 3) for k, v in stages.items()}),
          flush=True)


# bench.py avc_cif_hierb_cabac: AVCParams(352, 288, qp=28, profile_idc=77,
# poc_type=0, num_ref_frames=3, cabac=True), TPUAVCCodec(intra_period=0,
# search_range=8, n_slices=9, bframes=3, hierarchical=True)
HIERB = dict(profile_idc=77, poc_type=0, num_ref_frames=3, cabac=True)


def b_codec(H: int, W: int, n_slices: int, device: str, fields=HIERB,
            bframes: int = 3, hierarchical: bool = True):
    from h264tpu_torch.avc.params import AVCParams
    from h264tpu_torch.avc.device_codec import DeviceAVCCodec
    p = AVCParams(width=W, height=H, qp=AVC_QP, **fields)
    return DeviceAVCCodec(p, intra_period=0, search_range=AVC_SR,
                          n_slices=n_slices, bframes=bframes,
                          hierarchical=hierarchical, device=device)


def avc_b_stages(codec, frame, rec0, rec1, qp: int):
    """Device ms of each stage of one B frame (CUDA events around the calls
    ``device_enc.encode_frame_b`` makes), the second of two runs, with the
    decision scan split as in :func:`avc_stages`.  The colocated motion is
    all intra (an IDR's), which changes no stage's work."""
    import torch
    from h264tpu_torch.avc import device_enc as DE
    p, sr = codec.p, codec.sr
    mb_h, mb_w = p.mb_h, p.mb_w
    y, u, v = (torch.as_tensor(pl).cuda().to(torch.int32) for pl in frame)
    refs = [tuple(x[None] for x in DE.prep_ref(
        *(torch.as_tensor(pl).cuda() for pl in rec), sr)) for rec in (rec0,
                                                                     rec1)]
    col_mv = torch.zeros((mb_h * 4, mb_w * 4, 2), dtype=torch.int32,
                         device="cuda")
    col_ref = torch.full((mb_h * 4, mb_w * 4), -1, dtype=torch.int32,
                         device="cuda")
    lam_me = mb_lambda_me(codec, qp)
    rows = mb_h // codec.n_slices

    def run():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        t0 = time.perf_counter()
        ev[0].record()
        found = []
        for li, (ups, _, _) in enumerate(refs):
            mv_int, _, pmv2 = DE._integer_search(
                y, ups[:, 0, 0].to(torch.int32), sr,
                lam_me.reshape(1, 1, 1, -1), band_rows=rows, only16=True)
            ev[1 + 2 * li].record()
            mv_q, sad_q = DE._subpel_refine(y, ups, mv_int, pmv2, sr,
                                            lam_me.reshape(1, -1, 1),
                                            only16=True)
            ev[2 + 2 * li].record()
            found += [mv_q[:, 0].permute(1, 0, 2), sad_q[:, 0].permute(1, 0)]
        sym, st = DE.decide_b(y, u, v, refs[0], refs[1], *found, col_mv,
                              col_ref, qp, 1, 1, sr=sr, sb_h=rows)
        ev[5].record()
        DE.prep_ref(*DE.assemble_b(sym, st, mb_h, mb_w)[0], sr)
        ev[6].record()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[6].synchronize()
        return ev, host_ms

    run()
    (ev, host_ms), recs = traced(run)
    return {"stage_a_search_l0": ev[0].elapsed_time(ev[1]),
            "stage_b_subpel_l0": ev[1].elapsed_time(ev[2]),
            "stage_a_search_l1": ev[2].elapsed_time(ev[3]),
            "stage_b_subpel_l1": ev[3].elapsed_time(ev[4]),
            **scan_stages(recs, ev[4].elapsed_time(ev[5])),
            "prep_ref": ev[5].elapsed_time(ev[6]),
            "device_total": ev[0].elapsed_time(ev[6]),
            "host_enqueue": host_ms}


def b_profile(codec, frame, rec0, rec1, qp: int):
    """(kernel launches, summed kernel ms) of one device B-frame encode from
    torch.profiler's device events; summed ms is None when the profiler
    records no device time."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    from h264tpu_torch.avc import device_enc as DE
    p, sr = codec.p, codec.sr
    refs = [DE.prep_ref(*(torch.as_tensor(pl).cuda() for pl in rec), sr)
            for rec in (rec0, rec1)]
    y, u, v = codec.planes(frame)
    h4, w4 = p.mb_h * 4, p.mb_w * 4
    col = (torch.zeros((h4, w4, 2), dtype=torch.int32, device="cuda"),
           torch.full((h4, w4), -1, dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        DE.encode_frame_b(y, u, v, *(x[None] for x in refs[0]),
                          *(x[None] for x in refs[1]), *col, qp, 1, 1,
                          mb_h=p.mb_h, mb_w=p.mb_w, sr=sr,
                          n_slices=codec.n_slices)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    return sum(e.count for e in kernels), (dev_us / 1e3 if dev_us else None)


def b_mb_counts(sym):
    """(direct or skip MBs, Bi MBs) of a B frame's host symbols."""
    win = np.asarray(sym["win"])
    return int(((win == 0) | (win == 1)).sum()), int((win == 4).sum())


def phase_avc_hierb_cif(seed: int, trace: bool = False):
    """bench.py's avc_cif_hierb_cabac row on the card, uncut."""
    import torch
    from h264tpu_torch.avc.slice_dec import AVCDecoder
    H, W, n = 288, 352, 9
    frames = smooth_frames(n, H, W, seed)
    codec = b_codec(H, W, 9, "cuda")
    _, warm_stream = codec.encode_sequence(frames[:5])     # warm-up
    torch.cuda.synchronize()
    codec.host_ms = dict(pack=[], deblock=[])
    with HostStageRecorder() as rec:
        t0 = time.perf_counter()
        results, stream = codec.encode_sequence(frames)
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t0
    types = [r.frame_type for r in results]
    check(types == ["IDR", "B", "B", "B", "P", "B", "B", "B", "P"],
          f"unexpected hier-B frame types {types}")
    kinds = rec.kinds()
    b_counts = [b_mb_counts(s) for s, k in zip(rec.syms, kinds) if k == "B"]
    for i, r in enumerate(results):
        print(f"[avc hierb cif] frame {i} {r.frame_type} bits {r.bits} "
              f"PSNR-Y {r.psnr_y:.3f}", flush=True)
        check(np.isfinite(r.psnr_y) and r.bits > 0, f"hier-B frame {i} failed")
    print(f"[avc hierb cif] (direct or skip, Bi) MBs per B frame in decode "
          f"order: {b_counts}", flush=True)
    check(any(d > 0 for d, _ in b_counts), "no B frame chose direct or skip")
    check(any(bi > 0 for _, bi in b_counts), "no B frame chose Bi")
    t0 = time.perf_counter()
    decoded = AVCDecoder().decode(stream)
    dec_s = time.perf_counter() - t0
    check(len(decoded) == n, "hier-B decoder returned a wrong frame count")
    for i, (r, planes) in enumerate(zip(results, decoded)):
        for c in range(3):
            check(np.array_equal(planes[c], r.recon[c]),
                  f"hier-B decoded frame {i} plane {c} != encoder recon")
    bits = [r.bits for r in results]
    pack_b = [ms for ms, k in zip(codec.host_ms["pack"], kinds) if k == "B"]
    dbk_b = [ms for ms, k in zip(codec.host_ms["deblock"], kinds) if k == "B"]
    pack_a = [ms for ms, k in zip(codec.host_ms["pack"], kinds) if k != "B"]
    print(f"[avc hierb cif] 1 IDR + 2 P + 6 B: {seq_s:.3f} s, "
          f"{n / seq_s:.3f} fps (bench.py's len(frames)/seconds), stream "
          f"{len(stream)} bytes, {sum(bits) / n * 30 / 1e3:.3f} kbps at "
          f"30 fps; decode bit-exact with the encoder recon in {dec_s:.3f} s",
          flush=True)
    print(f"[avc hierb cif] per B frame (host clock): device encode "
          f"{np.mean(rec.b_ms):.1f} ms (synchronised), CABAC pack "
          f"{np.mean(pack_b):.1f} ms, native deblock {np.mean(dbk_b):.1f} ms; "
          f"CABAC pack of the IDR and P anchors "
          f"{[round(x, 1) for x in pack_a]} ms", flush=True)
    stages = avc_b_stages(codec, frames[2], results[0].recon,
                          results[4].recon, AVC_QP + 1)
    print("[avc hierb cif] one B frame (the reference B, QP 29) by stage, ms "
          "between CUDA events: " + json.dumps(
              {k: round(v, 3) for k, v in stages.items()}), flush=True)
    if trace:
        t0 = time.perf_counter()
        launches, dev_ms = b_profile(codec, frames[2], results[0].recon,
                                     results[4].recon, AVC_QP + 1)
        busy = "not measured" if dev_ms is None else f"{dev_ms:.3f} ms"
        print(f"[avc hierb cif] one B frame: {launches} kernel launches, "
              f"summed kernel time {busy} (torch.profiler, "
              f"{time.perf_counter() - t0:.1f} s to trace)", flush=True)
    return frames[:5], warm_stream


# the QCIF B configurations of the card-vs-CPU phase: hierarchical-B CABAC in
# 3 slices (5 frames), IbbP CAVLC with bframes=2 (4 frames; the B pictures
# need both anchors in the DPB)
B_QCIF = {"hierb_cabac": (HIERB, 3, True, 5),
          "ibbp_cavlc": (dict(profile_idc=77, poc_type=0, num_ref_frames=2),
                         2, False, 4)}


def phase_avc_b_card_vs_cpu(seed: int):
    H, W = 144, 176
    for name, (fields, bframes, hier, n) in B_QCIF.items():
        frames = smooth_frames(n, H, W, seed)
        streams = {}
        for dev in ("cuda", "cpu"):
            res, streams[dev] = b_codec(H, W, 3, dev, fields, bframes,
                                        hier).encode_sequence(frames)
        check(streams["cuda"] == streams["cpu"],
              f"AVC QCIF {name} stream from the card != stream from the CPU")
        print(f"[avc qcif {name}] card stream == CPU stream "
              f"({len(streams['cuda'])} bytes); types "
              f"{''.join(r.frame_type[0] for r in res)}; bits "
              f"{[r.bits for r in res]}", flush=True)


def phase_avc_hierb_1080p(seed: int):
    import torch
    H, W = 1088, 1920
    frames = blocky_frames(5, H, W, seed)
    codec = b_codec(H, W, 17, "cuda", dict(HIERB, level_idc=42))
    torch.cuda.reset_peak_memory_stats()
    with HostStageRecorder() as rec:
        t0 = time.perf_counter()
        results, stream = codec.encode_sequence(frames)
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t0
    types = [r.frame_type for r in results]
    check(types == ["IDR", "B", "B", "B", "P"]
          and all(np.isfinite(r.psnr_y) for r in results),
          f"AVC hier-B 1080p encode failed: {types}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, r in enumerate(results):
        print(f"[avc hierb 1080p] frame {i} {r.frame_type} bits {r.bits} "
              f"PSNR-Y {r.psnr_y:.3f}", flush=True)
    print(f"[avc hierb 1080p] IDR + GOP of 4 encode {seq_s:.3f} s, stream "
          f"{len(stream)} bytes, peak device memory {peak:.3f} GiB; per "
          f"frame in decode order ({' '.join(rec.kinds())}): CABAC pack ms "
          f"{[round(x, 1) for x in codec.host_ms['pack']]}, native deblock "
          f"ms {[round(x, 1) for x in codec.host_ms['deblock']]}; device "
          f"encode of each B frame (synchronised) "
          f"{[round(x, 1) for x in rec.b_ms]} ms", flush=True)
    stages = avc_stages(codec, frames[4], results[0].recon)
    print("[avc hierb 1080p] the P anchor by stage, ms between CUDA events: "
          + json.dumps({k: round(v, 3) for k, v in stages.items()}),
          flush=True)
    stages = avc_b_stages(codec, frames[2], results[0].recon,
                          results[4].recon, AVC_QP + 1)
    print("[avc hierb 1080p] one B frame (the reference B, QP 29) by stage, "
          "ms between CUDA events: " + json.dumps(
              {k: round(v, 3) for k, v in stages.items()}), flush=True)


def host_ms(fn, reps: int = 3) -> tuple:
    """(output of the first call, least host ms of ``reps`` calls)."""
    out, best = None, float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        y = fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
        out = y if out is None else out
    return out, best


def phase_native_vs_twin(cases):
    """The native deblock, and the native packer wherever it ran, against
    their numpy twins on recorded frames: equal planes and bytes."""
    from h264tpu_torch.avc import native as AN, pack as PK
    from h264tpu_torch.avc.deblock import deblock_frame
    from h264tpu_torch.avc.params import SLICE_I
    for label, rec, i in cases:
        (args, out), packs = rec.frame(i)
        nat, nat_ms = host_ms(lambda: AN.deblock_frame(*args))
        twin, twin_ms = host_ms(lambda: deblock_frame(*args), 1)
        for a, b, c in zip(out, nat, twin):
            check(np.array_equal(a, b) and np.array_equal(a, c),
                  f"native deblock != numpy deblock on {label}")
        msg = (f"deblock equal, native {nat_ms:.2f} ms vs numpy "
               f"{twin_ms:.1f} ms")
        if packs:
            def numpy_pack():
                outs = []
                for (sym, p, st, qp, fn, idr, pic_id, nref), kw, _ in packs:
                    if st == SLICE_I:
                        outs.append(PK.pack_i_slice(
                            sym, p, qp, frame_num=fn, idr=idr,
                            idr_pic_id=pic_id, **kw))
                    else:
                        outs.append(PK.pack_p_slice(
                            sym, p, qp, frame_num=fn, num_ref=nref, **kw))
                return outs
            nat, nat_ms = host_ms(lambda: [AN.pack_slice(*a, **k)
                                           for a, k, _ in packs])
            twin, twin_ms = host_ms(numpy_pack, 1)
            check([o for _, _, o in packs] == nat == twin,
                  f"native pack != numpy pack on {label}")
            msg += (f"; {len(packs)} slice(s) packed equal, native "
                    f"{nat_ms:.2f} ms vs numpy {twin_ms:.1f} ms")
        else:
            msg += "; packed by the numpy packer on the main path (sub-8x8)"
        print(f"[native vs twin] {label}: {msg}", flush=True)


# ---------------------------------------------------------------------------
# the IPPP options: explicit WP, rate control, data partitioning
# ---------------------------------------------------------------------------

def fade_frames(n: int, H: int, W: int, seed: int, step: int = 6):
    """The blocky frames with an additive luma fade: +``step`` per frame,
    clipped."""
    return [(np.clip(y.astype(np.int64) + step * i, 0, 255).astype(np.uint8),
             u, v) for i, (y, u, v) in enumerate(blocky_frames(n, H, W, seed))]


def banded_frames(n: int, H: int, W: int, seed: int):
    """The blocky frames with the top third of the luma flat (128), so the
    row-band slices differ in activity, as ``tests/test_tpu_avc.py``'s
    basic-unit rate-control test makes its frames."""
    out = []
    for y, u, v in blocky_frames(n, H, W, seed):
        y = y.copy()
        y[:H // 3] = 128
        out.append((y, u, v))
    return out


class FrameArgs:
    """Records, inside ``with``, the QP (frame or per slice) and the WP table
    that ``codec.encode_frame`` is called with for each frame."""

    def __init__(self, codec):
        self.codec, self.qps, self.wps = codec, [], []

    def __enter__(self):
        enc = self.codec.encode_frame

        def rec(yuv, refs, qp, *a, **k):
            self.qps.append(qp)
            self.wps.append(k.get("wp"))
            return enc(yuv, refs, qp, *a, **k)

        self.codec.encode_frame = rec
        return self

    def __exit__(self, *exc):
        del self.codec.encode_frame


def decode_check(label: str, stream: bytes, results):
    """The port's decoder reproduces the encoder's reconstruction."""
    from h264tpu_torch.avc.slice_dec import AVCDecoder
    t0 = time.perf_counter()
    decoded = AVCDecoder().decode(stream)
    dec_s = time.perf_counter() - t0
    check(len(decoded) == len(results), f"{label}: decoder frame count")
    for i, (r, planes) in enumerate(zip(results, decoded)):
        for c in range(3):
            check(np.array_equal(planes[c], r.recon[c]),
                  f"{label}: decoded frame {i} plane {c} != encoder recon")
    return dec_s


def host_pack_ms(codec) -> str:
    """Mean host ms per P frame of the last sequence's packer and deblock."""
    return (f"host ms per P frame: pack {np.mean(codec.host_ms['pack'][1:]):.1f}, "
            f"deblock {np.mean(codec.host_ms['deblock'][1:]):.1f}")


def timed_sequence(codec, frames, **kw):
    """(results, stream, seconds of the whole sequence, steady-state P fps)
    on the host clock, synchronised: a warm encode of two frames, then
    (1 IDR + n P) - (1 IDR); ``kw`` (a ``rate_control`` factory) goes to
    every run."""
    import torch

    def run(fr):
        args = {k: f() for k, f in kw.items()}
        t0 = time.perf_counter()
        out = codec.encode_sequence(fr, **args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    run(frames[:2])
    _, idr_s = run(frames[:1])
    codec.host_ms = dict(pack=[], deblock=[])
    (results, stream), seq_s = run(frames)
    return results, stream, seq_s, (len(frames) - 1) / (seq_s - idr_s)


WP_FIELDS = dict(profile_idc=77, weighted_pred=True, num_ref_frames=2)


def phase_avc_wp_cif(seed: int):
    """Explicit WP at bench_avc's CIF settings (9 slices), Main, CAVLC, two
    references, on an additive fade, with both estimators."""
    H, W, n = 288, 352, 5
    frames = fade_frames(n, H, W, seed)
    for method in ("dc", "lms"):
        codec = option_codec(H, W, 9, "cuda", WP_FIELDS, wp_method=method)
        with FrameArgs(codec) as fa:
            results, stream, seq_s, p_fps = timed_sequence(codec, frames)
        label = f"avc cif wp {method}"
        check([r.frame_type for r in results] == ["IDR"] + ["P"] * (n - 1),
              f"{label}: unexpected frame types")
        dec_s = decode_check(label, stream, results)
        w0 = [None if w is None else w["l0"][0][:2] for w in fa.wps[-n:]]
        check(any(w not in (None, (32, 0)) for w in w0),
              f"{label}: every reference 0 luma weight was the default")
        print(f"[{label}] bits {[r.bits for r in results]}, PSNR-Y "
              f"{[round(r.psnr_y, 3) for r in results]}; reference 0 luma "
              f"(weight, offset) per frame {w0}; decode bit-exact in "
              f"{dec_s:.3f} s; 1 IDR + {n - 1} P {seq_s:.3f} s, steady-state "
              f"P {p_fps:.3f} fps; {host_pack_ms(codec)}", flush=True)


def fixed_qp_bps(codec, frames) -> float:
    """The rate budget of a rate-control phase: the mean P-frame bits of a
    fixed-QP encode of ``frames`` (QP 28) at 30 frames/s, so that the
    controller's QPs stay near 28 where the slices' activities split
    them."""
    results, _ = codec.encode_sequence(frames)
    return float(np.mean([r.bits for r in results[1:]])) * 30.0


def slice_qps_of(qp, n_slices: int) -> list:
    return [int(qp)] * n_slices if isinstance(qp, (int, np.integer)) \
        else [int(q) for q in qp]


def phase_avc_rc_cif(seed: int):
    """Quadratic rate control at the CIF settings: rc_mode 1 (one QP per
    frame), then rc_mode 3 with the 9 slices as basic units."""
    from h264tpu_torch.models.ratectl import QuadraticRateControl
    H, W, n = 288, 352, 6
    frames = banded_frames(n, H, W, seed)
    bps = fixed_qp_bps(option_codec(H, W, 9, "cuda"), frames[:3])
    for mode in (1, 3):
        codec = option_codec(H, W, 9, "cuda")

        def controller():
            return QuadraticRateControl(bps, 30.0, AVC_QP, rc_mode=mode)

        with FrameArgs(codec) as fa:
            results, stream, seq_s, p_fps = timed_sequence(
                codec, frames, rate_control=controller)
        label = f"avc cif rc_mode {mode}"
        check([r.frame_type for r in results] == ["IDR"] + ["P"] * (n - 1),
              f"{label}: unexpected frame types")
        dec_s = decode_check(label, stream, results)
        sq = [slice_qps_of(q, 9) for q in fa.qps[-n:]]
        split = sum(len(set(q)) > 1 for q in sq)
        check(split == 0 if mode == 1 else split >= 1,
              f"{label}: {split} frames with more than one slice QP")
        budget = bps / 30.0
        print(f"[{label}] QP per frame {fa.qps[-n:]} (rc_mode 3: per "
              f"slice, the frame QP their rounded mean); bits {[r.bits for r in results]} against "
              f"{budget:.0f} a frame (frames 1-2 at fixed QP 28; the P "
              f"frames here {np.mean([r.bits for r in results[1:]]) / budget:.3f} "
              f"of it); "
              f"decode bit-exact in {dec_s:.3f} s; 1 IDR + {n - 1} P "
              f"{seq_s:.3f} s, steady-state P {p_fps:.3f} fps; "
              f"{host_pack_ms(codec)}", flush=True)


def force_row_in_frame2(mb_h: int, mb_w: int, row: int):
    def force(idx):
        if idx != 2:
            return None
        m = np.zeros((mb_h, mb_w), bool)
        m[row] = True
        return m
    return force


def phase_avc_dp_cif(seed: int):
    """Data partitioning (Extended profile) at the CIF settings, with a
    forced-intra MB row in frame 2 so that a partition B carries residual."""
    from h264tpu_torch.bitstream.nal import annexb_parse
    H, W, n = 288, 352, 5
    frames = blocky_frames(n, H, W, seed)
    codec = option_codec(H, W, 9, "cuda", dict(profile_idc=88),
                         data_partitioning=True)
    force = force_row_in_frame2(H // 16, W // 16, 5)
    results, stream, seq_s, p_fps = timed_sequence(
        codec, frames, force_intra=lambda: force)
    nals = list(annexb_parse(stream))
    count = {t: sum(x.nal_type == t for x in nals) for t in (2, 3, 4, 5)}
    check(count[2] == count[3] == count[4] == 9 * (n - 1),
          f"avc cif dp: NAL types {count}")
    b_bytes = max(len(x.rbsp) for x in nals if x.nal_type == 3)
    check(b_bytes > 1, "avc cif dp: every partition B is empty")
    dec_s = decode_check("avc cif dp", stream, results)
    print(f"[avc cif dp] NAL units by type {count}, largest partition B "
          f"{b_bytes} bytes; bits {[r.bits for r in results]}; decode "
          f"bit-exact in {dec_s:.3f} s; 1 IDR + {n - 1} P {seq_s:.3f} s, "
          f"steady-state P {p_fps:.3f} fps; {host_pack_ms(codec)} (the "
          f"numpy packer writes the partitions)", flush=True)


def phase_avc_options_card_vs_cpu(seed: int):
    """QCIF in 3 slices, card stream == CPU stream: WP (LMS), rate control
    rc_mode 3, data partitioning."""
    from h264tpu_torch.models.ratectl import QuadraticRateControl
    H, W = 144, 176
    cases = {"wp_lms": (fade_frames(4, H, W, seed), WP_FIELDS,
                        dict(wp_method="lms"), False),
             "rc_mode3": (banded_frames(5, H, W, seed), {}, {}, True),
             "dp": (blocky_frames(4, H, W, seed), dict(profile_idc=88),
                    dict(data_partitioning=True), False)}
    for name, (frames, fields, kw, rc) in cases.items():
        out = {}
        for dev in ("cuda", "cpu"):
            ctl = QuadraticRateControl(300_000.0, 30.0, AVC_QP, rc_mode=3) \
                if rc else None
            out[dev] = option_codec(H, W, 3, dev, fields, **kw
                                    ).encode_sequence(frames,
                                                      rate_control=ctl)
        (res, s_gpu), (_, s_cpu) = out["cuda"], out["cpu"]
        streams = dict(cuda=s_gpu, cpu=s_cpu)
        check(s_gpu == s_cpu,
              f"AVC QCIF {name} stream from the card != stream from the CPU")
        decode_check(f"avc qcif {name}", s_gpu, res)
        print(f"[avc qcif {name}] card stream == CPU stream "
              f"({len(streams['cuda'])} bytes), decoded bit-exactly; bits "
              f"{[r.bits for r in res]}", flush=True)


def phase_avc_rc_1080p(seed: int):
    """rc_mode 3 at 1920x1088 in 17 slices, IDR + 2 P, encode only: the
    second P frame is the first with per-unit MADs to split its QPs by."""
    import torch
    from h264tpu_torch.models.ratectl import QuadraticRateControl
    H, W, n = 1088, 1920, 3
    frames = banded_frames(n, H, W, seed)
    codec = option_codec(H, W, 17, "cuda")
    rc = QuadraticRateControl(fixed_qp_bps(codec, frames[:2]), 30.0, AVC_QP,
                              rc_mode=3)
    torch.cuda.reset_peak_memory_stats()
    with FrameArgs(codec) as fa:
        t0 = time.perf_counter()
        results, _ = codec.encode_sequence(frames, rate_control=rc)
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t0
    check([r.frame_type for r in results] == ["IDR", "P", "P"]
          and all(np.isfinite(r.psnr_y) for r in results),
          "AVC rc_mode 3 1080p encode failed")
    qps = slice_qps_of(fa.qps[-1], 17)
    check(len(set(qps)) > 1, f"avc 1080p rc_mode 3: one slice QP {qps}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[avc 1080p rc_mode 3] IDR + 2 P encode {seq_s:.3f} s, bits "
          f"{[r.bits for r in results]}, peak device memory {peak:.3f} GiB; "
          f"the last P frame's 17 slice QPs {qps}", flush=True)
    stages = avc_stages(codec, frames[2], results[1].recon, qps)
    print("[avc 1080p rc_mode 3] that P frame by stage at its slice QPs, ms "
          "between CUDA events: " + json.dumps(
              {k: round(v, 3) for k, v in stages.items()}), flush=True)


# ---------------------------------------------------------------------------
# the fractal codec's options: classic inter, rate control, containers,
# CABAC and Exp-Golomb residuals, 3-view and region coding, metrics
# ---------------------------------------------------------------------------

def timed_encode(encode, n: int):
    """(encode(n)'s output, its seconds, P-frame interval ms) on the host
    clock, synchronised: encode(1), then encode(n); the interval is
    (t(n) - t(1)) / (n - 1), as ``timed_sequence`` takes it for the AVC
    phases (which warm up first: here phase 3 has warmed the CIF path)."""
    import torch

    def run(k):
        t0 = time.perf_counter()
        out = encode(k)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    _, one_s = run(1)
    out, seq_s = run(n)
    return out, seq_s, (seq_s - one_s) / (n - 1) * 1e3


def stage_json(stages: dict) -> str:
    return json.dumps({k: round(v, 3) for k, v in stages.items()})


def phase_fractal_classic_cif(seed: int):
    """Classic H.264-style inter at the fractal CIF configuration (ME search
    range 16, the config default): 1 I + 4 P, decoded bit-exactly; the
    P-frame interval and one P frame's device stages."""
    H, W = 288, 352
    frames = blocky_frames(5, H, W, seed)
    codec = fractal_codec(H, W, inter_mode="classic")
    (results, stream), seq_s, p_ms = timed_encode(
        lambda k: codec.encode_sequence(frames[:k]), 5)
    check([r.frame_type for r in results] == ["I"] + ["P"] * 4,
          "fractal classic: unexpected frame types")
    dec_s = fractal_decode_check("fractal classic cif", stream, results)
    stages = p_frame_stages(codec, frames[1], results[0].recon_dev)
    print(f"[fractal classic cif] bits {[r.bits for r in results]}, PSNR-Y "
          f"{[round(float(r.psnr_y), 3) for r in results]}; decode "
          f"bit-exact in {dec_s:.3f} s; 1 I + 4 P {seq_s:.3f} s, P-frame "
          f"interval {p_ms:.1f} ms; one P frame's device ms "
          + stage_json(stages), flush=True)


def phase_fractal_rc_cif(seed: int):
    """Rate control at the fractal CIF configuration, 1 I + 5 P: the budget
    is the fixed-QP-24 rate of the same frames at 30 frames/s."""
    H, W, n = 288, 352, 6
    frames = blocky_frames(n, H, W, seed)
    fixed, _ = fractal_codec(H, W).encode_sequence(frames)
    bps = float(np.mean([r.bits for r in fixed[1:]])) * 30.0
    codec = fractal_codec(H, W, rate_control=True, target_bitrate=bps,
                          frame_rate=30.0)
    (results, stream), seq_s, p_ms = timed_encode(
        lambda k: codec.encode_sequence(frames[:k]), n)
    check([r.frame_type for r in results] == ["I"] + ["P"] * (n - 1),
          "fractal rc: unexpected frame types")
    dec_s = fractal_decode_check("fractal rc cif", stream, results)
    budget = bps / 30.0
    p_bits = [r.bits for r in results[1:]]
    print(f"[fractal rc cif] QP per frame {[r.qp for r in results]}; P bits "
          f"{p_bits} against {budget:.0f} a frame (fixed QP 24: "
          f"{[r.bits for r in fixed[1:]]}), mean {np.mean(p_bits) / budget:.3f}"
          f" of it; decode bit-exact in {dec_s:.3f} s; 1 I + {n - 1} P "
          f"{seq_s:.3f} s, P-frame interval {p_ms:.1f} ms (sequential: each "
          f"QP waits for the last frame's bits)", flush=True)


def drop_rtp_frames(stream: bytes, lost) -> bytes:
    """The RTP packet file without the packets of the frame units whose
    index is in ``lost``."""
    from h264tpu_torch.bitstream import nal, rtp
    keep = []
    for p in rtp.read_rtp_file(stream):
        n = nal.nalu_from_bytes(p.payload)
        if n.nal_type != nal.NAL_FVC_FRAME or \
                ((n.rbsp[0] << 8) | n.rbsp[1]) not in lost:
            keep.append(p)
    return rtp.write_rtp_file(keep)


def phase_fractal_containers_cif(seed: int):
    """Annex-B and RTP at the fractal CIF configuration, 1 I + 3 P each,
    decoded bit-exactly; RTP with frame 2's packet dropped: frames 0-1
    exact, frame 2 a copy of frame 1."""
    from h264tpu_torch.models.fractal_codec import FractalDecoder
    H, W = 288, 352
    frames = blocky_frames(4, H, W, seed)
    for kind in ("annexb", "rtp"):
        codec = fractal_codec(H, W, container=kind)
        (results, stream), _, p_ms = timed_encode(
            lambda k: codec.encode_sequence(frames[:k]), 4)
        check(FractalDecoder.detect_container(stream) == kind,
              f"fractal {kind}: container not detected")
        dec_s = fractal_decode_check(f"fractal {kind} cif", stream, results)
        print(f"[fractal {kind} cif] {len(stream)} bytes, P-frame interval "
              f"{p_ms:.1f} ms, decode bit-exact in {dec_s:.3f} s", flush=True)
    damaged = drop_rtp_frames(stream, (2,))
    dec = FractalDecoder(device="cuda").decode(damaged)
    want = [r.recon for r in results]
    check(len(dec) == 4, "fractal rtp loss: decoder frame count")
    for i, j in ((0, 0), (1, 1), (2, 1)):
        check(all(np.array_equal(a, b) for a, b in zip(dec[i], want[j])),
              f"fractal rtp loss: frame {i} != encoder frame {j}")
    print(f"[fractal rtp cif loss] frame 2's packet dropped ({len(stream)} -> "
          f"{len(damaged)} bytes): frames 0-1 exact, frame 2 concealed by a "
          f"copy of frame 1, frame 3 decoded from it", flush=True)


def phase_fractal_entropy_cif(seed: int):
    """CABAC and Exp-Golomb residuals at the fractal CIF configuration,
    1 I + 3 P each, decoded bit-exactly, with the host entropy ms of a P
    frame."""
    import torch
    from h264tpu_torch.utils.config import EntropyMode
    H, W = 288, 352
    frames = blocky_frames(4, H, W, seed)
    for mode in (EntropyMode.CABAC, EntropyMode.EXP_GOLOMB):
        codec = fractal_codec(H, W, entropy=mode)
        (results, stream), _, p_ms = timed_encode(
            lambda k: codec.encode_sequence(frames[:k]), 4)
        label = f"fractal {mode.name.lower()} cif"
        dec_s = fractal_decode_check(label, stream, results)
        pending = codec.dispatch_frame(frames[1], results[0].recon_dev, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codec.finalize_frame(pending)
        ent_ms = (time.perf_counter() - t0) * 1e3
        print(f"[{label}] bits {[r.bits for r in results]}; P-frame "
              f"interval {p_ms:.1f} ms; decode bit-exact in {dec_s:.3f} s; "
              f"host entropy of one P frame {ent_ms:.1f} ms", flush=True)


def phase_fractal_views_cif(seed: int):
    """3-view coding at the fractal CIF configuration: three views of 1 I +
    3 P, the side views the centre shifted by +-4 pels; every view decodes
    bit-exactly.  Returns the cross_cells launches of the encode."""
    import torch
    from h264tpu_torch.ops import fractal as F
    H, W = 288, 352
    centre = blocky_frames(4, H, W, seed)
    views = [centre] + [[tuple(np.roll(p, s if c == 0 else s // 2, axis=1)
                               for c, p in enumerate(f)) for f in centre]
                        for s in (4, -4)]
    codec = fractal_codec(H, W, views=3)

    def encode(k):
        F.cross_cell_sums.launches = 0
        return codec.encode_sequence_views([v[:k] for v in views])
    (results, stream), seq_s, p_ms = timed_encode(encode, 4)
    launches = F.cross_cell_sums.launches
    check(launches > 0, "the 3-view path launched cross_cells no time")
    dec_s = fractal_decode_check("fractal views3 cif", stream, results)
    stages = p_frame_stages(codec, views[1][1], results[1][0].recon_dev,
                            results[0][1].recon_dev)
    print(f"[fractal views3 cif] bits per view "
          f"{[[r.bits for r in v] for v in results]}; 12 frames in "
          f"{seq_s:.3f} s, interval of a P frame of all three views "
          f"{p_ms:.1f} ms, cross_cells launches {launches} (R = 8 on the "
          f"side views' P planes); decode bit-exact in {dec_s:.3f} s; one "
          f"side view's P frame by stage (ms): " + stage_json(stages),
          flush=True)
    return launches


def square_frames(n: int, H: int, W: int, seed: int, size: int = 96):
    """A textured square moving (2, 3) pels a frame over a still blocky
    background (the region phase's object); chroma a flat square."""
    rng = np.random.default_rng(seed)
    bg = [np.kron(rng.integers(40, 90, (h // 8, w // 8)), np.ones((8, 8)))
          for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    sq = rng.integers(150, 250, (size, size))
    out = []
    for i in range(n):
        y, u = bg[0].copy(), bg[1].copy()
        y0, x0 = 64 + 2 * i, 96 + 3 * i
        y[y0:y0 + size, x0:x0 + size] = sq
        u[y0 // 2:(y0 + size) // 2, x0 // 2:(x0 + size) // 2] = 200
        out.append(tuple(p.astype(np.uint8) for p in (y, u, bg[2])))
    return out


def phase_fractal_region_cif(seed: int):
    """Region coding at the fractal CIF configuration: masks from
    segment_sequence over 7 frames of a textured square over a still
    background (each frame is differenced against frames 3 and 6 ahead, so
    the first 4 masks all hold the object); 1 I + 3 R of those frames,
    decoded with the masks bit-exactly; the region frame's interval and its
    device stages."""
    from h264tpu_torch.models import fractal_codec as FC
    from h264tpu_torch.ops import segment as SG
    H, W = 288, 352
    frames = square_frames(7, H, W, seed)
    t0 = time.perf_counter()
    masks = [m.cpu().numpy() for m in SG.segment_sequence(
        [f[0] for f in frames], "cuda")][:4]
    seg_ms = (time.perf_counter() - t0) * 1e3
    obj = [int((m > 0).sum()) for m in masks]
    check(all(o > 0 for o in obj), f"fractal region: empty masks {obj}")
    codec = fractal_codec(H, W, num_regions=2)
    (results, stream, _), seq_s, p_ms = timed_encode(
        lambda k: codec.encode_sequence_region(frames[:k], masks[:k]), 4)
    check([r.frame_type for r in results] == ["I", "R", "R", "R"],
          "fractal region: unexpected frame types")
    dec_s = fractal_decode_check("fractal region cif", stream, results, masks)
    _, recs = traced(lambda: codec.encode_region_frame(
        FC._as_planes(frames[1], codec.device), results[0].recon_dev,
        masks[1], masks[0]))
    stages = stage_ms(recs, REGION_STAGES)
    print(f"[fractal region cif] segmentation of 7 frames {seg_ms:.1f} ms; "
          f"object pixels per mask {obj}; bits {[r.bits for r in results]}; "
          f"1 I + 3 R {seq_s:.3f} s, region frame interval {p_ms:.1f} ms; "
          f"decode bit-exact in {dec_s:.3f} s; one region frame's device ms "
          + stage_json(stages), flush=True)


def fractal_option_streams(H: int, W: int, seed: int, device: str):
    """{option: stream} of a short sequence per fractal codec option."""
    from h264tpu_torch.utils.config import EntropyMode
    frames = blocky_frames(3, H, W, seed)
    out = {}
    for name, kw in (("classic", dict(inter_mode="classic")),
                     ("rc", dict(rate_control=True, target_bitrate=200000.0)),
                     ("annexb", dict(container="annexb")),
                     ("rtp", dict(container="rtp")),
                     ("cabac", dict(entropy=EntropyMode.CABAC)),
                     ("exp_golomb", dict(entropy=EntropyMode.EXP_GOLOMB))):
        out[name] = fractal_codec(H, W, device, **kw).encode_sequence(
            frames)[1]
    side = [tuple(np.roll(p, 2, axis=1) for p in f) for f in frames]
    out["views3"] = fractal_codec(H, W, device, views=3).encode_sequence_views(
        [frames, side, frames])[1]
    out["region"] = fractal_codec(H, W, device, num_regions=2
                                  ).encode_sequence_region(
        square_frames(3, H, W, seed, 48))[1]
    return out


def phase_fractal_options_card_vs_cpu(seed: int):
    """One short QCIF sequence per fractal codec option: the card's stream
    equals the CPU's byte for byte."""
    H, W = 144, 176
    gpu = fractal_option_streams(H, W, seed, "cuda")
    cpu = fractal_option_streams(H, W, seed, "cpu")
    for name in gpu:
        check(gpu[name] == cpu[name],
              f"fractal QCIF {name} stream from the card != stream from "
              "the CPU")
    print("[fractal qcif options] card stream == CPU stream: " + ", ".join(
        f"{k} {len(v)} bytes" for k, v in gpu.items()), flush=True)


METRICS_RTOL = 1e-12   # tests/test_torch_metrics.py: exact float64 window sums


def phase_metrics(seed: int):
    """frame_metrics of a CIF reconstruction on the card against the same
    call on the CPU."""
    import torch
    from h264tpu_torch.utils.metrics import frame_metrics, ms_ssim
    H, W = 288, 352
    frames = blocky_frames(2, H, W, seed)
    results, _ = fractal_codec(H, W).encode_sequence(frames)
    org, rec = frames[1], results[1].recon
    gpu = frame_metrics(org, rec)        # numpy in: the card by default
    cpu = frame_metrics(org, rec, device="cpu")
    err = max(abs(gpu[k] - cpu[k]) / abs(cpu[k]) for k in cpu)
    check(err <= METRICS_RTOL, f"frame_metrics card vs CPU rel err {err}")
    check(abs(gpu["psnr_y"] - results[1].psnr_y) < 1e-9,
          "frame_metrics PSNR-Y != the encoder's")
    msg = float(ms_ssim(torch.as_tensor(org[0]).cuda(),
                        torch.as_tensor(rec[0]).cuda()))
    print(f"[metrics cif] card == CPU within rel {err:.2e} (bound "
          f"{METRICS_RTOL}): " + json.dumps(
              {k: round(v, 6) for k, v in gpu.items()})
          + f"; MS-SSIM Y {msg:.6f}", flush=True)


# ---------------------------------------------------------------------------
# the last single-card modules: native FVC coders, GOP-parallel encoding,
# loss-aware drift, the legacy still-image codec, MVC stereo
# ---------------------------------------------------------------------------

def phase_fvc_native_vs_twin(seed: int):
    """The native FVC coders (``entropy/native.py``) against their Python
    twins on the levels and intra modes of phase 3's CIF frames 0 (I) and
    1 (P): equal bytes and levels, with both times per frame."""
    from h264tpu_torch.bitstream import nal
    from h264tpu_torch.entropy import cabac_eng, cavlc, native as FN
    from h264tpu_torch.entropy import fractal_syntax as FS
    from h264tpu_torch.entropy.bitio import BitReader, BitWriter
    H, W = 288, 352
    frames = blocky_frames(2, H, W, seed)
    codec = fractal_codec(H, W)
    i_pend = codec.dispatch_frame(frames[0], None, 0)
    i_res, _ = codec.finalize_frame(i_pend)
    p_pend = codec.dispatch_frame(frames[1], i_res.recon_dev, 1)
    _, payload = codec.finalize_frame(p_pend)
    ms = dict.fromkeys(("cavlc_enc", "cavlc_dec", "cabac_enc", "cabac_dec",
                        "intra_modes", "ep"), (0.0, 0.0))

    def add(key, nat_ms, twin_ms):
        ms[key] = (ms[key][0] + nat_ms, ms[key][1] + twin_ms)

    def native_cavlc(zz, cy, cx):
        codes, lens = FN.cavlc_encode_plane(zz, cy, cx)
        w = BitWriter()
        w.raw(codes[lens > 0], lens[lens > 0])
        return w.to_bytes()

    def python_cavlc(zz, cy, cx):
        w = BitWriter()
        cavlc.encode_plane(zz, cy, cx, w)
        return w.to_bytes()

    for label, pend in (("I", i_pend), ("P", p_pend)):
        for i, (ph, pw) in enumerate(pend["dims"]):
            cy, cx = ph // 4, pw // 4
            zz = pend["host"][f"{i}_zz"].numpy()
            data, nat = host_ms(lambda: native_cavlc(zz, cy, cx))
            twin, twin_ms = host_ms(lambda: python_cavlc(zz, cy, cx), 1)
            check(data == twin, f"native CAVLC != Python, {label} plane {i}")
            add("cavlc_enc", nat, twin_ms)
            (lv, _), nat = host_ms(lambda: FN.cavlc_decode_plane(
                data, 8 * len(data), 0, cy, cx))
            tw, twin_ms = host_ms(lambda: cavlc.decode_plane(
                BitReader(data), cy, cx), 1)
            check(np.array_equal(lv, tw) and np.array_equal(lv, zz),
                  f"native CAVLC decode != Python, {label} plane {i}")
            add("cavlc_dec", nat, twin_ms)
            cab, nat = host_ms(lambda: FN.cabac_encode_plane(zz, cy, cx))
            tw, twin_ms = host_ms(lambda: cabac_eng.encode_plane(zz, cy, cx),
                                  1)
            check(cab == tw, f"native CABAC != Python, {label} plane {i}")
            add("cabac_enc", nat, twin_ms)
            lv, nat = host_ms(lambda: FN.cabac_decode_plane(cab, cy, cx))
            tw, twin_ms = host_ms(lambda: cabac_eng.decode_plane(cab, cy, cx),
                                  1)
            check(np.array_equal(lv, tw) and np.array_equal(lv, zz),
                  f"native CABAC decode != Python, {label} plane {i}")
            add("cabac_dec", nat, twin_ms)
            if pend is i_pend:
                modes = pend["host"][f"{i}_modes"].numpy()
                w = BitWriter()
                FS.write_intra_modes(w, modes)
                r = BitReader(w.to_bytes())
                use = r.u_array(cy * cx, 1).astype(bool).reshape(cy, cx)
                rem = r.u_array(int((~use).sum()), 3)
                got, nat = host_ms(lambda: FN.resolve_intra_modes(
                    use, rem, cy, cx))
                tw, twin_ms = host_ms(lambda: FS.resolve_intra_modes_python(
                    use, rem, cy, cx), 1)
                check(np.array_equal(got, tw) and np.array_equal(got, modes),
                      f"native intra modes != Python, plane {i}")
                add("intra_modes", nat, twin_ms)
    ebsp, nat = host_ms(lambda: nal.ep_strip(nal.ep_insert(payload)))
    tw, twin_ms = host_ms(lambda: nal.ep_strip_python(
        nal.ep_insert_python(payload)), 1)
    check(ebsp == tw == payload and nal.ep_insert(payload) ==
          nal.ep_insert_python(payload), "native emulation prevention != "
          "Python")
    add("ep", nat, twin_ms)
    print("[fvc native vs twin] CIF I and P frames, three planes each: equal "
          "bytes and levels; host ms native / Python per frame pair: "
          + json.dumps({k: [round(a, 3), round(b, 1)] for k, (a, b)
                        in ms.items()}), flush=True)


def phase_gop_parallel_cif(seed: int):
    """GOP-parallel fractal encoding at CIF (``GOPEncoder`` with the
    ``gop_workers.fractal_factory`` codec on the card), 8 frames in 2 GOPs
    of 4: sequential, 2 threads, 2 spawned processes.  Each stream equals
    the sequential one; frames/s of each (host clock, process start-up
    included for the processes) and the cross_cells launches of the
    in-process runs.  Returns the threaded run's launches."""
    import functools
    import torch
    from h264tpu_torch.models.gop_parallel import GOPEncoder
    from h264tpu_torch.models.gop_workers import fractal_factory
    from h264tpu_torch.ops import fractal as F
    H, W, n = 288, 352, 8
    frames = blocky_frames(n, H, W, seed)
    fac = functools.partial(fractal_factory, W, H, 24, search_range=7,
                            device="cuda")
    GOPEncoder(fac, 4).encode(frames[:2])                   # warm-up
    out = {}
    for mode, kw in (("sequential", {}), ("threads", dict(workers=2)),
                     ("processes", dict(workers=2, processes=True))):
        torch.cuda.synchronize()
        F.cross_cell_sums.launches = 0
        t0 = time.perf_counter()
        units, stream = GOPEncoder(fac, 4).encode(frames, **kw)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        out[mode] = dict(stream=stream, fps=n / sec,
                         launches=F.cross_cell_sums.launches)
        check(len(units) == 2, f"GOP {mode}: {len(units)} units")
    seq = out["sequential"]["stream"]
    for mode in ("threads", "processes"):
        check(out[mode]["stream"] == seq,
              f"GOP {mode} stream != the sequential stream")
    check(out["sequential"]["launches"] > 0 and out["threads"]["launches"] ==
          out["sequential"]["launches"],
          "the GOP path's cross_cells launches: " + json.dumps(
              {k: v["launches"] for k, v in out.items()}))
    print("[gop cif] 8 frames in 2 GOPs, streams equal ("
          f"{len(seq)} bytes): " + ", ".join(
              f"{k} {v['fps']:.3f} frames/s" for k, v in out.items())
          + f"; cross_cells launches sequential "
          f"{out['sequential']['launches']}, threads "
          f"{out['threads']['launches']} (the processes' are their own)",
          flush=True)
    return out["threads"]["launches"]


def phase_errdo(rec, seed: int):
    """KDecoderSim (K = 8, p 0.1) and MultiHypothesisDrift over phase 5's
    CIF reconstructions (the deblocked luma of 1 IDR + 4 P) and its MB
    intra maps: the card's states and drift equal the CPU's bit for bit;
    ms per step on the card."""
    import torch
    from h264tpu_torch.models import errdo
    H, W = 288, 352
    lumas = [out[0] for _, out in rec.deblocks]
    intra = [np.asarray(s["mb_intra"], bool).reshape(H // 16, W // 16)
             for s in rec.syms]
    check(len(lumas) == 5 and len(intra) == 5, "phase 5's frames")
    sims = {d: (errdo.KDecoderSim(8, 0.1, H, W, seed=seed, device=d),
                errdo.MultiHypothesisDrift(0.1, H, W, device=d))
            for d in ("cuda", "cpu")}
    step_ms = {"kdecoder": [], "mhyp": []}
    for y, mb_intra in zip(lumas, intra):
        for name, sim, arg in (("kdecoder", 0, ()), ("mhyp", 1, (mb_intra,))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = sims["cuda"][sim].step(y, *arg)
            torch.cuda.synchronize()
            step_ms[name].append((time.perf_counter() - t0) * 1e3)
            want = sims["cpu"][sim].step(y, *arg)
            check(np.array_equal(got.cpu().numpy().view(np.int32),
                                 want.numpy().view(np.int32)),
                  f"errdo {name}: card drift != CPU drift")
    check(torch.equal(sims["cuda"][0].sim.cpu(), sims["cpu"][0].sim),
          "KDecoderSim: card states != CPU states")
    check(torch.equal(sims["cuda"][1].exp.cpu(), sims["cpu"][1].exp),
          "MultiHypothesisDrift: card state != CPU state")
    print(f"[errdo cif] K 8, p 0.1, 5 frames: card == CPU (states, drift bit "
          f"for bit); mean drift of the last frame "
          f"{float(got.mean()):.4f}; ms per step on the card (first, then "
          f"median of the rest): " + json.dumps(
              {k: [round(v[0], 3), round(float(np.median(v[1:])), 3)]
               for k, v in step_ms.items()}), flush=True)


def phase_legacy(seed: int):
    """The legacy still-image codec at CIF and 1920x1088, quality 75: the
    card's stream equals the CPU's, the card's and the CPU's decode of it
    are equal, with encode and decode ms on the card."""
    from h264tpu_torch.models import legacy_icodec as LIC
    for H, W in ((288, 352), (1088, 1920)):
        y, u, v = blocky_frames(1, H, W, seed)[0]
        LIC.encode_image(y, u, v, 75)              # warm-up
        t0 = time.perf_counter()
        s_gpu = LIC.encode_image(y, u, v, 75)
        enc_ms = (time.perf_counter() - t0) * 1e3
        s_cpu = LIC.encode_image(y, u, v, 75, device="cpu")
        check(s_gpu == s_cpu, f"legacy {H}x{W}: card stream != CPU stream")
        t0 = time.perf_counter()
        dec = LIC.decode_image(s_gpu)
        dec_ms = (time.perf_counter() - t0) * 1e3
        ref = LIC.decode_image(s_gpu, device="cpu")
        check(all(np.array_equal(a, b) for a, b in zip(dec, ref)),
              f"legacy {H}x{W}: card decode != CPU decode")
        mse = float(np.mean((dec[0].astype(np.float64) - y) ** 2))
        print(f"[legacy {H}x{W}] q75 {len(s_gpu)} bytes, card == CPU, "
              f"decode equal; PSNR-Y {10 * np.log10(255 ** 2 / mse):.3f}; "
              f"card encode {enc_ms:.1f} ms, decode {dec_ms:.1f} ms (host "
              f"entropy included)", flush=True)


def phase_mvc(seed: int):
    """MVC stereo (``MVCStereoCodec``) at CIF in 9 slices, view 1 view 0
    shifted 4 pels, 1 IDR + 3 P pairs: both views decoded bit-exactly by
    ``AVCDecoder.decode_mvc``; then QCIF in 3 slices, 3 pairs, card stream
    == CPU stream."""
    from h264tpu_torch.avc.mvc import MVCStereoCodec
    from h264tpu_torch.avc.params import AVCParams
    from h264tpu_torch.avc.slice_dec import AVCDecoder
    for (H, W, slices), dev in (((288, 352, 9), ("cuda",)),
                                ((144, 176, 3), ("cuda", "cpu"))):
        f0 = blocky_frames(4 if H == 288 else 3, H, W, seed)
        f1 = [tuple(np.roll(pl, -4 if c == 0 else -2, axis=1)
                    for c, pl in enumerate(fr)) for fr in f0]
        p = AVCParams(width=W, height=H, qp=AVC_QP, num_ref_frames=2)
        out = {}
        for d in dev:
            t0 = time.perf_counter()
            out[d] = MVCStereoCodec(p, search_range=8, n_slices=slices,
                                    device=d).encode_sequence(f0, f1)
            out[d] += (time.perf_counter() - t0,)
        res0, res1, stream, enc_s = out["cuda"]
        if "cpu" in out:
            check(stream == out["cpu"][2],
                  f"MVC {H}x{W}: card stream != CPU stream")
        t0 = time.perf_counter()
        views = AVCDecoder().decode_mvc(stream)
        dec_s = time.perf_counter() - t0
        for v, (dec, res) in enumerate(zip(views, (res0, res1))):
            check(len(dec) == len(f0), f"MVC {H}x{W}: view {v} frame count")
            for i, (planes, r) in enumerate(zip(dec, res)):
                check(all(np.array_equal(a, b)
                          for a, b in zip(planes, r.recon)),
                      f"MVC {H}x{W}: view {v} frame {i} != encoder recon")
        print(f"[mvc {H}x{W}] {len(f0)} pairs in {slices} slices: view 0 bits "
              f"{[r.bits for r in res0]}, view 1 bits "
              f"{[r.bits for r in res1]}; both views decoded bit-exactly in "
              f"{dec_s:.3f} s; card encode {enc_s:.3f} s"
              + ("; card stream == CPU stream" if "cpu" in out else ""),
              flush=True)


def card_mesh(n: int, shape, axes):
    """A ``parallel.Mesh`` of ``n`` slots over the cards, slot i on card
    ``i % torch.cuda.device_count()``, with ``shape`` and ``axes``."""
    import torch
    from h264tpu_torch.parallel import Mesh
    count = torch.cuda.device_count()
    devs = [torch.device("cuda", i % count) for i in range(n)]
    return Mesh(np.array(devs, dtype=object).reshape(shape), axes)


def mesh_note(mesh) -> str:
    return (f"{mesh.size} slots on {len(mesh.distinct_devices())} distinct "
            f"card(s)")


def sync_s(fn):
    """(fn's result, host seconds to its return and a synchronise)."""
    import torch
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_fractal_sharded(seed: int):
    """The fractal codec over (1, 3) and (1, 9) meshes at phase 3's CIF
    configuration with tile_rows 9, 1 I + 3 P, and over a (1, 2) mesh at
    1920x1088 with tile_rows 2, 1 I + 1 P: each stream equal to the
    unsharded one at the same tile_rows, the CIF one decoded bit-exactly;
    the P interval of each and the cross_cells launches of each sharded
    run (3 planes x tiles per P frame).  Returns those launches."""
    import torch
    from h264tpu_torch.models.fractal_codec import FractalCodec
    from h264tpu_torch.ops import fractal as F
    H, W = 288, 352
    frames = blocky_frames(4, H, W, seed)
    cfg = dataclasses.replace(cif_config(H, W), tile_rows=9)
    one = FractalCodec(cfg, device="cuda")
    one.encode_sequence(frames[:2])                    # warm-up
    launches, streams = {}, {}
    for tiles in (1, 3, 9):
        mesh = None if tiles == 1 else card_mesh(tiles, (1, tiles),
                                                 ("gop", "tile"))
        codec = one if mesh is None else FractalCodec(cfg, mesh=mesh)
        _, i_s = sync_s(lambda: codec.encode_frame(frames[0], None, 0))
        F.cross_cell_sums.launches = 0
        (results, stream), seq_s = sync_s(
            lambda: codec.encode_sequence(frames))
        n_launch = F.cross_cell_sums.launches
        streams[tiles] = stream
        label = "unsharded" if mesh is None else \
            f"mesh (1, {tiles}), {mesh_note(mesh)}"
        print(f"[fractal sharded cif] {label}: 1 I + 3 P {seq_s:.3f} s, "
              f"P interval {(seq_s - i_s) / 3 * 1e3:.1f} ms "
              f"((t(1 I + 3 P) - t(1 I)) / 3, synchronised), stream "
              f"{len(stream)} bytes, cross_cells launches {n_launch}",
              flush=True)
        check(n_launch == 3 * tiles * 3,
              f"the (1, {tiles}) run launched cross_cells {n_launch} times, "
              f"not {3 * tiles * 3}")
        check(stream == streams[1], f"the (1, {tiles}) stream differs from "
              "the unsharded one at tile_rows 9")
        if mesh is not None:
            launches[f"cif_tiled{tiles}"] = n_launch
        if mesh is not None and len(mesh.distinct_devices()) == 1:
            # CUDA events of one card only: spans across cards do not exist
            stages = p_frame_stages(codec, frames[1], results[0].recon_dev)
            print(f"[fractal sharded cif] (1, {tiles}) one P frame by stage, "
                  "summed over tiles (ms): " + stage_json(stages), flush=True)
    fractal_decode_check("fractal sharded cif", streams[9], results)
    print("[fractal sharded cif] the (1, 3) and (1, 9) streams equal the "
          "unsharded one; decode bit-exact", flush=True)

    H, W = 1088, 1920
    frames = blocky_frames(2, H, W, seed)
    cfg = dataclasses.replace(cif_config(H, W), tile_rows=2)
    mesh = card_mesh(2, (1, 2), ("gop", "tile"))
    out = {}
    for label, codec in (("unsharded", FractalCodec(cfg, device="cuda")),
                         (f"mesh (1, 2), {mesh_note(mesh)}",
                          FractalCodec(cfg, mesh=mesh))):
        F.cross_cell_sums.launches = 0
        (results, stream), seq_s = sync_s(
            lambda: codec.encode_sequence(frames))
        out[label] = stream
        print(f"[fractal sharded 1080p] {label}: 1 I + 1 P {seq_s:.3f} s, "
              f"P PSNR Y {results[1].psnr_y:.3f}, stream {len(stream)} "
              f"bytes, cross_cells launches {F.cross_cell_sums.launches}",
              flush=True)
    launches["1080p_tiled2"] = F.cross_cell_sums.launches
    check(launches["1080p_tiled2"] == 3 * 2,
          f"the 1080p (1, 2) run launched cross_cells "
          f"{launches['1080p_tiled2']} times, not 6")
    check(len(set(out.values())) == 1,
          "the 1080p (1, 2) stream differs from the unsharded one")
    return launches


def phase_avc_sharded(seed: int, hierb_cif):
    """The conformant encoder over 3- and 9-slot "slice" meshes at the
    ``bench.py`` AVC settings (CIF, QP 28, SR 8, 1 ref, 9 slices), 1 IDR +
    2 P, and hierarchical-B CABAC (phase 7's configuration, 5 frames) over
    3 slots: every stream equal to the unsharded one (phase 7's warm-up
    encode of the same 5 frames) and decoded bit-exactly; P fps of each."""
    from h264tpu_torch.avc.device_codec import DeviceAVCCodec
    from h264tpu_torch.avc.slice_dec import AVCDecoder
    H, W = 288, 352
    frames = blocky_frames(3, H, W, seed)
    base = avc_codec(H, W, 9, "cuda")
    streams = {}
    for n in (1, 3, 9):
        codec = base if n == 1 else DeviceAVCCodec(
            base.p, intra_period=0, search_range=AVC_SR, n_slices=9,
            mesh=card_mesh(n, (n,), ("slice",)))
        _, idr_s = sync_s(lambda: codec.encode_sequence(frames[:1]))
        (results, stream), seq_s = sync_s(
            lambda: codec.encode_sequence(frames))
        streams[n] = stream
        label = "unsharded" if n == 1 else \
            f"{n}-slot mesh, {mesh_note(codec.mesh)}"
        print(f"[avc sharded cif] {label}: 1 IDR + 2 P {seq_s:.3f} s, P "
              f"{2 / (seq_s - idr_s):.3f} fps ((1 IDR + 2 P) - (1 IDR) "
              f"runs), stream {len(stream)} bytes", flush=True)
        check(stream == streams[1],
              f"the {n}-slot AVC stream differs from the unsharded one")
    decoded = AVCDecoder().decode(streams[9])
    for i, (r, planes) in enumerate(zip(results, decoded)):
        for c in range(3):
            check(np.array_equal(planes[c], r.recon[c]),
                  f"sharded AVC frame {i} plane {c} != encoder recon")
    print("[avc sharded cif] the 3- and 9-slot streams equal the unsharded "
          "one; decode bit-exact", flush=True)

    frames_b, stream_b = hierb_cif
    codec = DeviceAVCCodec(b_codec(H, W, 9, "cuda").p, intra_period=0,
                           search_range=AVC_SR,
                           n_slices=9, bframes=3, hierarchical=True,
                           mesh=card_mesh(3, (3,), ("slice",)))
    (results, stream), seq_s = sync_s(lambda: codec.encode_sequence(frames_b))
    print(f"[avc sharded hierb cif] 3-slot mesh, {mesh_note(codec.mesh)}: "
          f"IDR + P + 3 B {seq_s:.3f} s ({5 / seq_s:.3f} fps), stream "
          f"{len(stream)} bytes", flush=True)
    check(stream == stream_b, "the 3-slot hier-B stream differs from the "
          "unsharded one")
    decode_check("avc sharded hierb cif", stream, results)


def phase_dryrun(n: int):
    """The port's dry run of every sharded path over an n-slot mesh on the
    card(s)."""
    from h264tpu_torch.parallel.dryrun import dryrun_multichip, mesh_devices
    devs = mesh_devices(n)
    print(f"[dryrun] {n} slots on {len(set(devs))} distinct card(s)",
          flush=True)
    out = dryrun_multichip(n)
    print("[dryrun] " + json.dumps(out), flush=True)


def drop_slice_nal(stream: bytes, index: int) -> bytes:
    """The Annex-B stream without its ``index``-th coded slice NAL."""
    from h264tpu_torch.bitstream import nal
    kept, seen = [], 0
    for u in nal.annexb_parse(stream):
        if u.nal_type in (nal.NAL_SLICE, nal.NAL_IDR):
            seen += 1
            if seen - 1 == index:
                continue
        kept.append(u)
    check(seen > index, f"the stream has no slice NAL {index}")
    return nal.annexb_write(kept)


def phase_concealment(results, stream):
    """Phase 5's CIF 9-slice stream with one slice NAL lost, of the IDR and
    then of a P picture: the port's decoder conceals the lost slice's 44
    MBs (2 MB rows of 22), the pictures before it equal the encoder's
    reconstruction and the concealed one does not; PSNR-Y of each against
    it (the pictures after it predict from the concealed one)."""
    from h264tpu_torch.avc.slice_dec import AVCDecoder
    for label, pic in (("IDR", 0), ("P 2", 2)):
        lossy = drop_slice_nal(stream, pic * 9 + 4)
        dec = AVCDecoder()
        decoded, dec_s = sync_s(lambda: dec.decode(lossy))
        want = [0] * len(results)
        want[pic] = 44
        check(dec.concealed_mbs == want, f"{label} slice lost: concealed "
              f"MBs {dec.concealed_mbs}, not {want}")
        psnrs = []
        for i, (r, planes) in enumerate(zip(results, decoded)):
            mse = ((planes[0].astype(np.float64) - r.recon[0]) ** 2).mean()
            psnrs.append(99.99 if mse == 0 else
                         float(10 * np.log10(255.0 ** 2 / mse)))
            if i <= pic:
                check((mse == 0) == (i < pic), f"{label} slice lost: "
                      f"picture {i} against the encoder recon")
        print(f"[concealment] {label}'s middle slice lost: concealed MBs per "
              f"picture {dec.concealed_mbs}; PSNR-Y against the encoder "
              f"recon {[round(x, 3) for x in psnrs]}; decode {dec_s:.3f} s",
              flush=True)


ENCODER_CFG = """\
# encoder.cfg in JM syntax: phase 3's CIF configuration
InputFile            = "blocky_cif.yuv"   # read by the caller, not mapped
ImageWidth           = 352
ImageHeight          = 288
I_Frame              = 0                  # IPPP
FramesToBeEncoded    = 8
QPFirstFrame         = 24
QPRemainingFrame     = 24
Search_Range         = 7
"""


def write_10bit_444(path: str, frames):
    """4:2:0 frames as 10-bit 4:4:4 planar little-endian: chroma repeated
    2x2, every sample shifted left by 2."""
    with open(path, "wb") as f:
        for y, u, v in frames:
            for pl in (y, np.kron(u, np.ones((2, 2), np.uint8)),
                       np.kron(v, np.ones((2, 2), np.uint8))):
                f.write((pl.astype("<u2") << 2).tobytes())


def phase_cfg_file(seed: int, cif_stream: bytes, cif_p_ms: float):
    """The user's way in: ``encoder.cfg`` + YUV files on disk ->
    ``FractalCodec`` on the card; both files' streams equal phase 3's."""
    import tempfile
    import torch
    from h264tpu_torch.models.fractal_codec import FractalCodec
    from h264tpu_torch.ops import fractal as F
    from h264tpu_torch.utils.config import config_from_cfg
    from h264tpu_torch.utils.input import read_yuv_frame
    from h264tpu_torch.utils.report import SequenceReport
    from h264tpu_torch.utils.yuv import YUVReader, YUVWriter

    H, W = 288, 352
    frames = blocky_frames(8, H, W, seed)
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = os.path.join(tmp, "encoder.cfg")
        with open(cfg_path, "w") as f:
            f.write(ENCODER_CFG)
        cfg = config_from_cfg(cfg_path)
        want = dataclasses.asdict(cif_config(H, W))
        differ = [k for k, v in dataclasses.asdict(cfg).items()
                  if v != want[k]]
        print(f"[cfg] config_from_cfg: {cfg.width}x{cfg.height}, "
              f"{cfg.num_frames} frames, QP {cfg.qp_i}/{cfg.qp}, SR "
              f"{cfg.fractal.search_range}; fields apart from phase 3's "
              f"config (the stream does not read them): {differ}", flush=True)
        check(set(differ) <= {"num_frames", "qp_intra"},
              f"cfg config differs from phase 3's in {differ}")

        p420 = os.path.join(tmp, "blocky_cif.yuv")
        p444 = os.path.join(tmp, "blocky_cif_444_10bit.yuv")
        with YUVWriter(p420) as w:
            for fr in frames:
                w.write(*fr)
        write_10bit_444(p444, frames)
        reader = YUVReader(p420, cfg.width, cfg.height)
        inputs = {
            "420_8bit": [reader.read(i) for i in range(len(reader))],
            "444_10bit": [read_yuv_frame(p444, cfg.width, cfg.height, i,
                                         chroma=444, bit_depth=10)
                          for i in range(cfg.num_frames)]}
        launches = {}
        for label, read in inputs.items():
            check(len(read) == len(frames) and all(
                np.array_equal(a, b) for fa, fb in zip(read, frames)
                for a, b in zip(fa, fb)), f"[cfg] {label}: planes read back "
                "differ from the frames written")
            codec = FractalCodec(cfg, device="cuda")
            codec.encode_sequence(read[:2])            # warm-up, as phase 3
            torch.cuda.synchronize()
            F.cross_cell_sums.launches = 0
            t0 = time.time()
            results, stream = codec.encode_sequence(read)
            torch.cuda.synchronize()
            t1 = time.time()
            launches[label] = F.cross_cell_sums.launches
            check(stream == cif_stream,
                  f"[cfg] {label}: stream differs from phase 3's")
            check(launches[label] == 21, f"[cfg] {label}: "
                  f"{launches[label]} cross_cells launches, not 21")
            dec_s = fractal_decode_check(f"cfg {label}", stream, results)
            marks = steady_p_marks(codec, read, results[0].recon_dev)
            p_ms = float(np.median(np.diff(marks[1:])) * 1e3)
            print(f"[cfg] {label}: stream == phase 3's ({len(stream)} bytes), "
                  f"cross_cells launches {launches[label]}, decode on the "
                  f"card bit-exact in {dec_s:.3f} s; steady-state P interval "
                  f"median {p_ms:.1f} ms (phase 3: {cif_p_ms:.1f} ms)",
                  flush=True)
            rep = SequenceReport(label=f"cfg cif {label}",
                                 frame_rate=cfg.frame_rate, t_start=t0)
            for r in results:
                rep.add(r)
            rep.t_end = t1
            logdat = os.path.join(tmp, "log.dat")
            rep.append_logdat(logdat)
            print("\n".join(f"[cfg] {line}" for line in
                             rep.summary().splitlines()), flush=True)
            with open(logdat) as f:
                print(f"[cfg] log.dat: {f.read().splitlines()[-1]}",
                      flush=True)
    return launches["420_8bit"]


def timed_host_encode(codec, frames):
    """(results, stream, host seconds per frame in coding order): the codec
    pulls frame i + 1 from the iterator right after frame i is coded."""
    stamps = []

    def pull():
        for fr in frames:
            stamps.append(time.perf_counter())
            yield fr

    results, stream = codec.encode_sequence(pull())
    stamps.append(time.perf_counter())
    return results, stream, np.diff(stamps)


def phase_host_avc(seed: int):
    """The host ``AVCCodec`` (and its slice writers), numpy as in the
    reference: CIF at its defaults, then each host-only option at QCIF."""
    from h264tpu_torch.avc import sei as SEI
    from h264tpu_torch.avc.codec import AVCCodec
    from h264tpu_torch.avc.explicit_seq import (encode_explicit_seq,
                                                parse_explicit_seq)
    from h264tpu_torch.avc.params import AVCParams
    from h264tpu_torch.avc.slice_dec import AVCDecoder
    from h264tpu_torch.avc.slice_enc import slice_group_map
    from h264tpu_torch.bitstream.nal import annexb_parse

    H, W = 288, 352
    codec = AVCCodec(AVCParams(width=W, height=H, qp=28))
    results, stream, per = timed_host_encode(codec,
                                             blocky_frames(3, H, W, seed))
    check([r.frame_type for r in results] == ["IDR", "P", "P"],
          "host avc cif: frame types")
    dec_s = decode_check("host avc cif", stream, results)
    print(f"[host avc] CIF Baseline QP 28 SR 16: host s per frame "
          f"{[round(float(x), 3) for x in per]} (I {per[0]:.3f}, P mean "
          f"{np.mean(per[1:]):.3f}); bits {[r.bits for r in results]}, "
          f"PSNR-Y {[round(r.psnr_y, 3) for r in results]}; decoded "
          f"bit-exactly in {dec_s:.3f} s", flush=True)

    H, W, SR = 144, 176, 8
    qcif = blocky_frames(7, H, W, seed)
    main3 = dict(profile_idc=77, poc_type=0, num_ref_frames=2)
    seq_text = ("Sequence {\nFrameCount : 5\n" + "".join(
        f"Frame\n{{\nSeqNumber : {d}\nSliceType : {t}\nIDRPicture : "
        f"{int(d == 0)}\nReference : {int(t != 'B')}\n}}\n"
        for d, t in ((0, "I"), (2, "P"), (1, "B"), (4, "I"), (3, "B")))
        + "}\n")
    # label: (AVCParams fields, AVCCodec arguments, frames, frame types)
    options = {
        "fmo_type0": (dict(slice_groups=2, slice_group_map_type=0),
                      dict(intra_period=1), qcif[:2], ["IDR"] * 2),
        "fmo_type1": (dict(slice_groups=2, slice_group_map_type=1),
                      dict(intra_period=1), qcif[:2], ["IDR"] * 2),
        "lossless": ({}, dict(lossless=True), qcif[:2], ["IDR"] * 2),
        "ibbp": (main3, dict(bframes=2), qcif,
                 ["IDR", "B", "B", "P", "B", "B", "P"]),
        "open_gop": ({}, dict(intra_period=3, open_gop=True), qcif[:4],
                     ["IDR", "P", "P", "I"]),
        "redundant": (dict(redundant_slices=True), {}, qcif[:2],
                      ["IDR", "P"]),
        "umhex": ({}, dict(me_method="umhex"), qcif[:2], ["IDR", "P"]),
        "rd_picture_decision": ({}, dict(rd_picture_decision=True),
                                qcif[:2], ["IDR", "P"]),
        "wp_lms_3refs": (dict(profile_idc=77, weighted_pred=True,
                              num_ref_frames=3), dict(wp_method="lms"),
                         fade_frames(4, H, W, seed), ["IDR"] + ["P"] * 3),
        "explicit_seq": (main3, None, qcif[:5],
                         ["IDR", "B", "P", "B", "I"]),
    }
    streams = {}
    for label, (fields, kw, frames, types) in options.items():
        p = AVCParams(width=W, height=H, qp=28, **fields)
        t0 = time.perf_counter()
        if kw is None:
            results, stream = encode_explicit_seq(
                frames, p, parse_explicit_seq(seq_text), search_range=SR)
        else:
            codec = AVCCodec(p, search_range=SR, **kw)
            results, stream = codec.encode_sequence(frames)
        enc_s = time.perf_counter() - t0
        got = [r.frame_type for r in results]
        check(got == types, f"host avc {label}: frame types {got}")
        dec_s = decode_check(f"host avc {label}", stream, results)
        note = ""
        if label == "lossless":
            check(all(np.array_equal(a, b) for r, fr in zip(results, frames)
                      for a, b in zip(r.recon, fr)),
                  "host avc lossless: recon != source")
            note = "; recon == source"
        if label == "open_gop":
            seis = [SEI.parse_sei_rbsp(u.rbsp) for u in annexb_parse(stream)
                    if u.nal_type == 6]
            rps = [SEI.parse_recovery_point(pl) for msgs in seis
                   for t, pl in msgs if t == SEI.RECOVERY_POINT]
            check(len(rps) == 1 and rps[0]["recovery_frame_cnt"] == 0,
                  f"host avc open GOP: recovery points {rps}")
            note = f"; recovery-point SEI {rps}"
        if label == "rd_picture_decision":
            note = f"; pic_qps {codec.pic_qps}"
        if label == "redundant":
            n_red = sum(1 for u in annexb_parse(stream) if u.nal_type == 1)
            note = f"; {n_red} non-IDR slice NALs (primary + redundant)"
        streams[label] = (results, stream)
        print(f"[host avc] QCIF {label}: encode {enc_s:.3f} s host for "
              f"{len(frames)} frames, bits {[r.bits for r in results]}, "
              f"PSNR-Y {[round(r.psnr_y, 2) for r in results]}; decoded "
              f"bit-exactly in {dec_s:.3f} s{note}", flush=True)

    # FMO concealment: the second IDR's slice group 1 lost
    results, stream = streams["fmo_type1"]
    lossy = drop_slice_nal(stream, 3)
    dec = AVCDecoder()
    decoded = dec.decode(lossy)
    gmap = slice_group_map(AVCParams(width=W, height=H, slice_groups=2,
                                     slice_group_map_type=1))
    n_lost = int((gmap == 1).sum())
    check(dec.concealed_mbs == [0, n_lost],
          f"host avc FMO loss: concealed MBs {dec.concealed_mbs}")
    check(all(np.array_equal(a, b) for a, b in
              zip(decoded[0], results[0].recon)),
          "host avc FMO loss: picture 0 != encoder recon")
    mse = ((decoded[1][0].astype(np.float64) - results[1].recon[0]) ** 2
           ).mean()
    check(mse > 0, "host avc FMO loss: the lost group was not concealed")
    print(f"[host avc] QCIF FMO type 1 with picture 1's slice group 1 lost: "
          f"concealed MBs per picture {dec.concealed_mbs}; PSNR-Y of the "
          f"concealed picture against the encoder recon "
          f"{10 * np.log10(255.0 ** 2 / mse):.3f} dB", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", action="store_true",
                    help="trace one AVC P frame per CIF phase and one B "
                    "frame with torch.profiler (launches, summed kernel "
                    "time); adds minutes")
    ap.add_argument("--profile-dir", default=None,
                    help="write the P-frame torch.profiler table here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: FAILED: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.time()

    def timed(name, fn, *a):
        t0 = time.time()
        out = fn(*a)
        print(f"[phase] {name}: {time.time() - t0:.1f} s", flush=True)
        return out

    timed("device and build", phase_device_and_build)
    krows = timed("kernels", phase_kernels, args.seed)
    launches, cif_stream, cif_p_ms = timed("fractal cif", phase_main_path,
                                           args.seed, args.profile_dir)
    launches_1080p = timed("fractal 1080p", phase_1080p, args.seed)
    timed("fractal qcif card vs cpu", phase_card_vs_cpu, args.seed)
    rec_cif, avc_cif_results, avc_cif_stream = timed(
        "avc cif", phase_avc_cif, args.seed, args.profile_dir, args.trace)
    timed("avc qcif card vs cpu", phase_avc_card_vs_cpu, args.seed)
    timed("avc 1080p", phase_avc_1080p, args.seed)
    rec_high = timed("avc high cif", phase_avc_high_cif, args.seed,
                     args.profile_dir, args.trace)
    rec_qcif = timed("avc high qcif card vs cpu", phase_avc_high_card_vs_cpu,
                     args.seed)
    timed("avc high 1080p", phase_avc_high_1080p, args.seed)
    hierb_cif = timed("avc hier-B cabac cif", phase_avc_hierb_cif, args.seed,
                      args.trace)
    timed("avc qcif B card vs cpu", phase_avc_b_card_vs_cpu, args.seed)
    timed("avc hier-B cabac 1080p", phase_avc_hierb_1080p, args.seed)
    timed("avc cif wp", phase_avc_wp_cif, args.seed)
    timed("avc cif rate control", phase_avc_rc_cif, args.seed)
    timed("avc cif data partitioning", phase_avc_dp_cif, args.seed)
    timed("avc qcif options card vs cpu", phase_avc_options_card_vs_cpu,
          args.seed)
    timed("avc 1080p rate control", phase_avc_rc_1080p, args.seed)
    timed("native vs twin", phase_native_vs_twin, [
        ("avc cif last P", rec_cif, -1), ("avc high cif IDR", rec_high, 0),
        ("avc high cif last P", rec_high, -1),
        ("avc high qcif (ii) P 1", rec_qcif["ii"], 1),
        ("avc high qcif (ii) P 2", rec_qcif["ii"], 2)])
    timed("fractal classic cif", phase_fractal_classic_cif, args.seed)
    timed("fractal rate control cif", phase_fractal_rc_cif, args.seed)
    timed("fractal containers cif", phase_fractal_containers_cif, args.seed)
    timed("fractal cabac and exp-golomb cif", phase_fractal_entropy_cif,
          args.seed)
    launches_views = timed("fractal 3-view cif", phase_fractal_views_cif,
                           args.seed)
    timed("fractal region cif", phase_fractal_region_cif, args.seed)
    timed("fractal qcif options card vs cpu",
          phase_fractal_options_card_vs_cpu, args.seed)
    timed("metrics", phase_metrics, args.seed)
    timed("fvc native vs twin", phase_fvc_native_vs_twin, args.seed)
    launches_gop = timed("gop-parallel fractal cif", phase_gop_parallel_cif,
                         args.seed)
    timed("errdo", phase_errdo, rec_cif, args.seed)
    timed("legacy still-image codec", phase_legacy, args.seed)
    timed("mvc stereo", phase_mvc, args.seed)
    launches_sharded = timed("fractal sharded", phase_fractal_sharded,
                             args.seed)
    timed("avc sharded", phase_avc_sharded, args.seed, hierb_cif)
    timed("dryrun multichip", phase_dryrun, 8)
    timed("avc concealment", phase_concealment, avc_cif_results,
          avc_cif_stream)
    launches_cfg = timed("cfg-file entry", phase_cfg_file, args.seed,
                         cif_stream, cif_p_ms)
    timed("host avc", phase_host_avc, args.seed)
    # (record case, kernel case of phase 2 at that path's shapes, launches
    # of the path); the GOP workers run the CIF main path's shapes
    paths = (("cif_luma", "cif_luma", launches["cross_cells"]),
             ("1080p_luma", "1080p_luma", launches_1080p),
             ("cif_luma_views3", "cif_luma_views3", launches_views),
             ("cif_luma_gop", "cif_luma", launches_gop),
             ("cif_luma_tiled9", "cif_luma_tiled9",
              launches_sharded["cif_tiled9"]),
             ("1080p_luma_tiled2", "1080p_luma_tiled2",
              launches_sharded["1080p_tiled2"]),
             ("cif_luma_cfgfile", "cif_luma", launches_cfg))
    record = {"kernels": [{
        "name": "cross_cells", "case": case, "route": "cuda",
        "source": "h264tpu_torch/csrc/cross_cells.cu",
        "replaces": "h264tpu/ops/fractal.py:338",
        "launches": n_launch,
        "max_abs_err": max(r["max_abs_err"] for r in krows.values()),
        "ms": krows[kcase]["ms"], "plain_ms": krows[kcase]["plain_ms"],
        "bound_ms": krows[kcase]["bound_ms"],
        "bound_by": krows[kcase]["bound_by"], "library_ms": None,
        "wrapper_call_ms": krows[kcase]["wrapper_call_ms"]}
        for case, kcase, n_launch in paths]}
    print(f"[done] {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
