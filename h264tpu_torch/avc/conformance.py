"""Profile/level conformance checking (spec A.2/A.3; J16).

The JM twin is ``JM/lencod/src/conformance.c`` (ProfileCheck / LevelCheck):
validate that a coding configuration fits the signaled profile_idc /
level_idc before encoding, instead of emitting an out-of-conformance stream.

The port's own copy of ``h264tpu/avc/conformance.py``; it imports nothing from ``h264tpu``.
"""

from __future__ import annotations

# Table A-1 (subset of levels; fields: MaxMBPS, MaxFS [MBs], MaxDpbMbs,
# MaxBR [kbit/s, VCL for Baseline/Main], MaxCPB [kbits], MaxVmvR [vertical
# MV range in luma pels], MaxMvsPer2Mb)
LEVEL_LIMITS = {
    10: (1485, 99, 396, 64, 175, 64, None),
    11: (3000, 396, 900, 192, 500, 128, None),
    12: (6000, 396, 2376, 384, 1000, 128, None),
    13: (11880, 396, 2376, 768, 2000, 128, None),
    20: (11880, 396, 2376, 2000, 2000, 128, None),
    21: (19800, 792, 4752, 4000, 4000, 256, None),
    22: (20250, 1620, 8100, 4000, 4000, 256, None),
    30: (40500, 1620, 8100, 10000, 10000, 256, 32),
    31: (108000, 3600, 18000, 14000, 14000, 512, 16),
    32: (216000, 5120, 20480, 20000, 20000, 512, 16),
    40: (245760, 8192, 32768, 20000, 25000, 512, 16),
    41: (245760, 8192, 32768, 50000, 62500, 512, 16),
    42: (522240, 8704, 34816, 50000, 62500, 512, 16),
    50: (589824, 22080, 110400, 135000, 135000, 512, 16),
    51: (983040, 36864, 184320, 240000, 240000, 512, 16),
}

BASELINE, MAIN, EXTENDED, HIGH = 66, 77, 88, 100


class ConformanceError(ValueError):
    pass


def profile_check(profile_idc: int, *, cabac: bool = False,
                  b_slices: bool = False, fmo: bool = False,
                  weighted_pred: bool = False, transform_8x8: bool = False,
                  interlace: bool = False):
    """Tool-set vs profile constraints (spec A.2; conformance.c ProfileCheck)."""
    if profile_idc not in (BASELINE, MAIN, EXTENDED, HIGH):
        raise ConformanceError(f"unknown profile_idc {profile_idc}")
    if profile_idc == BASELINE:
        bad = [n for n, v in (("CABAC", cabac), ("B slices", b_slices),
                              ("weighted prediction", weighted_pred),
                              ("8x8 transform", transform_8x8),
                              ("interlace", interlace)) if v]
        if bad:
            raise ConformanceError(f"Baseline forbids: {', '.join(bad)}")
    if profile_idc in (MAIN, HIGH) and fmo:
        raise ConformanceError("FMO is not allowed in Main/High profiles")
    if profile_idc != HIGH and transform_8x8:
        raise ConformanceError("8x8 transform requires High profile")


def level_check(level_idc: int, *, width: int, height: int,
                frame_rate: float, num_ref_frames: int = 1,
                bitrate_kbps: float = 0.0, mv_range_y: int = 0):
    """Picture-size / rate / DPB / MV-range vs level (spec A.3.1;
    conformance.c LevelCheck).  Raises ConformanceError on violation."""
    if level_idc not in LEVEL_LIMITS:
        raise ConformanceError(f"unknown level_idc {level_idc}")
    max_mbps, max_fs, max_dpb_mbs, max_br, _cpb, max_vmv, _ = \
        LEVEL_LIMITS[level_idc]
    fs = (width // 16) * (height // 16)
    if fs > max_fs:
        raise ConformanceError(
            f"frame size {fs} MBs > level {level_idc} MaxFS {max_fs}")
    # spec A.3.1: sqrt(8*MaxFS) bound on picture width/height in MBs
    import math
    lim = int(math.sqrt(8 * max_fs))
    if width // 16 > lim or height // 16 > lim:
        raise ConformanceError("picture dimension exceeds sqrt(8*MaxFS)")
    if fs * frame_rate > max_mbps:
        raise ConformanceError(
            f"MB rate {fs * frame_rate:.0f}/s > MaxMBPS {max_mbps}")
    if num_ref_frames * fs > max_dpb_mbs:
        raise ConformanceError(
            f"DPB {num_ref_frames * fs} MBs > MaxDpbMbs {max_dpb_mbs}")
    if bitrate_kbps and bitrate_kbps > 1.2 * max_br:
        raise ConformanceError(
            f"bitrate {bitrate_kbps:.0f} kbit/s > 1.2*MaxBR {1.2 * max_br:.0f}")
    if mv_range_y and mv_range_y > max_vmv:
        raise ConformanceError(
            f"vertical MV range {mv_range_y} > MaxVmvR {max_vmv}")


def check_params(p, frame_rate: float = 30.0, bitrate_kbps: float = 0.0):
    """Validate an avc.params.AVCParams configuration end-to-end."""
    profile_check(p.profile_idc, cabac=getattr(p, "cabac", False),
                  fmo=p.slice_groups > 1,
                  transform_8x8=getattr(p, "transform_8x8", False))
    if p.width % 2 or p.height % 2:
        raise ConformanceError("4:2:0 cropping needs an even visible size, "
                               f"not {p.width}x{p.height}")
    # the level limits the coded picture (whole macroblocks)
    level_check(p.level_idc, width=p.coded_width, height=p.coded_height,
                frame_rate=frame_rate, num_ref_frames=p.num_ref_frames,
                bitrate_kbps=bitrate_kbps)
