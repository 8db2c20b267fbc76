"""The conformant encoder (``h264tpu_torch.avc.device_codec.DeviceAVCCodec``)
on a source whose height is not a multiple of 16 (1920x1080): the stream
codes the next multiple (1920x1088) and its SPS crops the padding off.

Building, encoding and the counters are those of the IPPP cell
(``systems/avc.py``); the output record adds each frame's coded
reconstruction (``coded``) beside the visible one (``recon``), since a P
frame is decoded from the coded picture of the frame before it."""

from __future__ import annotations

import numpy as np

from benchmark.harness.window import sample_frames
from benchmark.reference import avc_cropped_ref as REF
from benchmark.systems import avc as AVC
from benchmark.systems.avc import build, counters, encode, reset_counters  # noqa: F401


def output(results, stream) -> dict:
    out = AVC.output(results, stream)
    out["coded"] = [tuple(np.array(p, np.uint8) for p in
                          (r.recon if r.coded is None else r.coded))
                    for r in results]
    return out


def check(settings: dict, spec: dict, clips, sources, rng, control=False):
    """Readings of the window's output: {name: value}.

    ``decode_mismatch_px``: pixels of the sampled frames where the frozen
    decoder's coded picture differs from the encoder's coded
    reconstruction, plus pixels where the SPS's crop window of it differs
    from the encoder's visible reconstruction (with ``control``: the frozen
    decoder's own picture made without the in-loop filter, and its crop,
    put in the encoder's place).
    ``level_band_violations`` and ``motion_gap``: the decoded luma levels
    and motion of the sampled P frames' inter macroblocks judged against
    the source padded to the coded size (``reference/avc_cropped_ref.py``);
    ``motion_gap`` is None where no inter partition was sampled.
    Raises ``ValueError`` where the SPS codes another size than the
    settings' visible size rounded up to whole macroblocks, or crops it to
    another window."""
    vis = (int(settings["height"]), int(settings["width"]))
    mismatch = violations = excess = pixels = 0
    split = {}
    for c, k in sample_frames(clips, int(spec["frames"]), rng):
        clip = clips[c]
        if c not in split:
            params, frames = REF.split_frames(clip["stream"])
            if len(frames) != len(clip["types"]):
                raise ValueError("the stream holds another number of frames")
            geo = REF.geometry(params)
            if geo["visible"] != vis or geo["coded"] != tuple(
                    -(-n // 16) * 16 for n in vis):
                raise ValueError(f"the SPS codes {geo['coded']} cropped to "
                                 f"{geo['visible']}, not {vis}")
            split[c] = params, frames, geo
        params, frames, geo = split[c]
        ref = clip["coded"][k - 1] if k else None
        probe = []
        got = REF.decode_frame(params, frames[k], ref, k, probe=probe)
        coded, shown = clip["coded"][k], clip["recon"][k]
        if control:
            coded = REF.decode_frame(params, frames[k], ref, k,
                                     loop_filter=False)
            shown = REF.crop(coded, geo["crop"])
        mismatch += REF.mismatch_px(got, coded, shown, geo["crop"])
        src_y = REF.pad_source(sources[c][k][0], geo["coded"])
        violations += REF.level_band_violations(src_y, probe)
        if ref is not None:
            e, n = REF.motion_gap(src_y, ref[0], probe,
                                  int(settings["search_range"]))
            excess += e
            pixels += n
    return dict(decode_mismatch_px=mismatch,
                level_band_violations=violations,
                motion_gap=excess / pixels if pixels else None)
