"""The conformant encoder (``h264tpu_torch.avc.device_codec.DeviceAVCCodec``)
as the benchmark drives and judges it."""

from __future__ import annotations

import numpy as np

from benchmark.harness.window import sample_frames
from benchmark.reference import avc_ref as REF

_CODEC_KEYS = ("intra_period", "search_range", "n_slices")


def build(settings: dict, device):
    from h264tpu_torch.avc.device_codec import DeviceAVCCodec
    from h264tpu_torch.avc.params import AVCParams
    params = {k: v for k, v in settings.items() if k not in _CODEC_KEYS}
    codec_kw = {k: settings[k] for k in _CODEC_KEYS}
    return DeviceAVCCodec(AVCParams(**params), device=device, **codec_kw)


def encode(codec, frames):
    return codec.encode_sequence(frames)


def reset_counters(codec):
    codec.host_ms = dict(pack=[], deblock=[])


def counters(codec) -> dict:
    """The codec's own host clock per frame of the slice packer."""
    return {"host_ms.pack": list(codec.host_ms["pack"])}


def output(results, stream) -> dict:
    return dict(stream=stream, types=[r.frame_type for r in results],
                bits=[r.bits for r in results],
                recon=[tuple(np.array(p, np.uint8) for p in r.recon)
                       for r in results])


def check(settings: dict, spec: dict, clips, sources, rng, control=False):
    """Readings of the window's output: {name: value}.

    ``decode_mismatch_px``: pixels of the sampled frames where the frozen
    decoder's picture differs from the encoder's reconstruction (with
    ``control``: from the frozen decoder's own picture made without the
    in-loop filter, put in the encoder's place).
    ``level_band_violations`` and ``motion_gap``: the decoded luma levels
    and motion of the sampled P frames' inter macroblocks judged against the
    source (``reference/avc_ref.py``); ``motion_gap`` is None where no
    inter partition was sampled."""
    mismatch = violations = excess = pixels = 0
    split = {}
    for c, k in sample_frames(clips, int(spec["frames"]), rng):
        clip = clips[c]
        if c not in split:
            split[c] = REF.split_frames(clip["stream"])
            if len(split[c][1]) != len(clip["types"]):
                raise ValueError("the stream holds another number of frames")
        params, frames = split[c]
        ref = clip["recon"][k - 1] if k else None
        probe = []
        got = REF.decode_frame(params, frames[k], ref, k, probe=probe)
        judged = clip["recon"][k]
        if control:
            judged = REF.decode_frame(params, frames[k], ref, k,
                                      loop_filter=False)
        mismatch += sum(int(np.count_nonzero(a != b))
                        for a, b in zip(got, judged))
        src_y = sources[c][k][0]
        violations += REF.level_band_violations(src_y, probe)
        if ref is not None:
            e, n = REF.motion_gap(src_y, ref[0], probe,
                                  int(settings["search_range"]))
            excess += e
            pixels += n
    return dict(decode_mismatch_px=mismatch,
                level_band_violations=violations,
                motion_gap=excess / pixels if pixels else None)
