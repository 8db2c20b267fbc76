"""The conformant encoder (``h264tpu_torch.avc.device_codec.DeviceAVCCodec``)
in its hierarchical-B CABAC deployment, as the benchmark drives and judges
it.

A live hierarchical-B encoder buffers one GOP of the source before it codes
the GOP's anchor.  :func:`encode` holds the encoder to that: it hands the
frames through a guard that raises ``RuntimeError`` when the encoder takes
frame k of a call while fewer than k - G pictures of that call are packed
(G = ``bframes`` + 1, the GOP; packed pictures counted on the codec's own
``host_ms["pack"]``).  An encoder that reads the whole clip before it codes
anything stops there, inside set-up.  The output record and the counters
are those of the IPPP cell (``systems/avc.py``)."""

from __future__ import annotations

import numpy as np

from benchmark.harness.window import sample_frames
from benchmark.reference import avc_hierb_ref as REF
from benchmark.systems.avc import counters, output, reset_counters  # noqa: F401

_CODEC_KEYS = ("search_range", "n_slices", "bframes", "hierarchical")


def build(settings: dict, device):
    from h264tpu_torch.avc.device_codec import DeviceAVCCodec
    from h264tpu_torch.avc.params import AVCParams
    params = {k: v for k, v in settings.items() if k not in _CODEC_KEYS}
    codec_kw = {k: settings[k] for k in _CODEC_KEYS}
    return DeviceAVCCodec(AVCParams(**params), device=device, **codec_kw)


def lookahead(codec, frames):
    """``frames``, raising once the encoder reads more than one GOP ahead
    of its packed pictures (see the module docstring)."""
    gop = codec.bframes + 1
    packed0 = len(codec.host_ms["pack"])
    for k, frame in enumerate(frames):
        packed = len(codec.host_ms["pack"]) - packed0
        if packed < k - gop:
            raise RuntimeError(
                f"the encoder took frame {k} with {packed} pictures packed: "
                f"more than one GOP ({gop} frames) ahead")
        yield frame


def encode(codec, frames):
    return codec.encode_sequence(lookahead(codec, frames))


def check(settings: dict, spec: dict, clips, sources, rng, control=False):
    """Readings of the window's output: {name: value}.

    ``decode_mismatch_px``: pixels of the sampled pictures where the frozen
    decoder's picture, decoded with its GOP from the encoder's
    reconstruction of the previous anchor, differs from the encoder's
    reconstruction (with ``control``: from the frozen decoder's own picture
    made without the in-loop filter, put in the encoder's place).
    ``level_band_violations`` and ``motion_gap``: the decoded luma levels
    and coded motion of the sampled P and B pictures' inter macroblocks
    judged against the source (``reference/avc_hierb_ref.py``);
    ``motion_gap`` is None where no coded partition was sampled."""
    mismatch = violations = excess = pixels = 0
    split = {}
    for c, k in sample_frames(clips, int(spec["frames"]), rng):
        clip = clips[c]
        if c not in split:
            params, frames = REF.split_frames(clip["stream"])
            split[c] = params, frames, REF.picture_headers(params, frames)
        params, frames, headers = split[c]
        args = (params, frames, headers, clip["types"], clip["recon"], k)
        probe = []
        got = REF.decode_picture(*args, probe=probe)
        judged = clip["recon"][k]
        if control:
            judged = REF.decode_picture(*args, loop_filter=False)
        mismatch += sum(int(np.count_nonzero(a != b))
                        for a, b in zip(got, judged))
        src_y = sources[c][k][0]
        violations += REF.level_band_violations(src_y, probe)
        e, n = REF.motion_gap(src_y, probe, int(settings["search_range"]))
        excess += e
        pixels += n
    return dict(decode_mismatch_px=mismatch,
                level_band_violations=violations,
                motion_gap=excess / pixels if pixels else None)
