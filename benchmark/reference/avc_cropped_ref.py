"""Plain reference of the cropped conformant encoder's cell (a 1920x1080
source coded as 1920x1088): decode what the window wrote and compare it
with what the encoder reconstructed, in the coded picture and in the
window that the SPS crops it to.

The decoder is the frozen numpy copy in ``frozen/avc``, driven as
``avc_ref.py`` drives it: a P frame is decoded from the encoder's coded
reconstruction of the frame before it.  The frozen decoder outputs the
coded picture; this module reads the crop window from the SPS itself
(spec 7.4.2.1.1) and cuts the visible picture out of it.

The source is padded to the coded size here, by repeating its last row and
column (``np.pad(..., mode="edge")``, as JM pads a source it crops), so
that ``avc_ref.level_band_violations`` and ``avc_ref.motion_gap`` judge the
bottom macroblock row, whose lower lines are that padding, like any other.
"""

from __future__ import annotations

import numpy as np

from . import avc_ref as AR
from .frozen.avc import slice_dec as SD
from .frozen.bitstream.nal import NAL_SPS

split_frames = AR.split_frames
decode_frame = AR.decode_frame
level_band_violations = AR.level_band_violations
motion_gap = AR.motion_gap


def geometry(params) -> dict:
    """The SPS's coded size and crop window: dict(coded=(h, w),
    visible=(h, w), crop=(left, right, top, bottom) in chroma units)."""
    sps = SD.parse_sps(next(n for n in params if n.nal_type == NAL_SPS).rbsp)
    h, w = sps["height"], sps["width"]
    crop = sps["crop"] or (0, 0, 0, 0)
    left, right, top, bottom = crop
    return dict(coded=(h, w), crop=crop,
                visible=(h - 2 * (top + bottom), w - 2 * (left + right)))


def crop(planes, window) -> tuple:
    """The crop window (left, right, top, bottom, chroma units) of coded
    (Y, U, V) 4:2:0 planes."""
    left, right, top, bottom = window
    out = []
    for c, pl in enumerate(planes):
        s = 1 if c else 2
        h, w = pl.shape
        out.append(pl[s * top:h - s * bottom, s * left:w - s * right])
    return tuple(out)


def pad_source(src_y: np.ndarray, coded) -> np.ndarray:
    """The source luma padded to the coded (h, w) by edge repetition."""
    h, w = coded
    return np.pad(np.asarray(src_y), ((0, h - src_y.shape[0]),
                                      (0, w - src_y.shape[1])), mode="edge")


def mismatch_px(decoded, judged_coded, judged_visible, window) -> int:
    """Pixels where the decoded coded picture differs from the judged coded
    picture, plus pixels where its crop window differs from the judged
    visible picture."""
    whole = sum(int(np.count_nonzero(a != b))
                for a, b in zip(decoded, judged_coded))
    shown = sum(int(np.count_nonzero(a != b))
                for a, b in zip(crop(decoded, window), judged_visible))
    return whole + shown
