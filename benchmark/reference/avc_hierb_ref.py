"""Plain reference of the hierarchical-B CABAC cell: decode what the window
wrote and compare it with what the encoder reconstructed.

The decoder is the frozen numpy copy ``frozen/avc/slice_dec_cabac.py`` (the
program's decoder with CABAC and B slices, see its docstring).  Decoding a
whole 50-picture clip in Python would take longer than the window, so a
sampled picture is decoded with its GOP: the decoder's picture buffer starts
from the encoder's reconstruction of the GOP's previous anchor, and the
GOP's pictures are decoded in decode order (anchor P, reference B, leaf Bs)
up to the sampled one, since a leaf B predicts from the anchor and from the
reference B.  A clip's IDR picture is decoded from nothing.  Frame numbers
and picture order counts come from the slice headers (spec 8.2.1.1), so the
primed picture carries the numbers the stream refers to it by.

The readings of the encoder's choices are those of ``avc_ref.py``, over the
inter macroblocks of the sampled P and B pictures (``AVCDecoder.probe``):

* ``level_band_violations``: ``avc_ref.level_band_violations`` at each
  macroblock's QP (the cascade gives 28, 29 and 30);
* ``motion_gap``: the mean absolute error per pixel of each explicitly
  coded partition's prediction from one list, against the source, above
  the least that any whole-pel vector of the full +-SR search reaches in
  that list's reference picture.  A bi-predicted partition counts once per
  list; direct and skipped motion, which is derived and not searched, is
  not counted.
"""

from __future__ import annotations

import numpy as np

from . import avc_ref as AR
from .frozen.avc import inter as INTER
from .frozen.avc import slice_dec_cabac as SD
from .frozen.avc.slice_dec_cabac import AVCDecoder
from .frozen.bitstream.nal import NAL_IDR
from .frozen.entropy.bitio import BitReader

split_frames = AR.split_frames
level_band_violations = AR.level_band_violations
ANCHORS = ("IDR", "I", "P")


def _decoder(params) -> AVCDecoder:
    dec = AVCDecoder()
    dec.decode(AR._annexb(params))
    return dec


def picture_headers(params, frames) -> list:
    """Per coded picture in decode order: dict(idr, ref_idc, frame_num,
    poc, lsb, msb) from its first slice header (POC type 0, frames only)."""
    dec = _decoder(params)
    sps = next(iter(dec.sps.values()))
    if sps["poc_type"] != 0:
        raise ValueError("the reference reads POC type 0 streams only")
    max_lsb = 1 << sps["log2_max_poc_lsb"]
    out, prev_lsb, prev_msb = [], 0, 0
    for nalus in frames:
        n = nalus[0]
        r = BitReader(n.rbsp)
        r.ue()                                  # first_mb_in_slice
        r.ue()                                  # slice_type
        r.ue()                                  # pic_parameter_set_id
        frame_num = r.u(sps["log2_max_frame_num"])
        idr = n.nal_type == NAL_IDR
        if idr:
            r.ue()                              # idr_pic_id
        lsb = r.u(sps["log2_max_poc_lsb"])
        if idr:
            msb = 0
        elif lsb < prev_lsb and prev_lsb - lsb >= max_lsb // 2:
            msb = prev_msb + max_lsb
        elif lsb > prev_lsb and lsb - prev_lsb > max_lsb // 2:
            msb = prev_msb - max_lsb
        else:
            msb = prev_msb
        if n.ref_idc != 0:
            prev_lsb, prev_msb = lsb, msb
        out.append(dict(idr=idr, ref_idc=n.ref_idc, frame_num=frame_num,
                        poc=msb + lsb, lsb=lsb, msb=msb))
    return out


def display_to_decode(headers) -> list:
    """The decode index of each picture in display (POC) order."""
    if sum(h["idr"] for h in headers) != 1 or not headers[0]["idr"]:
        raise ValueError("the reference reads one IDR, first, per clip")
    return sorted(range(len(headers)), key=lambda i: headers[i]["poc"])


def _entry(planes, head) -> dict:
    """A decoder picture-buffer entry of a reconstruction (Y, U, V)."""
    h, w = planes[0].shape
    return dict(fn=head["frame_num"], poc=head["poc"],
                frame=tuple(np.asarray(p, np.uint8) for p in planes),
                rp=INTER.RefPlanes(*(np.asarray(p, np.int64)
                                     for p in planes)),
                mv=np.zeros((h // 4, w // 4, 2), np.int64),
                ref=np.full((h // 4, w // 4), -1, np.int64),
                ref_poc=None, long=False, lt_idx=-1)


def decode_picture(params, frames, headers, types, recon, k: int,
                   loop_filter: bool = True, probe: list = None):
    """Decode picture ``k`` (display order) of a hierarchical-B clip with
    its GOP (see the module docstring).  ``types`` are the clip's picture
    types and ``recon`` the encoder's reconstructions, in display order.
    ``loop_filter=False`` leaves the in-loop deblocking filter out of every
    picture decoded here; ``probe``: a list that gets the decoder's record
    of each inter macroblock of picture ``k``."""
    order = display_to_decode(headers)
    if len(order) != len(types):
        raise ValueError("the stream holds another number of pictures")
    d = order[k]
    dec = _decoder(params)
    first = d
    if d:
        anchors = [i for i, t in enumerate(types) if t in ANCHORS]
        prev = max(i for i in anchors if i < k)
        first = order[min(i for i in anchors if i >= k)]
        if not order[prev] < first <= d:
            raise ValueError("the GOP is not in decode order")
        dec.dpb = [_entry(recon[prev], headers[order[prev]])]
        last_ref = max(i for i in range(first) if headers[i]["ref_idc"])
        dec._prev_poc_lsb = headers[last_ref]["lsb"]
        dec._prev_poc_msb = headers[last_ref]["msb"]
    saved = SD.deblock_frame
    if not loop_filter:
        SD.deblock_frame = AR._unfiltered
    try:
        for i in range(first, d + 1):
            dec.probe = probe if i == d else None
            out = dec.decode(AR._annexb(frames[i]))
            if len(out) != 1:
                raise ValueError(f"a coded picture decoded to {len(out)} "
                                 "pictures")
    finally:
        SD.deblock_frame = saved
    return out[0]


def motion_gap(src_y: np.ndarray, probe, sr: int):
    """(sum of |error| above the whole-pel least, pixels) over every
    recorded partition of the probed macroblocks, each in the reference
    picture of its own list (edge-padded as the encoder's search pads it)."""
    excess = pixels = 0
    for mb in probe:
        y0, x0 = 16 * mb["mby"], 16 * mb["mbx"]
        for (dy4, dx4, w4, h4), mv, rp in mb["parts"]:
            py, px, h, w = y0 + 4 * dy4, x0 + 4 * dx4, 4 * h4, 4 * w4
            org = np.asarray(src_y[py:py + h, px:px + w], np.int64)
            pred = rp.luma_block(py, px, h, w, int(mv[0]), int(mv[1]))
            chosen = int(np.abs(org - pred).sum())
            g0, g1 = INTER.PAD + py - sr, INTER.PAD + px - sr
            win = rp.G[g0:g0 + h + 2 * sr, g1:g1 + w + 2 * sr]
            views = np.lib.stride_tricks.sliding_window_view(win, (h, w))
            least = int(np.abs(views - org).sum(axis=(2, 3)).min())
            excess += chosen - least
            pixels += h * w
    return excess, pixels
