"""Plain reference of the conformant encoder's cells: decode what the window
wrote and compare it with what the encoder reconstructed.

The decoder is the frozen numpy copy in ``frozen/avc`` (see its package
docstring).  A P frame is decoded from the encoder's reconstruction of the
frame before it, which stands in the decoder's picture buffer: decoding a
whole 50-frame clip in Python would take longer than the window.  A clip's
IDR frame is decoded from nothing, so the start of each chain is checked by
itself.

Two further readings judge the encoder's choices in the inter macroblocks
that the decoder reports (``AVCDecoder.probe``), against the source frame:

* ``level_band_violations``: each decoded luma level must be one that the
  quantiser can give the forward transform of source minus prediction at the
  macroblock's QP with a rounding offset between 0 and one half (adaptive
  rounding moves it inside that range), and an 8x8 group may be dropped
  whole only where every level in it could be at most 1 (the coefficient-
  cost decimation drops nothing else);
* ``motion_gap``: the mean absolute error per pixel of the chosen motion
  vectors' prediction above the least that any whole-pel vector of the full
  +-SR search reaches, over every inter partition.
"""

from __future__ import annotations

import numpy as np

from .frozen.avc import inter as INTER
from .frozen.avc import quant as Q
from .frozen.avc import slice_dec as SD
from .frozen.avc.slice_dec import AVCDecoder
from .frozen.bitstream.nal import annexb_parse, nalu_to_bytes, NAL_SPS, NAL_PPS

_START = b"\x00\x00\x00\x01"


def split_frames(stream: bytes):
    """(parameter-set NAL units, [NAL units of each coded frame]) of an
    Annex-B stream; a frame starts at a slice whose first_mb_in_slice is 0
    (the leading ue(v) of the slice header is the single bit 1)."""
    params, frames = [], []
    for n in annexb_parse(stream):
        if n.nal_type in (NAL_SPS, NAL_PPS):
            params.append(n)
        elif n.rbsp and n.rbsp[0] & 0x80:
            frames.append([n])
        elif frames:
            frames[-1].append(n)
        else:
            raise ValueError("a slice precedes the first frame start")
    return params, frames


def _unfiltered(y, u, v, ctx):
    return y, u, v


def _annexb(nalus) -> bytes:
    return b"".join(_START + nalu_to_bytes(n) for n in nalus)


def decode_frame(params, frame_nalus, ref=None, index: int = 0,
                 loop_filter: bool = True, probe: list = None):
    """Decode coded frame ``index`` of an IPPP clip; ``ref`` is the (Y, U,
    V) uint8 picture that the decoder's buffer holds as the frame before it
    (None for the IDR).  ``loop_filter=False`` leaves the in-loop deblocking
    filter out, which the configuration states is on: the control of
    ``PERF.md``.  ``probe``: a list that gets the decoder's record of each
    inter macroblock."""
    dec = AVCDecoder()
    dec.decode(_annexb(params))
    dec.probe = probe
    if ref is not None:
        sps = next(iter(dec.sps.values()))
        ref_frame_num = (index - 1) % (1 << sps["log2_max_frame_num"])
        planes = tuple(np.asarray(p, np.int64) for p in ref)
        dec.dpb = [dict(fn=ref_frame_num, poc=2 * ref_frame_num,
                        frame=tuple(np.asarray(p, np.uint8) for p in ref),
                        rp=INTER.RefPlanes(*planes), mv=None, ref=None,
                        ref_poc=None, long=False, lt_idx=-1)]
    if loop_filter:
        out = dec.decode(_annexb(frame_nalus))
    else:
        saved = SD.deblock_frame
        SD.deblock_frame = _unfiltered
        try:
            out = dec.decode(_annexb(frame_nalus))
        finally:
            SD.deblock_frame = saved
    if len(out) != 1:
        raise ValueError(f"a coded frame decoded to {len(out)} pictures")
    return out[0]


def _blocks(x: np.ndarray) -> np.ndarray:
    """[16, 16] -> [4, 4, 4, 4] (block row, block column, row, column)."""
    return x.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3)


def level_band_violations(src_y: np.ndarray, probe) -> int:
    """Decoded luma levels of the probed macroblocks that no quantiser
    rounding offset in [0, 1/2] gives (see the module docstring)."""
    bad = 0
    for mb in probe:
        y0, x0, qp = 16 * mb["mby"], 16 * mb["mbx"], int(mb["qp"])
        org = np.asarray(src_y[y0:y0 + 16, x0:x0 + 16], np.int64)
        w = Q.fdct4x4(_blocks(org - np.asarray(mb["pred"], np.int64)))
        per, rem = qp // 6, qp % 6
        qbits = Q.Q_BITS + per
        scaled = np.abs(w) * Q.QUANT_COEF[rem].astype(np.int64)
        lo = scaled >> qbits
        hi = (scaled + (1024 << (4 + per))) >> qbits
        lev = np.asarray(mb["lev"], np.int64)
        mag = np.abs(lev)
        wrong = (mag < lo) | (mag > hi) | ((lev != 0) & (np.sign(lev)
                                                          != np.sign(w)))
        for gy in (0, 2):
            for gx in (0, 2):
                g = (slice(gy, gy + 2), slice(gx, gx + 2))
                if not lev[g].any():                 # dropped or all zero
                    bad += int((lo[g] > 1).sum())
                else:
                    bad += int(wrong[g].sum())
    return bad


def motion_gap(src_y: np.ndarray, ref_y: np.ndarray, probe, sr: int):
    """(sum of |error| above the whole-pel least, pixels) over every
    partition of the probed macroblocks; the reference picture is padded by
    repeating its edge, as the encoder's search pads it."""
    pad = np.pad(np.asarray(ref_y, np.int64), sr, mode="edge")
    excess = pixels = 0
    for mb in probe:
        y0, x0 = 16 * mb["mby"], 16 * mb["mbx"]
        pred = np.asarray(mb["pred"], np.int64)
        for (dy4, dx4, w4, h4), _mv, _ri in mb["parts"]:
            py, px, h, w = 4 * dy4, 4 * dx4, 4 * h4, 4 * w4
            org = np.asarray(src_y[y0 + py:y0 + py + h, x0 + px:x0 + px + w],
                             np.int64)
            chosen = int(np.abs(org - pred[py:py + h, px:px + w]).sum())
            win = pad[y0 + py:y0 + py + h + 2 * sr,
                      x0 + px:x0 + px + w + 2 * sr]
            views = np.lib.stride_tricks.sliding_window_view(win, (h, w))
            least = int(np.abs(views - org).sum(axis=(2, 3)).min())
            excess += chosen - least
            pixels += h * w
    return excess, pixels
