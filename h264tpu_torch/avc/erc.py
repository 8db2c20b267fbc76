"""MB-level error concealment (decoder ERC).

The port's own copy of ``h264tpu/avc/erc.py`` (host numpy, as there).

Non-normative loss recovery in the shape of the JM decoder's
``erc_do_i.c:44`` ercConcealIntraFrame (per-pixel distance-weighted
interpolation from the available neighbor-MB edge pixels) and
``erc_do_p.c:74`` ercConcealInterFrame (motion-compensated copy with the
MV borrowed from decoded neighbors, zero-MV fallback).  The decoder
calls :func:`conceal_picture` when a picture's slices did not cover all
MBs (lost NAL units, e.g. after ``bitstream/rtp.py`` loss simulation).

Missing MBs are processed outside-in (most decoded neighbors first), and
a concealed MB counts as available for later ones — the JM ERC sweep
order.
"""

from __future__ import annotations

import numpy as np


def _conceal_order(missing: np.ndarray):
    """Missing-MB processing order: repeatedly take the MB with the most
    available (decoded or already-concealed) 4-neighbors."""
    mb_h, mb_w = missing.shape
    avail = ~missing.copy()
    todo = {(y, x) for y, x in zip(*np.nonzero(missing))}
    order = []
    while todo:
        def navail(pos):
            y, x = pos
            n = 0
            for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                yy, xx = y + dy, x + dx
                if 0 <= yy < mb_h and 0 <= xx < mb_w and avail[yy, xx]:
                    n += 1
            return n
        best = max(todo, key=navail)
        order.append(best)
        todo.remove(best)
        avail[best] = True
    return order


def _interp_block(rec: np.ndarray, y0: int, x0: int, size: int,
                  have: dict):
    """Distance-weighted interpolation of one size x size block from the
    available neighbor edge rows/cols (ercPixConcealIMB shape)."""
    idx = np.arange(size)
    yy = idx[:, None]
    xx = idx[None, :]
    num = np.zeros((size, size), np.float64)
    den = np.zeros((size, size), np.float64)
    if "t" in have:
        w = 1.0 / (yy + 1)
        num += w * have["t"][None, :]
        den += w
    if "b" in have:
        w = 1.0 / (size - yy)
        num += w * have["b"][None, :]
        den += w
    if "l" in have:
        w = 1.0 / (xx + 1)
        num += w * have["l"][:, None]
        den += w
    if "r" in have:
        w = 1.0 / (size - xx)
        num += w * have["r"][:, None]
        den += w
    if not den.any():
        return np.full((size, size), 128, np.int64)
    return np.clip(np.rint(num / den), 0, 255).astype(np.int64)


def conceal_intra(rec_y, rec_u, rec_v, missing: np.ndarray):
    """Spatial concealment of all missing MBs (I pictures / no refs)."""
    avail = ~missing.copy()
    for mby, mbx in _conceal_order(missing):
        for rec, sz in ((rec_y, 16), (rec_u, 8), (rec_v, 8)):
            y0, x0 = mby * sz, mbx * sz
            have = {}
            if mby > 0 and avail[mby - 1, mbx]:
                have["t"] = rec[y0 - 1, x0:x0 + sz]
            if mby + 1 < missing.shape[0] and avail[mby + 1, mbx]:
                have["b"] = rec[y0 + sz, x0:x0 + sz]
            if mbx > 0 and avail[mby, mbx - 1]:
                have["l"] = rec[y0:y0 + sz, x0 - 1]
            if mbx + 1 < missing.shape[1] and avail[mby, mbx + 1]:
                have["r"] = rec[y0:y0 + sz, x0 + sz]
            rec[y0:y0 + sz, x0:x0 + sz] = _interp_block(rec, y0, x0, sz,
                                                        have)
        avail[mby, mbx] = True


def conceal_inter(rec_y, rec_u, rec_v, missing: np.ndarray,
                  mv_plane: np.ndarray, ref_plane: np.ndarray, rp):
    """Temporal concealment: each missing MB is motion-compensated from
    the first list-0 reference with the average MV of its decoded
    neighbor cells (zero-MV copy when none are inter)."""
    mb_h, mb_w = missing.shape
    avail = ~missing.copy()
    for mby, mbx in _conceal_order(missing):
        by, bx = mby * 4, mbx * 4
        cand = []
        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            yy, xx = mby + dy, mbx + dx
            if not (0 <= yy < mb_h and 0 <= xx < mb_w and avail[yy, xx]):
                continue
            cy = yy * 4 + (3 if dy < 0 else 0 if dy > 0 else 0)
            cx = xx * 4 + (3 if dx < 0 else 0 if dx > 0 else 0)
            if ref_plane[cy, cx] >= 0:
                cand.append(mv_plane[cy, cx])
        if cand:
            mv = np.rint(np.mean(cand, axis=0)).astype(np.int64)
        else:
            mv = np.zeros(2, np.int64)
        y0, x0 = mby * 16, mbx * 16
        rec_y[y0:y0 + 16, x0:x0 + 16] = rp.luma_block(
            y0, x0, 16, 16, int(mv[0]), int(mv[1]))
        rec_u[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = rp.chroma_block(
            "u", mby * 8, mbx * 8, 8, 8, int(mv[0]), int(mv[1]))
        rec_v[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = rp.chroma_block(
            "v", mby * 8, mbx * 8, 8, 8, int(mv[0]), int(mv[1]))
        mv_plane[by:by + 4, bx:bx + 4] = mv
        ref_plane[by:by + 4, bx:bx + 4] = 0
        avail[mby, mbx] = True


def conceal_picture(pic: dict) -> int:
    """Conceal a partially-decoded picture in place; returns the number
    of concealed MBs.  ``pic`` is the decoder's picture dict (rec planes,
    decoded mask, motion planes, erc_ref)."""
    missing = ~pic["decoded"]
    n = int(missing.sum())
    if n == 0:
        return 0
    rec_y, rec_u, rec_v = pic["rec"]
    rp = pic.get("erc_ref")
    if rp is None:
        conceal_intra(rec_y, rec_u, rec_v, missing)
    else:
        conceal_inter(rec_y, rec_u, rec_v, missing,
                      pic["mv"], pic["ref"], rp)
    return n
