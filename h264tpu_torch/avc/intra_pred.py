"""Spec-exact H.264 intra prediction (numpy host model, per-MB).

Luma 4x4: 9 modes (spec 8.3.1.2.1-9; same math as the batched TPU kernels in
``ops/intra.py``, re-expressed per-block because the conformant scan order is
the per-MB zig-zag, not the FVC plane wavefront).  Luma 16x16: 4 modes (spec
8.3.3).  Chroma 8x8 (4:2:0): 4 modes (spec 8.3.4; per-4x4 DC rules mirror
``JM/ldecod/src/intra_chroma_pred.c:72`` exactly).

All functions take the reconstructed plane being built (numpy int64) plus
availability flags and return candidate predictions.

The port's own copy of ``h264tpu/avc/intra_pred.py``; it imports nothing from ``h264tpu``.
"""

from __future__ import annotations

import numpy as np

# luma 4x4 mode numbers (spec 8.3.1.1)
VERT, HOR, DC, DIAG_DL, DIAG_DR, VERT_R, HOR_D, VERT_L, HOR_U = range(9)
# luma 16x16 mode numbers (spec 8.3.3): 0 V, 1 H, 2 DC, 3 Plane
I16_V, I16_H, I16_DC, I16_PLANE = range(4)
# chroma mode numbers (spec 8.3.4): 0 DC, 1 H, 2 V, 3 Plane
CH_DC, CH_H, CH_V, CH_PLANE = range(4)


def pred4x4_all(top9: np.ndarray, left4: np.ndarray, corner: int,
                avail_t: bool, avail_l: bool, avail_tr: bool):
    """All 9 predictions for one 4x4 block.

    top9: p[0..7, -1] (8 top + top-right samples; junk where unavailable);
    left4: p[-1, 0..3]; corner: p[-1, -1].
    Returns (preds [9, 4, 4] int64, allowed [9] bool).
    """
    t = top9.astype(np.int64).copy()
    if not avail_tr:
        t[4:] = t[3]                 # spec: substitute p[3,-1]
    l = left4.astype(np.int64)
    c = int(corner)

    P = lambda i: c if i == -1 else int(t[i])
    L = lambda i: c if i == -1 else int(l[i])

    preds = np.zeros((9, 4, 4), np.int64)
    allowed = np.zeros(9, bool)

    if avail_t:
        preds[VERT] = t[:4][None, :]
        allowed[VERT] = True
    if avail_l:
        preds[HOR] = l[:, None]
        allowed[HOR] = True

    if avail_t and avail_l:
        dc = (int(t[:4].sum()) + int(l.sum()) + 4) >> 3
    elif avail_t:
        dc = (int(t[:4].sum()) + 2) >> 2
    elif avail_l:
        dc = (int(l.sum()) + 2) >> 2
    else:
        dc = 128
    preds[DC] = dc
    allowed[DC] = True

    if avail_t:
        for r in range(4):
            for col in range(4):
                i = r + col
                preds[DIAG_DL, r, col] = ((P(6) + 3 * P(7) + 2) >> 2 if i == 6
                                          else (P(i) + 2 * P(i + 1) + P(i + 2) + 2) >> 2)
                i2 = col + (r >> 1)
                preds[VERT_L, r, col] = ((P(i2) + P(i2 + 1) + 1) >> 1 if r % 2 == 0
                                         else (P(i2) + 2 * P(i2 + 1) + P(i2 + 2) + 2) >> 2)
        allowed[DIAG_DL] = allowed[VERT_L] = True

    if avail_l:
        for r in range(4):
            for col in range(4):
                z = col + 2 * r
                i = r + (col >> 1)
                if z > 5:
                    v = L(3)
                elif z == 5:
                    v = (L(2) + 3 * L(3) + 2) >> 2
                elif z % 2 == 0:
                    v = (L(i) + L(i + 1) + 1) >> 1
                else:
                    v = (L(i) + 2 * L(i + 1) + L(i + 2) + 2) >> 2
                preds[HOR_U, r, col] = v
        allowed[HOR_U] = True

    if avail_t and avail_l:
        for r in range(4):
            for col in range(4):
                # diagonal down-right
                if col > r:
                    i = col - r
                    preds[DIAG_DR, r, col] = (P(i - 2) + 2 * P(i - 1) + P(i) + 2) >> 2
                elif col < r:
                    i = r - col
                    preds[DIAG_DR, r, col] = (L(i - 2) + 2 * L(i - 1) + L(i) + 2) >> 2
                else:
                    preds[DIAG_DR, r, col] = (P(0) + 2 * c + L(0) + 2) >> 2
                # vertical-right
                z = 2 * col - r
                i = col - (r >> 1)
                if z >= 0 and z % 2 == 0:
                    v = (P(i - 1) + P(i) + 1) >> 1
                elif z >= 0:
                    v = (P(i - 2) + 2 * P(i - 1) + P(i) + 2) >> 2
                elif z == -1:
                    v = (L(0) + 2 * c + P(0) + 2) >> 2
                else:
                    j = r - 2 * col
                    v = (L(j - 1) + 2 * L(j - 2) + L(j - 3) + 2) >> 2
                preds[VERT_R, r, col] = v
                # horizontal-down
                z = 2 * r - col
                i = r - (col >> 1)
                if z >= 0 and z % 2 == 0:
                    v = (L(i - 1) + L(i) + 1) >> 1
                elif z >= 0:
                    v = (L(i - 2) + 2 * L(i - 1) + L(i) + 2) >> 2
                elif z == -1:
                    v = (P(0) + 2 * c + L(0) + 2) >> 2
                else:
                    j = col - 2 * r
                    v = (P(j - 1) + 2 * P(j - 2) + P(j - 3) + 2) >> 2
                preds[HOR_D, r, col] = v
        allowed[DIAG_DR] = allowed[VERT_R] = allowed[HOR_D] = True

    return preds, allowed


def pred16x16_all(top16: np.ndarray, left16: np.ndarray, corner: int,
                  avail_t: bool, avail_l: bool):
    """All 4 I16x16 predictions. Returns ([4, 16, 16], allowed [4])."""
    t = top16.astype(np.int64)
    l = left16.astype(np.int64)
    preds = np.zeros((4, 16, 16), np.int64)
    allowed = np.zeros(4, bool)
    if avail_t:
        preds[I16_V] = t[None, :]
        allowed[I16_V] = True
    if avail_l:
        preds[I16_H] = l[:, None]
        allowed[I16_H] = True
    if avail_t and avail_l:
        dc = (int(t.sum()) + int(l.sum()) + 16) >> 5
    elif avail_t:
        dc = (int(t.sum()) + 8) >> 4
    elif avail_l:
        dc = (int(l.sum()) + 8) >> 4
    else:
        dc = 128
    preds[I16_DC] = dc
    allowed[I16_DC] = True
    if avail_t and avail_l:
        c = int(corner)
        # spec 8.3.3.4: H = sum (x'+1) * (p[8+x',-1] - p[6-x',-1]); p[-1,-1]=corner
        tt = np.concatenate([[c], t])      # tt[i] = p[i-1, -1]
        ll = np.concatenate([[c], l])
        h = sum((x + 1) * (int(tt[9 + x]) - int(tt[7 - x])) for x in range(8))
        v = sum((y + 1) * (int(ll[9 + y]) - int(ll[7 - y])) for y in range(8))
        a = 16 * (int(l[15]) + int(t[15]))
        b = (5 * h + 32) >> 6
        cc = (5 * v + 32) >> 6
        y_i, x_i = np.mgrid[0:16, 0:16]
        preds[I16_PLANE] = np.clip((a + b * (x_i - 7) + cc * (y_i - 7) + 16) >> 5,
                                   0, 255)
        allowed[I16_PLANE] = True
    return preds, allowed


def pred_chroma_all(top8: np.ndarray, left8: np.ndarray, corner: int,
                    avail_t: bool, avail_l: bool):
    """All 4 chroma 8x8 predictions (4:2:0). Returns ([4, 8, 8], allowed)."""
    t = top8.astype(np.int64)
    l = left8.astype(np.int64)
    preds = np.zeros((4, 8, 8), np.int64)
    allowed = np.zeros(4, bool)

    # DC: per-4x4 rules (JM ldecod intra_chroma_pred.c:72)
    def dc_all(bx, by):
        if avail_t and avail_l:
            return (int(t[bx:bx + 4].sum()) + int(l[by:by + 4].sum()) + 4) >> 3
        if avail_t:
            return (int(t[bx:bx + 4].sum()) + 2) >> 2
        if avail_l:
            return (int(l[by:by + 4].sum()) + 2) >> 2
        return 128

    def dc_single(bx, by, prefer_top):
        if (prefer_top and avail_t) or (not avail_l and avail_t):
            return (int(t[bx:bx + 4].sum()) + 2) >> 2
        if avail_l:
            return (int(l[by:by + 4].sum()) + 2) >> 2
        return 128

    preds[CH_DC, 0:4, 0:4] = dc_all(0, 0)
    preds[CH_DC, 0:4, 4:8] = dc_single(4, 0, prefer_top=True)
    preds[CH_DC, 4:8, 0:4] = dc_single(0, 4, prefer_top=False)
    preds[CH_DC, 4:8, 4:8] = dc_all(4, 4)
    allowed[CH_DC] = True

    if avail_l:
        preds[CH_H] = l[:, None]
        allowed[CH_H] = True
    if avail_t:
        preds[CH_V] = t[None, :]
        allowed[CH_V] = True
    if avail_t and avail_l:
        c = int(corner)
        tt = np.concatenate([[c], t])
        ll = np.concatenate([[c], l])
        h = sum((x + 1) * (int(tt[5 + x]) - int(tt[3 - x])) for x in range(4))
        v = sum((y + 1) * (int(ll[5 + y]) - int(ll[3 - y])) for y in range(4))
        a = 16 * (int(l[7]) + int(t[7]))
        b = (34 * h + 32) >> 6
        cc = (34 * v + 32) >> 6
        y_i, x_i = np.mgrid[0:8, 0:8]
        preds[CH_PLANE] = np.clip((a + b * (x_i - 3) + cc * (y_i - 3) + 16) >> 5,
                                  0, 255)
        allowed[CH_PLANE] = True
    return preds, allowed


def pred8x8_all(top16: np.ndarray, left8: np.ndarray, corner: int,
                avail_t: bool, avail_l: bool, avail_tr: bool,
                avail_c: bool):
    """All 9 Intra_8x8 predictions for one 8x8 block (spec 8.3.2).

    top16: p[0..15, -1] raw (8 top + 8 top-right samples; junk where
    unavailable); left8: p[-1, 0..7]; corner: p[-1, -1]; avail_c: the
    up-left sample's availability (per-block geometry — the caller
    derives it, ``JM/ldecod/src/intra8x8_pred.c`` block_available_up_left).
    Reference samples are low-pass filtered first (8.3.2.2.1), then the
    nine 4x4-style modes run on the filtered samples (8.3.2.2.2-10).
    Returns (preds [9, 8, 8] int64, allowed [9] bool).
    """
    t_raw = top16.astype(np.int64).copy()
    if avail_t and not avail_tr:
        t_raw[8:] = t_raw[7]            # substitute p[7,-1]
    l_raw = left8.astype(np.int64)
    c_raw = int(corner)

    # --- 8.3.2.2.1 reference sample filtering ---
    t = t_raw.copy()
    l = l_raw.copy()
    c = c_raw
    if avail_t:
        ext = np.empty(17, np.int64)
        ext[1:] = t_raw
        ext[0] = c_raw if avail_c else t_raw[0]
        t[0] = (ext[0] + 2 * t_raw[0] + t_raw[1] + 2) >> 2
        t[1:15] = (t_raw[0:14] + 2 * t_raw[1:15] + t_raw[2:16] + 2) >> 2
        t[15] = (t_raw[14] + 3 * t_raw[15] + 2) >> 2
    if avail_c:
        if avail_t and avail_l:
            c = (t_raw[0] + 2 * c_raw + l_raw[0] + 2) >> 2
        elif avail_t:
            c = (3 * c_raw + t_raw[0] + 2) >> 2
        elif avail_l:
            c = (3 * c_raw + l_raw[0] + 2) >> 2
    if avail_l:
        l[0] = ((c_raw + 2 * l_raw[0] + l_raw[1] + 2) >> 2 if avail_c
                else (3 * l_raw[0] + l_raw[1] + 2) >> 2)
        l[1:7] = (l_raw[0:6] + 2 * l_raw[1:7] + l_raw[2:8] + 2) >> 2
        l[7] = (l_raw[6] + 3 * l_raw[7] + 2) >> 2

    P = lambda i: c if i == -1 else int(t[i])
    L = lambda i: c if i == -1 else int(l[i])

    preds = np.zeros((9, 8, 8), np.int64)
    allowed = np.zeros(9, bool)

    if avail_t:
        preds[VERT] = t[:8][None, :]
        allowed[VERT] = True
    if avail_l:
        preds[HOR] = l[:, None]
        allowed[HOR] = True

    if avail_t and avail_l:
        dc = (int(t[:8].sum()) + int(l.sum()) + 8) >> 4
    elif avail_t:
        dc = (int(t[:8].sum()) + 4) >> 3
    elif avail_l:
        dc = (int(l.sum()) + 4) >> 3
    else:
        dc = 128
    preds[DC] = dc
    allowed[DC] = True

    if avail_t:
        for r in range(8):
            for col in range(8):
                i = r + col
                preds[DIAG_DL, r, col] = (
                    (P(14) + 3 * P(15) + 2) >> 2 if i == 14
                    else (P(i) + 2 * P(i + 1) + P(i + 2) + 2) >> 2)
                i2 = col + (r >> 1)
                preds[VERT_L, r, col] = (
                    (P(i2) + P(i2 + 1) + 1) >> 1 if r % 2 == 0
                    else (P(i2) + 2 * P(i2 + 1) + P(i2 + 2) + 2) >> 2)
        allowed[DIAG_DL] = allowed[VERT_L] = True

    if avail_l:
        for r in range(8):
            for col in range(8):
                z = col + 2 * r
                i = r + (col >> 1)
                if z > 13:
                    v = L(7)
                elif z == 13:
                    v = (L(6) + 3 * L(7) + 2) >> 2
                elif z % 2 == 0:
                    v = (L(i) + L(i + 1) + 1) >> 1
                else:
                    v = (L(i) + 2 * L(i + 1) + L(i + 2) + 2) >> 2
                preds[HOR_U, r, col] = v
        allowed[HOR_U] = True

    if avail_t and avail_l and avail_c:
        for r in range(8):
            for col in range(8):
                if col > r:
                    i = col - r
                    preds[DIAG_DR, r, col] = \
                        (P(i - 2) + 2 * P(i - 1) + P(i) + 2) >> 2
                elif col < r:
                    i = r - col
                    preds[DIAG_DR, r, col] = \
                        (L(i - 2) + 2 * L(i - 1) + L(i) + 2) >> 2
                else:
                    preds[DIAG_DR, r, col] = (P(0) + 2 * c + L(0) + 2) >> 2
                z = 2 * col - r
                i = col - (r >> 1)
                if z >= 0 and z % 2 == 0:
                    v = (P(i - 1) + P(i) + 1) >> 1
                elif z >= 0:
                    v = (P(i - 2) + 2 * P(i - 1) + P(i) + 2) >> 2
                elif z == -1:
                    v = (L(0) + 2 * c + P(0) + 2) >> 2
                else:
                    j = r - 2 * col
                    v = (L(j - 1) + 2 * L(j - 2) + L(j - 3) + 2) >> 2
                preds[VERT_R, r, col] = v
                z = 2 * r - col
                i = r - (col >> 1)
                if z >= 0 and z % 2 == 0:
                    v = (L(i - 1) + L(i) + 1) >> 1
                elif z >= 0:
                    v = (L(i - 2) + 2 * L(i - 1) + L(i) + 2) >> 2
                elif z == -1:
                    v = (P(0) + 2 * c + L(0) + 2) >> 2
                else:
                    j = col - 2 * r
                    v = (P(j - 1) + 2 * P(j - 2) + P(j - 3) + 2) >> 2
                preds[HOR_D, r, col] = v
        allowed[DIAG_DR] = allowed[VERT_R] = allowed[HOR_D] = True

    return preds, allowed
