"""Spec-exact H.264 intra prediction on tensors (spec 8.3.1/8.3.3/8.3.4).

Port of ``h264tpu/avc/intra_jax.py``.  The nine 4x4 directional modes are one
table-driven weighted gather over the 13-sample neighbour vector ``s =
[corner, top0..7, left0..3]``; the (index, weight, round, shift) tables are
built at import time by replaying the spec formulas.  Availability flags are
bool tensors per block; disallowed modes return garbage predictions and are
masked by cost.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device_const

# mode numbers (spec 8.3.1.1 / 8.3.3 / 8.3.4) — match avc.intra_pred
VERT, HOR, DC, DIAG_DL, DIAG_DR, VERT_R, HOR_D, VERT_L, HOR_U = range(9)
I16_V, I16_H, I16_DC, I16_PLANE = range(4)
CH_DC, CH_H, CH_V, CH_PLANE = range(4)


def _build_i4_tables():
    """-> IDX [9,16,3], W [9,16,3], RND [9,16], SH [9,16] (DC rows zero)."""
    IDX = np.zeros((9, 16, 3), np.int64)
    W = np.zeros((9, 16, 3), np.int32)
    RND = np.zeros((9, 16), np.int32)
    SH = np.zeros((9, 16), np.int32)

    def P(i):                       # top row sample index in s
        return 0 if i < 0 else 1 + i

    def L(i):                       # left col sample index in s
        return 0 if i < 0 else 9 + i

    def put(m, r, c, terms, rnd, sh):
        k = r * 4 + c
        for j, (idx, w) in enumerate(terms):
            IDX[m, k, j] = idx
            W[m, k, j] = w
        RND[m, k] = rnd
        SH[m, k] = sh

    for r in range(4):
        for c in range(4):
            put(VERT, r, c, [(P(c), 1)], 0, 0)
            put(HOR, r, c, [(L(r), 1)], 0, 0)

            i = r + c
            if i == 6:
                put(DIAG_DL, r, c, [(P(6), 1), (P(7), 3)], 2, 2)
            else:
                put(DIAG_DL, r, c, [(P(i), 1), (P(i + 1), 2), (P(i + 2), 1)],
                    2, 2)

            i2 = c + (r >> 1)
            if r % 2 == 0:
                put(VERT_L, r, c, [(P(i2), 1), (P(i2 + 1), 1)], 1, 1)
            else:
                put(VERT_L, r, c,
                    [(P(i2), 1), (P(i2 + 1), 2), (P(i2 + 2), 1)], 2, 2)

            z = c + 2 * r
            i = r + (c >> 1)
            if z > 5:
                put(HOR_U, r, c, [(L(3), 1)], 0, 0)
            elif z == 5:
                put(HOR_U, r, c, [(L(2), 1), (L(3), 3)], 2, 2)
            elif z % 2 == 0:
                put(HOR_U, r, c, [(L(i), 1), (L(i + 1), 1)], 1, 1)
            else:
                put(HOR_U, r, c, [(L(i), 1), (L(i + 1), 2), (L(i + 2), 1)],
                    2, 2)

            # diagonal down-right
            if c > r:
                i = c - r
                put(DIAG_DR, r, c, [(P(i - 2), 1), (P(i - 1), 2), (P(i), 1)],
                    2, 2)
            elif c < r:
                i = r - c
                put(DIAG_DR, r, c, [(L(i - 2), 1), (L(i - 1), 2), (L(i), 1)],
                    2, 2)
            else:
                put(DIAG_DR, r, c, [(P(0), 1), (0, 2), (L(0), 1)], 2, 2)

            # vertical-right
            z = 2 * c - r
            i = c - (r >> 1)
            if z >= 0 and z % 2 == 0:
                put(VERT_R, r, c, [(P(i - 1), 1), (P(i), 1)], 1, 1)
            elif z >= 0:
                put(VERT_R, r, c, [(P(i - 2), 1), (P(i - 1), 2), (P(i), 1)],
                    2, 2)
            elif z == -1:
                put(VERT_R, r, c, [(L(0), 1), (0, 2), (P(0), 1)], 2, 2)
            else:
                j = r - 2 * c
                put(VERT_R, r, c,
                    [(L(j - 1), 1), (L(j - 2), 2), (L(j - 3), 1)], 2, 2)

            # horizontal-down
            z = 2 * r - c
            i = r - (c >> 1)
            if z >= 0 and z % 2 == 0:
                put(HOR_D, r, c, [(L(i - 1), 1), (L(i), 1)], 1, 1)
            elif z >= 0:
                put(HOR_D, r, c, [(L(i - 2), 1), (L(i - 1), 2), (L(i), 1)],
                    2, 2)
            elif z == -1:
                put(HOR_D, r, c, [(P(0), 1), (0, 2), (L(0), 1)], 2, 2)
            else:
                j = c - 2 * r
                put(HOR_D, r, c,
                    [(P(j - 1), 1), (P(j - 2), 2), (P(j - 3), 1)], 2, 2)
    return IDX, W, RND, SH


_I4_TABLES = dict(zip(("i4_idx", "i4_w", "i4_rnd", "i4_sh"),
                      _build_i4_tables()))


def _dc(sum_t, sum_l, avail_t, avail_l, shift: int):
    """DC of a block whose top and left sums cover 2**(shift-1) samples each."""
    half = 1 << (shift - 2)
    return torch.where(avail_t & avail_l, (sum_t + sum_l + 2 * half) >> shift,
                       torch.where(avail_t, (sum_t + half) >> (shift - 1),
                                   torch.where(avail_l,
                                               (sum_l + half) >> (shift - 1),
                                               128)))


def pred4x4_all(top9, left4, corner, avail_t, avail_l, avail_tr):
    """All 9 predictions for a batch of 4x4 blocks.

    top9 [..., 8], left4 [..., 4], corner [...]; avail_* bool [...].
    Returns (preds [..., 9, 4, 4] int32, allowed [..., 9] bool)."""
    dev = top9.device
    t = top9.to(torch.int32)
    # top-right substitution: p[4..7] = p[3] when unavailable
    t = torch.where(avail_tr[..., None], t,
                    torch.cat([t[..., :4], t[..., 3:4].expand(*t.shape[:-1], 4)],
                              dim=-1))
    l = left4.to(torch.int32)
    c = corner.to(torch.int32)
    s = torch.cat([c[..., None], t, l], dim=-1)                  # [..., 13]
    tb = {k: device_const(k, v, dev) for k, v in _I4_TABLES.items()}
    g = s[..., tb["i4_idx"]]                                      # [...,9,16,3]
    preds = ((g * tb["i4_w"]).sum(-1, dtype=torch.int32)
             + tb["i4_rnd"]) >> tb["i4_sh"]                       # [..., 9, 16]
    dc = _dc(t[..., :4].sum(-1, dtype=torch.int32),
             l.sum(-1, dtype=torch.int32), avail_t, avail_l, 3)
    preds = torch.cat([preds[..., :DC, :],
                       dc[..., None, None].expand(*dc.shape, 1, 16),
                       preds[..., DC + 1:, :]], dim=-2)
    al_t = avail_t[..., None]
    al_l = avail_l[..., None]
    tl = al_t & al_l
    allowed = torch.cat([al_t, al_l, torch.ones_like(al_t), al_t, tl, tl, tl,
                         al_t, al_l], dim=-1)
    return preds.reshape(*preds.shape[:-1], 4, 4), allowed


def _plane(t, l, c, n: int, scale: int):
    """Spec plane prediction of an n x n block (8.3.3.4 / 8.3.4.4)."""
    dev = t.device
    half = n // 2
    tt = torch.cat([c[..., None], t], dim=-1)        # tt[i] = p[i-1, -1]
    ll = torch.cat([c[..., None], l], dim=-1)
    xw = torch.arange(1, half + 1, dtype=torch.int32, device=dev)
    h = (xw * (tt[..., half + 1:n + 1] - torch.flip(tt[..., 0:half], [-1]))
         ).sum(-1, dtype=torch.int32)
    v = (xw * (ll[..., half + 1:n + 1] - torch.flip(ll[..., 0:half], [-1]))
         ).sum(-1, dtype=torch.int32)
    a = 16 * (l[..., n - 1] + t[..., n - 1])
    b = (scale * h + 32) >> 6
    cc = (scale * v + 32) >> 6
    yi = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    xi = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    return torch.clamp((a[..., None, None] + b[..., None, None] * (xi - (half - 1))
                        + cc[..., None, None] * (yi - (half - 1)) + 16) >> 5,
                       0, 255)


def pred16x16_all(top16, left16, corner, avail_t, avail_l):
    """top16 [..., 16], left16 [..., 16], corner [...] -> (preds [..., 4,
    16, 16], allowed [..., 4])."""
    t = top16.to(torch.int32)
    l = left16.to(torch.int32)
    c = corner.to(torch.int32)
    shp = t.shape[:-1]
    pv = t[..., None, :].expand(*shp, 16, 16)
    ph = l[..., :, None].expand(*shp, 16, 16)
    dc = _dc(t.sum(-1, dtype=torch.int32), l.sum(-1, dtype=torch.int32),
             avail_t, avail_l, 5)
    pdc = dc[..., None, None].expand(*shp, 16, 16)
    preds = torch.stack([pv, ph, pdc, _plane(t, l, c, 16, 5)], dim=-3)
    tru = torch.ones(shp, dtype=torch.bool, device=t.device)
    allowed = torch.stack([avail_t & tru, avail_l & tru, tru,
                           avail_t & avail_l], dim=-1)
    return preds, allowed


def pred_chroma_all(top8, left8, corner, avail_t, avail_l):
    """top8 [..., 8], left8 [..., 8] -> (preds [..., 4, 8, 8], allowed
    [..., 4])."""
    t = top8.to(torch.int32)
    l = left8.to(torch.int32)
    c = corner.to(torch.int32)
    shp = t.shape[:-1]

    def sums(bx, by):
        return (t[..., bx:bx + 4].sum(-1, dtype=torch.int32),
                l[..., by:by + 4].sum(-1, dtype=torch.int32))

    def dc_single(bx, by, prefer_top):
        st, sl = sums(bx, by)
        st, sl = (st + 2) >> 2, (sl + 2) >> 2
        if prefer_top:
            return torch.where(avail_t, st, torch.where(avail_l, sl, 128))
        return torch.where(avail_l, sl, torch.where(avail_t, st, 128))

    d00 = _dc(*sums(0, 0), avail_t, avail_l, 3)
    d01 = dc_single(4, 0, True)
    d10 = dc_single(0, 4, False)
    d11 = _dc(*sums(4, 4), avail_t, avail_l, 3)
    quad = torch.stack([torch.stack([d00, d01], -1),
                        torch.stack([d10, d11], -1)], -2)     # [..., 2, 2]
    pdc = quad.repeat_interleave(4, dim=-2).repeat_interleave(4, dim=-1)
    ph = l[..., :, None].expand(*shp, 8, 8)
    pv = t[..., None, :].expand(*shp, 8, 8)
    preds = torch.stack([pdc, ph, pv, _plane(t, l, c, 8, 34)], dim=-3)
    tru = torch.ones(shp, dtype=torch.bool, device=t.device)
    allowed = torch.stack([tru, avail_l & tru, avail_t & tru,
                           avail_t & avail_l], dim=-1)
    return preds, allowed
