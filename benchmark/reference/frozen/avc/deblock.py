"""Spec-exact H.264 in-loop deblocking filter (8.7), numpy host model.

Edge-processing order follows the standard exactly: macroblocks in raster
order; per MB all vertical edges left-to-right, then all horizontal edges
top-to-bottom, each filtering operation reading samples already modified by
previous operations (``JM/ldecod/src/loopFilter.c:91`` DeblockPicture /
``loop_filter_normal.c``).  The per-line filter math is shared with the
TPU-batched kernels in ``ops/deblock.py`` (same ALPHA/BETA/CLIP tables).

This ordering is what makes the output bit-exact with ``ldecod``; the
FVC-format codec uses the reordered TPU-parallel scan in ``ops/deblock.py``
instead (its decoder mirrors that scan).

The port's own copy of ``h264tpu/avc/deblock.py``; it imports nothing from ``h264tpu``.
"""

from __future__ import annotations

import numpy as np

from ..ops.deblock import ALPHA_TABLE, BETA_TABLE, CLIP_TAB
from . import quant as Q


def _filter_lines(p3, p2, p1, p0, q0, q1, q2, q3, bs, index_a: int,
                  index_b: int, luma: bool):
    """Filter a batch of edge lines (numpy port of ops.deblock math).

    p3..q3: [...] int64 samples across the edge; bs: per-line strength.
    Returns (p2', p1', p0', q0', q1', q2').
    """
    alpha = int(ALPHA_TABLE[index_a])
    beta = int(BETA_TABLE[index_b])
    tc0 = CLIP_TAB[index_a][np.clip(bs, 0, 4)].astype(np.int64)

    d0 = np.abs(p0 - q0)
    filt = (bs > 0) & (d0 < alpha) & (np.abs(p1 - p0) < beta) & \
        (np.abs(q1 - q0) < beta)
    ap = np.abs(p2 - p0) < beta
    aq = np.abs(q2 - q0) < beta

    if luma:
        tc = tc0 + ap.astype(np.int64) + aq.astype(np.int64)
    else:
        tc = tc0 + 1
    delta = np.clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    p0_n = np.clip(p0 + delta, 0, 255)
    q0_n = np.clip(q0 - delta, 0, 255)
    if luma:
        dp1 = np.clip((p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1, -tc0, tc0)
        dq1 = np.clip((q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1, -tc0, tc0)
        p1_n = np.where(ap, p1 + dp1, p1)
        q1_n = np.where(aq, q1 + dq1, q1)
    else:
        p1_n, q1_n = p1, q1

    small = d0 < ((alpha >> 2) + 2)
    if luma:
        sp = small & ap
        sq = small & aq
        p0_s = np.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                        (2 * p1 + p0 + q1 + 2) >> 2)
        p1_s = np.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
        p2_s = np.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
        q0_s = np.where(sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                        (2 * q1 + q0 + p1 + 2) >> 2)
        q1_s = np.where(sq, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
        q2_s = np.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)
    else:
        p0_s = (2 * p1 + p0 + q1 + 2) >> 2
        q0_s = (2 * q1 + q0 + p1 + 2) >> 2
        p1_s, p2_s, q1_s, q2_s = p1, p2, q1, q2

    strong = bs == 4
    sel = lambda s, n, o: np.where(filt, np.where(strong, s, n), o)
    return (np.where(filt & strong, p2_s, p2), sel(p1_s, p1_n, p1),
            sel(p0_s, p0_n, p0), sel(q0_s, q0_n, q0),
            sel(q1_s, q1_n, q1), np.where(filt & strong, q2_s, q2))


def _edge_v(plane, x: int, y0: int, n: int, bs, index_a, index_b, luma):
    """Filter the vertical edge at column x for rows y0..y0+n-1."""
    cols = plane[y0:y0 + n, x - 4:x + 4].astype(np.int64)
    out = _filter_lines(cols[:, 0], cols[:, 1], cols[:, 2], cols[:, 3],
                        cols[:, 4], cols[:, 5], cols[:, 6], cols[:, 7],
                        bs, index_a, index_b, luma)
    for i, v in enumerate(out):
        plane[y0:y0 + n, x - 3 + i] = v


def _edge_h(plane, y: int, x0: int, n: int, bs, index_a, index_b, luma):
    rows = plane[y - 4:y + 4, x0:x0 + n].astype(np.int64)
    out = _filter_lines(rows[0], rows[1], rows[2], rows[3],
                        rows[4], rows[5], rows[6], rows[7],
                        bs, index_a, index_b, luma)
    for i, v in enumerate(out):
        plane[y - 3 + i, x0:x0 + n] = v


class DeblockContext:
    """Per-frame inputs for bS derivation."""

    def __init__(self, mb_w: int, mb_h: int, qp: int,
                 chroma_qp_offset: int = 0):
        self.mb_w, self.mb_h = mb_w, mb_h
        self.mb_qp = np.full((mb_h, mb_w), qp, np.int64)
        self.mb_intra = np.ones((mb_h, mb_w), bool)
        # per-4x4-cell data for inter bS (ignored for intra MBs)
        self.nnz = np.zeros((mb_h * 4, mb_w * 4), np.int64)
        self.mv = np.zeros((mb_h * 4, mb_w * 4, 2), np.int64)  # 1/4-pel
        self.ref = np.zeros((mb_h * 4, mb_w * 4), np.int64)
        self.chroma_qp_offset = chroma_qp_offset
        self.alpha_off = 0
        self.beta_off = 0
        # optional second-list motion for B pictures: per-cell PICTURE ids
        # (-1 = list unused) + MVs.  When set, ``ref``/``mv`` above hold the
        # list-0 picture ids/MVs (-1 where list 0 unused).
        self.mv1 = None
        self.ref1 = None
        # High profile: MBs coded with transform_size_8x8_flag=1 do not
        # filter their internal 4x4 luma edges (spec 8.7: transform
        # block boundaries only)
        self.transform8 = np.zeros((mb_h, mb_w), bool)


def _mv_far(a, b):
    return (np.abs(a[..., 0] - b[..., 0]) >= 4) | \
           (np.abs(a[..., 1] - b[..., 1]) >= 4)


def _bs_edge(ctx: DeblockContext, by_p, bx_p, by_q, bx_q, mb_edge: bool):
    """bS between 4x4 cells p (by_p,bx_p) and q (spec 8.7.2.1), arrays ok."""
    mb_p = ctx.mb_intra[by_p // 4, bx_p // 4]
    mb_q = ctx.mb_intra[by_q // 4, bx_q // 4]
    intra = mb_p | mb_q
    coded = (ctx.nnz[by_p, bx_p] > 0) | (ctx.nnz[by_q, bx_q] > 0)
    mv_p, mv_q = ctx.mv[by_p, bx_p], ctx.mv[by_q, bx_q]
    r_p, r_q = ctx.ref[by_p, bx_p], ctx.ref[by_q, bx_q]
    if ctx.ref1 is None:
        moved = _mv_far(mv_p, mv_q) | (r_p != r_q)
    else:
        # two-list derivation: different picture sets or MV counts -> 1;
        # same single pic -> one comparison; same pic twice -> either
        # pairing small; two distinct pics -> match by picture
        mv1_p, mv1_q = ctx.mv1[by_p, bx_p], ctx.mv1[by_q, bx_q]
        r1_p, r1_q = ctx.ref1[by_p, bx_p], ctx.ref1[by_q, bx_q]
        lo_p = np.minimum(r_p, r1_p)
        hi_p = np.maximum(r_p, r1_p)
        lo_q = np.minimum(r_q, r1_q)
        hi_q = np.maximum(r_q, r1_q)
        diff_sets = (lo_p != lo_q) | (hi_p != hi_q)
        n_p = (r_p >= 0).astype(int) + (r1_p >= 0).astype(int)
        n_q = (r_q >= 0).astype(int) + (r1_q >= 0).astype(int)
        # single-MV cells: pick the used list's mv
        one_p = np.where((r_p >= 0)[..., None], mv_p, mv1_p)
        one_q = np.where((r_q >= 0)[..., None], mv_q, mv1_q)
        far1 = _mv_far(one_p, one_q)
        same_pic_twice = (r_p == r1_p)
        straight = _mv_far(mv_p, mv_q) | _mv_far(mv1_p, mv1_q)
        crossed = _mv_far(mv_p, mv1_q) | _mv_far(mv1_p, mv_q)
        far2_same = straight & crossed
        # distinct pics: pair by picture id (l0/l1 may be swapped)
        swap = (r_p == r1_q) & (r_p != r_q)
        far2_distinct = np.where(swap, crossed, straight)
        far2 = np.where(same_pic_twice, far2_same, far2_distinct)
        moved = diff_sets | (n_p != n_q) | \
            np.where(n_p == 1, far1, far2)
    bs = np.where(coded, 2, np.where(moved, 1, 0))
    return np.where(intra, 4 if mb_edge else 3, bs)


def deblock_frame(rec_y, rec_u, rec_v, ctx: DeblockContext):
    """Apply the full spec deblocking process in place; returns the planes."""
    y = rec_y.astype(np.int64).copy()
    u = rec_u.astype(np.int64).copy()
    v = rec_v.astype(np.int64).copy()
    rows4 = np.arange(4)

    for mby in range(ctx.mb_h):
        for mbx in range(ctx.mb_w):
            qp = int(ctx.mb_qp[mby, mbx])
            py, px = mby * 16, mbx * 16
            cy, cx = mby * 8, mbx * 8

            t8 = bool(ctx.transform8[mby, mbx])

            # ---------- vertical edges, left to right ----------
            for e in range(4):
                if e == 0 and mbx == 0:
                    continue
                if t8 and e in (1, 3):  # 8x8 transform: no internal
                    continue            # 4x4 luma edges (spec 8.7)
                x = px + 4 * e
                mb_edge = e == 0
                qp_p = int(ctx.mb_qp[mby, mbx - 1]) if mb_edge else qp
                qp_av = (qp_p + qp + 1) >> 1
                ia = min(max(qp_av + ctx.alpha_off, 0), 51)
                ib = min(max(qp_av + ctx.beta_off, 0), 51)
                bx_q = x // 4
                bs_cells = _bs_edge(ctx, mby * 4 + rows4, bx_q - 1,
                                    mby * 4 + rows4, bx_q, mb_edge)
                bs = np.repeat(bs_cells, 4)
                _edge_v(y, x, py, 16, bs, ia, ib, True)
                if e in (0, 2):        # chroma vertical edges at cx 0 and 4
                    qpc_p = Q.chroma_qp(qp_p, ctx.chroma_qp_offset)
                    qpc_q = Q.chroma_qp(qp, ctx.chroma_qp_offset)
                    qpc_av = (qpc_p + qpc_q + 1) >> 1
                    ia_c = min(max(qpc_av + ctx.alpha_off, 0), 51)
                    ib_c = min(max(qpc_av + ctx.beta_off, 0), 51)
                    bs_c = np.repeat(bs_cells, 2)
                    xc = cx + 2 * e
                    _edge_v(u, xc, cy, 8, bs_c, ia_c, ib_c, False)
                    _edge_v(v, xc, cy, 8, bs_c, ia_c, ib_c, False)

            # ---------- horizontal edges, top to bottom ----------
            for e in range(4):
                if e == 0 and mby == 0:
                    continue
                if t8 and e in (1, 3):
                    continue
                yy = py + 4 * e
                mb_edge = e == 0
                qp_p = int(ctx.mb_qp[mby - 1, mbx]) if mb_edge else qp
                qp_av = (qp_p + qp + 1) >> 1
                ia = min(max(qp_av + ctx.alpha_off, 0), 51)
                ib = min(max(qp_av + ctx.beta_off, 0), 51)
                by_q = yy // 4
                bs_cells = _bs_edge(ctx, by_q - 1, mbx * 4 + rows4,
                                    by_q, mbx * 4 + rows4, mb_edge)
                bs = np.repeat(bs_cells, 4)
                _edge_h(y, yy, px, 16, bs, ia, ib, True)
                if e in (0, 2):
                    qpc_p = Q.chroma_qp(qp_p, ctx.chroma_qp_offset)
                    qpc_q = Q.chroma_qp(qp, ctx.chroma_qp_offset)
                    qpc_av = (qpc_p + qpc_q + 1) >> 1
                    ia_c = min(max(qpc_av + ctx.alpha_off, 0), 51)
                    ib_c = min(max(qpc_av + ctx.beta_off, 0), 51)
                    bs_c = np.repeat(bs_cells, 2)
                    yc = cy + 2 * e
                    _edge_h(u, yc, cx, 8, bs_c, ia_c, ib_c, False)
                    _edge_h(v, yc, cx, 8, bs_c, ia_c, ib_c, False)
    return y, u, v
