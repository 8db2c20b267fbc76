"""Conformant H.264 inter prediction: quarter-pel MC, MV prediction, ME.

Interpolation is the spec 8.4.2.2.1 process (6-tap (1,-5,20,20,-5,1) half-pel
with unclipped intermediates for the center position, bilinear quarter-pel
averages; chroma 1/8-pel bilinear) — the decode twin is
``JM/ldecod/src/mc_prediction.c:902`` get_block_luma.  MV prediction is spec
8.4.1.3 (median over A/B/C with the single-matching-ref shortcut and the
P_Skip zero conditions; JM twin ``JM/lcommon/src/mv_prediction.c``).

The motion search here is the host conformance model (full search + half /
quarter refinement, SAD + lambda * MVD bits, JM's in-loop median predictor);
the TPU-batched search lives in ``ops/me.py`` and is validated against it.

The port's own copy of ``h264tpu/avc/inter.py``; it imports nothing from ``h264tpu``.
"""

from __future__ import annotations

import numpy as np

PAD = 32          # edge padding (covers SR + 3-tap apron)


class RefPlanes:
    """Half-pel interpolated planes of one reference frame (luma) + padded
    chroma, computed once per reference picture."""

    def __init__(self, y: np.ndarray, u: np.ndarray, v: np.ndarray):
        self.h, self.w = y.shape
        yi = np.pad(y.astype(np.int64), PAD, mode="edge")
        # horizontal 6-tap intermediates b1 (no shift), vertical h1
        def tap6(a, axis):
            s = [np.roll(a, k, axis=axis) for k in (2, 1, 0, -1, -2, -3)]
            return s[0] - 5 * s[1] + 20 * s[2] + 20 * s[3] - 5 * s[4] + s[5]

        b1 = tap6(yi, 1)                     # half-pel x, integer y
        h1 = tap6(yi, 0)                     # integer x, half-pel y
        j1 = tap6(b1, 0)                     # half-pel x + y (unclipped chain)
        self.G = yi
        self.b = np.clip((b1 + 16) >> 5, 0, 255)
        self.hh = np.clip((h1 + 16) >> 5, 0, 255)
        self.j = np.clip((j1 + 512) >> 10, 0, 255)
        self.u = np.pad(u.astype(np.int64), PAD, mode="edge")
        self.v = np.pad(v.astype(np.int64), PAD, mode="edge")

    def luma_block(self, y0: int, x0: int, bh: int, bw: int,
                   mvx: int, mvy: int) -> np.ndarray:
        """Predicted block; (mvx, mvy) in quarter-pel units."""
        ix, fx = mvx >> 2, mvx & 3
        iy, fy = mvy >> 2, mvy & 3
        r0, c0 = y0 + iy + PAD, x0 + ix + PAD

        def grab(plane, dy=0, dx=0):
            return plane[r0 + dy:r0 + dy + bh, c0 + dx:c0 + dx + bw]

        G, b, h, j = self.G, self.b, self.hh, self.j
        if fx == 0 and fy == 0:
            return grab(G)
        if fy == 0:                      # a, b, c
            if fx == 2:
                return grab(b)
            return (grab(G, 0, fx // 2) + grab(b) + 1) >> 1
        if fx == 0:                      # d, h, n
            if fy == 2:
                return grab(h)
            return (grab(G, fy // 2, 0) + grab(h) + 1) >> 1
        if fx == 2 and fy == 2:
            return grab(j)
        if fx == 2:                      # f, q: avg(b or j?) spec: f=(b+j)/2, q=(j+s)/2
            return (grab(j) + grab(b, fy // 2, 0) + 1) >> 1
        if fy == 2:                      # i, k: avg(h, j)
            return (grab(j) + grab(h, 0, fx // 2) + 1) >> 1
        # e, g, p, r: avg of nearest b and h samples
        return (grab(b, fy // 2, 0) + grab(h, 0, fx // 2) + 1) >> 1

    def chroma_block(self, comp: str, y0: int, x0: int, bh: int, bw: int,
                     mvx: int, mvy: int) -> np.ndarray:
        """Chroma MC: block coords in chroma samples, mv in luma quarter-pel
        (= chroma eighth-pel).  Spec 8.4.2.2.2 bilinear."""
        plane = self.u if comp == "u" else self.v
        ix, fx = mvx >> 3, mvx & 7
        iy, fy = mvy >> 3, mvy & 7
        r0, c0 = y0 + iy + PAD, x0 + ix + PAD
        A = plane[r0:r0 + bh, c0:c0 + bw]
        B = plane[r0:r0 + bh, c0 + 1:c0 + 1 + bw]
        C = plane[r0 + 1:r0 + 1 + bh, c0:c0 + bw]
        D = plane[r0 + 1:r0 + 1 + bh, c0 + 1:c0 + 1 + bw]
        return ((8 - fx) * (8 - fy) * A + fx * (8 - fy) * B +
                (8 - fx) * fy * C + fx * fy * D + 32) >> 6


# ---------------------------------------------------------------------------
# MV prediction (spec 8.4.1.3)
# ---------------------------------------------------------------------------

class MVField:
    """Per-4x4-cell MV/ref state of the frame being encoded.

    Two notions per spec: *availability* (inside picture AND already decoded,
    6.4.11) and the prediction data (mv, ref) — intra cells are available but
    contribute mv = 0 / ref = -1 (spec 8.4.1.3.2).
    """

    def __init__(self, mb_h: int, mb_w: int):
        self.mv = np.zeros((mb_h * 4, mb_w * 4, 2), np.int64)
        self.ref = np.full((mb_h * 4, mb_w * 4), -1, np.int64)
        self.decoded = np.zeros((mb_h * 4, mb_w * 4), bool)
        self.h4, self.w4 = mb_h * 4, mb_w * 4

    def cell(self, by: int, bx: int):
        """(mv, ref, available) with picture-boundary handling."""
        if by < 0 or bx < 0 or bx >= self.w4 or by >= self.h4 or \
                not self.decoded[by, bx]:
            return np.zeros(2, np.int64), -1, False
        return self.mv[by, bx], int(self.ref[by, bx]), True

    def predict(self, by: int, bx: int, bw4: int, bh4: int, ref_idx: int,
                part: str = "none"):
        """Median MV predictor for a partition at block coords (by, bx) of
        size (bw4, bh4) 4x4 units.  ``part``: '16x8_top'/'16x8_bot'/
        '8x16_left'/'8x16_right' enable the directional shortcuts."""
        mv_a, ref_a, av_a = self.cell(by, bx - 1)
        mv_b, ref_b, av_b = self.cell(by - 1, bx)
        mv_c, ref_c, av_c = self.cell(by - 1, bx + bw4)
        # spec above-right geometry override (ldecod get_neighbors,
        # macroblock.c): when C falls inside the current MB's not-yet-
        # decoded right side it is unavailable REGARDLESS of any motion
        # data already present (B direct sub-blocks are pre-derived, so
        # the decoded mask alone would wrongly admit them as C)
        cy_in = by & 3
        cx_in = bx & 3
        if cy_in > 0:
            if cx_in < 2:
                if cy_in == 2:
                    if bw4 == 4:
                        av_c = False
                elif cx_in + bw4 == 2:
                    av_c = False
            elif cx_in + bw4 == 4:
                av_c = False
        if not av_c:                     # outside / undecoded -> D
            mv_c, ref_c, av_c = self.cell(by - 1, bx - 1)

        # directional shortcuts (8.4.1.3.1 cases)
        if part == "16x8_top" and ref_b == ref_idx:
            return mv_b.copy()
        if part == "16x8_bot" and ref_a == ref_idx:
            return mv_a.copy()
        if part == "8x16_left" and ref_a == ref_idx:
            return mv_a.copy()
        if part == "8x16_right" and ref_c == ref_idx:
            return mv_c.copy()

        # only A available (B, C both unavailable => also D was unavailable)
        if av_a and not av_b and not av_c:
            return mv_a.copy()
        match = [(ref_a == ref_idx, mv_a), (ref_b == ref_idx, mv_b),
                 (ref_c == ref_idx, mv_c)]
        hits = [m for ok, m in match if ok]
        if len(hits) == 1:
            return hits[0].copy()
        stack = np.stack([mv_a, mv_b, mv_c])
        return np.median(stack, axis=0).astype(np.int64)

    def skip_mv(self, by: int, bx: int):
        """P_Skip MV derivation (8.4.1.1)."""
        mv_a, ref_a, av_a = self.cell(by, bx - 1)
        mv_b, ref_b, av_b = self.cell(by - 1, bx)
        if (not av_a) or (not av_b):
            return np.zeros(2, np.int64)
        if (ref_a == 0 and mv_a[0] == 0 and mv_a[1] == 0) or \
           (ref_b == 0 and mv_b[0] == 0 and mv_b[1] == 0):
            return np.zeros(2, np.int64)
        return self.predict(by, bx, 4, 4, 0)

    def set_partition(self, by, bx, bw4, bh4, mv, ref):
        self.mv[by:by + bh4, bx:bx + bw4] = mv
        self.ref[by:by + bh4, bx:bx + bw4] = ref
        self.decoded[by:by + bh4, bx:bx + bw4] = True


def mvd_bits(dx: int, dy: int) -> int:
    """Exact se(v) bit cost of an MVD pair."""
    def se_len(v):
        k = 2 * v - 1 if v > 0 else -2 * v
        n = 0
        while (k + 1) >> (n + 1):
            n += 1
        return 2 * n + 1
    return se_len(int(dx)) + se_len(int(dy))


# ---------------------------------------------------------------------------
# Motion estimation (host conformance model)
# ---------------------------------------------------------------------------

_H4 = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]],
               np.int64)


def satd(diff: np.ndarray) -> int:
    """4x4 Hadamard SATD of a residual block batch (JM me_distortion.c:1565
    HadamardSAD4x4 semantics: sum |H d H| then (s+1)>>1 per 4x4)."""
    bh, bw = diff.shape
    b = diff.reshape(bh // 4, 4, bw // 4, 4).transpose(0, 2, 1, 3)
    t = np.einsum("ij,...jk,kl->...il", _H4, b, _H4)
    s = np.abs(t).sum(axis=(-1, -2))
    return int(((s + 1) >> 1).sum())


ME_EVALS = 0           # integer-stage SAD evaluations (test observability)


def _subpel_refine(blk, ref, y0, x0, bh, bw, best, pmx, pmy,
                   lam_sqrt, use_satd):
    """Half- then quarter-pel 8-neighbor refinement around the integer
    best (shared by every integer-stage strategy)."""
    bx_, by_ = best[1], best[2]
    if use_satd:
        # re-anchor the integer best with the SATD metric before refining
        pred = ref.luma_block(y0, x0, bh, bw, bx_, by_)
        best = (satd(blk - pred) + lam_sqrt * mvd_bits(bx_ - pmx, by_ - pmy),
                bx_, by_)
    for step in (2, 1):
        center = (bx_, by_)
        for ddy in (-step, 0, step):
            for ddx in (-step, 0, step):
                if ddx == 0 and ddy == 0:
                    continue
                mvx, mvy = center[0] + ddx, center[1] + ddy
                pred = ref.luma_block(y0, x0, bh, bw, mvx, mvy)
                d = satd(blk - pred) if use_satd else \
                    int(np.abs(pred - blk).sum())
                cost = d + lam_sqrt * mvd_bits(mvx - pmx, mvy - pmy)
                if cost < best[0]:
                    best = (cost, mvx, mvy)
        bx_, by_ = best[1], best[2]
    return np.array([best[1], best[2]], np.int64), best[0]


def full_search_block(org: np.ndarray, ref: RefPlanes, y0: int, x0: int,
                      bh: int, bw: int, sr: int, pred_mv, lam_sqrt: float,
                      use_satd: bool = False):
    """Integer full search (SAD) + half/quarter refinement for one block.

    Returns (mv_q [2], cost).  Costs are SAD + lam_sqrt * mvd_bits; the
    subpel refinement optionally uses SATD (JM Hadamard option, cfg
    ``hadamard``; integer stage stays SAD like JM).
    """
    global ME_EVALS
    blk = org[y0:y0 + bh, x0:x0 + bw].astype(np.int64)
    G = ref.G
    # integer search: vectorized window SADs
    pmx, pmy = int(pred_mv[0]), int(pred_mv[1])
    r0, c0 = y0 + PAD, x0 + PAD
    win = G[r0 - sr:r0 + sr + bh, c0 - sr:c0 + sr + bw]
    best = None
    for dy in range(-sr, sr + 1):
        row = win[dy + sr:dy + sr + bh]
        for dx in range(-sr, sr + 1):
            sad = int(np.abs(row[:, dx + sr:dx + sr + bw] - blk).sum())
            cost = sad + lam_sqrt * mvd_bits(4 * dx - pmx, 4 * dy - pmy)
            if best is None or cost < best[0]:
                best = (cost, dx * 4, dy * 4)
    ME_EVALS += (2 * sr + 1) ** 2
    return _subpel_refine(blk, ref, y0, x0, bh, bw, best, pmx, pmy,
                          lam_sqrt, use_satd)


def umhex_search_block(org: np.ndarray, ref: RefPlanes, y0: int, x0: int,
                       bh: int, bw: int, sr: int, pred_mv,
                       lam_sqrt: float, use_satd: bool = False):
    """UMHexagonS-shaped fast integer search (JM ``me_umhex.c``
    UMHEXIntegerPelBlockMotionSearch stages, SAD metric):
    start {(0,0), rounded MV prediction} -> small cross -> unsymmetrical
    cross (wide horizontal, half-range vertical) -> 5x5 window ->
    16-point multi-hexagon grid at growing scales -> extended-hexagon /
    small-diamond descent until the center holds.  Same contract as
    :func:`full_search_block` (the ¼-pel refinement is shared)."""
    global ME_EVALS
    blk = org[y0:y0 + bh, x0:x0 + bw].astype(np.int64)
    G = ref.G
    pmx, pmy = int(pred_mv[0]), int(pred_mv[1])
    r0, c0 = y0 + PAD, x0 + PAD
    seen = set()
    best = [None]

    def ev(dx, dy):
        if not (-sr <= dx <= sr and -sr <= dy <= sr) or (dx, dy) in seen:
            return
        seen.add((dx, dy))
        sad = int(np.abs(G[r0 + dy:r0 + dy + bh,
                           c0 + dx:c0 + dx + bw] - blk).sum())
        cost = sad + lam_sqrt * mvd_bits(4 * dx - pmx, 4 * dy - pmy)
        if best[0] is None or cost < best[0][0]:
            best[0] = (cost, dx * 4, dy * 4)

    # stage 1: origin + prediction
    ev(0, 0)
    ev(int(round(pmx / 4.0)), int(round(pmy / 4.0)))
    # stage 2: small cross around the better start
    cx, cy = best[0][1] // 4, best[0][2] // 4
    for d in (1, 2):
        for dx, dy in ((d, 0), (-d, 0), (0, d), (0, -d)):
            ev(cx + dx, cy + dy)
    # stage 3: unsymmetrical cross (full horizontal, half vertical)
    for dx in range(-sr, sr + 1, 2):
        ev(cx + dx, cy)
    for dy in range(-sr // 2, sr // 2 + 1, 2):
        ev(cx, cy + dy)
    # stage 4: 5x5 window around the running best
    cx, cy = best[0][1] // 4, best[0][2] // 4
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            ev(cx + dx, cy + dy)
    # stage 5: 16-point multi-hexagon grid
    hexpts = ((-4, 0), (-4, 1), (-4, 2), (-2, 3), (0, 4), (2, 3),
              (4, 2), (4, 1), (4, 0), (4, -1), (4, -2), (2, -3),
              (0, -4), (-2, -3), (-4, -2), (-4, -1))
    for scale in range(1, max(sr // 4, 1) + 1):
        for hx, hy in hexpts:
            ev(cx + hx * scale, cy + hy * scale)
    # stage 6: extended hexagon then small diamond until center holds
    for pattern in (((2, 0), (-2, 0), (1, 2), (-1, 2), (1, -2), (-1, -2)),
                    ((1, 0), (-1, 0), (0, 1), (0, -1))):
        for _ in range(sr):
            cx, cy = best[0][1] // 4, best[0][2] // 4
            for dx, dy in pattern:
                ev(cx + dx, cy + dy)
            if (best[0][1] // 4, best[0][2] // 4) == (cx, cy):
                break
    ME_EVALS += len(seen)
    return _subpel_refine(blk, ref, y0, x0, bh, bw, best[0], pmx, pmy,
                          lam_sqrt, use_satd)
