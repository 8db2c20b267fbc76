"""Conformant H.264 frame encoder on tensors (IPPP, CAVLC, 4x4 transform).

Port of the P/I path of ``h264tpu/avc/tpu_enc.py``: the whole per-frame
decision process — integer motion search over the candidate lattice (Stage
A), quarter-pel refinement (Stage B), and the wavefront decision scan with
full-RD mode decision, intra 4x4/16x16/chroma prediction, residual coding and
reconstruction — runs as tensor ops on one device; only the bit packing stays
on the host (``avc/pack.py``), consuming the per-MB symbol arrays emitted
here.

Layout differs from the JAX package where that changes no result:

* Stages A and B run once over the whole frame instead of once per row-band
  slice.  Every window they read lies inside its band's view (the search
  range is smaller than the padding), and the pass-2 median predictor takes
  its top-row availability from the band-local MB row, so each MB gets the
  numbers the per-band search gives it.
* The decision scan is a Python loop over the ``mb_w + 2*(sb_h - 1)``
  wavefront steps; each step evaluates one MB in every MB row of the frame
  (``mb_h`` lanes: ``sb_h`` rows of each of the ``n_slices`` bands) with
  every tensor batched over the lanes.  Windows are gathers over the lane
  axis whose starts are clamped like ``jax.lax.dynamic_slice``.

Floating point follows XLA's CPU backend, which contracts every ``x +
lam*y`` of the RD costs into one fused multiply-add: :func:`_fma` rounds an
exact float64 product-sum once to float32, on either device.  The lambda
values are the JAX package's float32 bits, carried as a table.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device_const
from ..ops.me import sixtap_phases, edge_pad
from ..ops.transform import COEFF_COST
from . import quant_dev as Q
from . import intra_dev as IP
from . import cavlc_dev as CD
from .cavlc_dev import bitlen
from .tables import BLOCK_SCAN, BLOCK_SCAN_INV, CBP_TO_CODENUM_INTER

BIG = 1e18            # float32(1e18) once a float32 tensor takes it

# partition slots in 8x8-cell units: (cy, cx, ch, cw)
SLOTS = ((0, 0, 2, 2),                      # 0: 16x16
         (0, 0, 1, 2), (1, 0, 1, 2),        # 1,2: 16x8 top/bot
         (0, 0, 2, 1), (0, 1, 2, 1),        # 3,4: 8x16 left/right
         (0, 0, 1, 1), (0, 1, 1, 1), (1, 0, 1, 1), (1, 1, 1, 1))  # 5-8: 8x8
SLOT_MODE = (0, 1, 1, 2, 2, 3, 3, 3, 3)
# inter modes -> slots and 4x4-cell partition geometry (dy4, dx4, h4, w4)
MODE_SLOTS = ((0,), (1, 2), (3, 4), (5, 6, 7, 8))
MODE_GEO4 = (((0, 0, 4, 4),),
             ((0, 0, 2, 4), (2, 0, 2, 4)),
             ((0, 0, 4, 2), (0, 2, 4, 2)),
             ((0, 0, 2, 2), (0, 2, 2, 2), (2, 0, 2, 2), (2, 2, 2, 2)))
MODE_TAGS = (("none",), ("16x8_top", "16x8_bot"),
             ("8x16_left", "8x16_right"), ("none",) * 4)
MODE_HDR_BITS = (1, 3, 3, 9)                # mb_type ue (+ 4x sub_mb_type)
SLOTS4 = tuple((cy * 2, cx * 2, ch * 2, cw * 2) for (cy, cx, ch, cw) in SLOTS)

_SCAN = np.asarray(BLOCK_SCAN, np.int64)
_SCANY, _SCANX = _SCAN[:, 0], _SCAN[:, 1]
_INV = np.asarray(BLOCK_SCAN_INV, np.int64)
_TR_INMB_OK = np.zeros(16, bool)
for _k in range(16):
    _y4, _x4 = int(_SCANY[_k]), int(_SCANX[_k])
    if _y4 > 0 and _x4 < 3:
        _TR_INMB_OK[_k] = _INV[_y4 - 1, _x4 + 1] < _k

# cell -> partition index per inter mode (4x4 cells of the MB)
_PART_MAP = np.zeros((4, 4, 4), np.int64)
for _m, _parts in enumerate(MODE_GEO4):
    for _pi, (_dy, _dx, _h, _w) in enumerate(_parts):
        _PART_MAP[_m, _dy:_dy + _h, _dx:_dx + _w] = _pi

# float32 bits of tpu_enc.lambdas(qp) = (0.85 * 2^((qp-12)/3), its sqrt)
# as XLA's CPU backend computes them, for qp 0..51
_LAM_BITS = np.array([
    1029282202, 1032393813, 1034728849, 1037670810, 1040782421, 1043117457,
    1046059418, 1049171029, 1051506065, 1054448026, 1057559637, 1059894673,
    1062836634, 1065948245, 1068283281, 1071225242, 1074336853, 1076671889,
    1079613850, 1082725461, 1085060497, 1088002458, 1091114069, 1093449105,
    1096391066, 1099502677, 1101837713, 1104779674, 1107891285, 1110226321,
    1113168282, 1116279893, 1118614929, 1121556890, 1124668501, 1127003537,
    1129945498, 1133057109, 1135392145, 1138334106, 1141445717, 1143780753,
    1146722714, 1149834325, 1152169361, 1155111322, 1158222933, 1160557975,
    1163499930, 1166611536, 1168946577, 1171888545], np.int32)
_LAM_ME_BITS = np.array([
    1047266613, 1048868418, 1049931514, 1051124799, 1052464216, 1053967661,
    1055655221, 1057257026, 1058320122, 1059513407, 1060852824, 1062356269,
    1064043829, 1065645634, 1066708730, 1067902015, 1069241432, 1070744877,
    1072432437, 1074034242, 1075097338, 1076290623, 1077630040, 1079133485,
    1080821045, 1082422850, 1083485946, 1084679231, 1086018648, 1087522093,
    1089209653, 1090811458, 1091874554, 1093067839, 1094407256, 1095910701,
    1097598261, 1099200066, 1100263162, 1101456447, 1102795864, 1104299309,
    1105986869, 1107588674, 1108651770, 1109845055, 1111184472, 1112687921,
    1114375477, 1115977279, 1117040378, 1118233666], np.int32)


def lambdas(qp: int):
    """(lambda_mode, lambda_me): float32 values as exact Python floats."""
    return (float(_LAM_BITS[qp:qp + 1].view(np.float32)[0]),
            float(_LAM_ME_BITS[qp:qp + 1].view(np.float32)[0]))


def _fma(lam: float, b, a) -> torch.Tensor:
    """float32(a) + lam * float32(b) rounded once to float32.  The product
    of two float32 values is exact in float64, so one float64 add and one
    narrowing give the fused result XLA's CPU backend computes."""
    a = a.to(torch.float32).to(torch.float64)
    if isinstance(b, torch.Tensor):
        b = b.to(torch.float32).to(torch.float64)
    return (a + lam * b).to(torch.float32)


def _c(name: str, value, device) -> torch.Tensor:
    return device_const(name, np.asarray(value), device)


def _ar(n: int, device) -> torch.Tensor:
    return device_const(f"arange{n}", np.arange(n, dtype=np.int64), device)


# ===========================================================================
# Exp-Golomb bit lengths (integer compares, no clz)
# ===========================================================================

def ue_bits(v):
    """Exact ue(v) bit length, elementwise int32."""
    return 2 * (bitlen(v.to(torch.int32) + 1) - 1) + 1


def se_bits(v):
    """Exact se(v) bit length, elementwise int32."""
    v = v.to(torch.int32)
    k = torch.where(v > 0, 2 * v - 1, -2 * v)
    return 2 * (bitlen(k + 1) - 1) + 1


def te_bits(v, num_ref: int):
    """ref_idx_l0 te(v) bit length for a list of ``num_ref`` entries."""
    if num_ref <= 1:
        return torch.zeros_like(v, dtype=torch.int32)
    if num_ref == 2:
        return torch.ones_like(v, dtype=torch.int32)
    return ue_bits(v)


# ===========================================================================
# Reference preparation
# ===========================================================================

def luma_pad(sr: int) -> int:
    return sr + 4


def chroma_pad(sr: int) -> int:
    return sr // 2 + 3


def prep_ref(rec_y, rec_u, rec_v, sr: int):
    """MC-ready planes of one reference picture: (up [4, 4, H+2P, W+2P]
    uint8 phase-split quarter-pel planes, u_pad, v_pad int32)."""
    P, PC = luma_pad(sr), chroma_pad(sr)
    up = sixtap_phases(edge_pad(rec_y.to(torch.int32), P, P, P, P))
    u = edge_pad(rec_u.to(torch.int32), PC, PC, PC, PC)
    v = edge_pad(rec_v.to(torch.int32), PC, PC, PC, PC)
    return up, u, v


def dpb_from_numpy(up, u_pad, v_pad, device):
    """One reference entry of the JAX package's ``prep_ref`` (as numpy
    arrays) as the port's tensors on ``device``."""
    return (torch.as_tensor(np.asarray(up, np.uint8)).to(device),
            torch.as_tensor(np.asarray(u_pad, np.int32)).to(device),
            torch.as_tensor(np.asarray(v_pad, np.int32)).to(device))


# ===========================================================================
# Stage A: integer full search over the candidate lattice
# ===========================================================================

def _offsets(sr: int) -> np.ndarray:
    return np.array([(dy, dx) for dy in range(-sr, sr + 1)
                     for dx in range(-sr, sr + 1)], np.int64)


def _slot_sads(cells: torch.Tensor, mb_h: int, mb_w: int) -> torch.Tensor:
    """[..., n4y, n4x] 4x4-cell SADs -> [..., 9, nmb] partition SADs."""
    lead = cells.shape[:-2]
    c = cells.reshape(*lead, mb_h, 4, mb_w, 4).transpose(-3, -2)
    c = c.reshape(*lead, mb_h * mb_w, 4, 4)
    return torch.stack([c[..., cy:cy + ch, cx:cx + cw].sum((-1, -2),
                                                          dtype=torch.int32)
                        for (cy, cx, ch, cw) in SLOTS4], dim=-2)


def _integer_search(org_y, ref_ys, sr: int, lam_me: float,
                    band_rows: int = None):
    """Integer-pel search for the 9 partition slots of every MB.

    org_y [H, W]; ref_ys [R, H+2P, W+2P] padded integer luma planes;
    ``band_rows``: MB rows per slice (default: one slice).  Returns (mv_int
    [R, 9, nmb, 2] integer pel (x, y), sad_int [R, 9, nmb], pmv2 [R, 9,
    nmb, 2] quarter-pel pass-2 predictors).

    Pass 1 finds the pure-distortion 16x16 field; pass 2 takes the argmin
    of SAD + lambda_me * MVD bits against the median of the causal pass-1
    neighbours.  Ties go to the first offset in raster order."""
    dev = org_y.device
    H, W = org_y.shape
    mb_h, mb_w = H // 16, W // 16
    nmb = mb_h * mb_w
    band_rows = mb_h if band_rows is None else band_rows
    P = luma_pad(sr)
    R, Hp, Wp = ref_ys.shape
    n = 2 * sr + 1
    o = org_y.to(torch.int32)
    refs = ref_ys.to(torch.int32).contiguous()
    sl = torch.empty((R, n, n, 9, nmb), dtype=torch.int32, device=dev)
    for r in range(R):
        # every candidate window of the reference as one strided view
        win = refs[r].as_strided((n, n, H, W), (Wp, 1, Wp, 1),
                                 refs[r].storage_offset()
                                 + (P - sr) * Wp + (P - sr))
        for dyi in range(n):
            d = torch.abs(o - win[dyi])                       # [n, H, W]
            cells = d.reshape(n, H // 4, 4, W // 4, 4).sum(
                (2, 4), dtype=torch.int32)
            sl[r, dyi] = _slot_sads(cells, mb_h, mb_w)
    sl = sl.reshape(R, n * n, 9, nmb)
    offs = _c(f"me_offs{sr}", _offsets(sr), dev)             # [noff, 2]

    best1 = torch.argmin(sl.to(torch.float32), dim=1)         # [R, 9, nmb]
    f16 = torch.stack([offs[best1[:, 0], 1], offs[best1[:, 0], 0]], -1)
    f16 = f16.reshape(R, mb_h, mb_w, 2).to(torch.int32)

    rows = _ar(mb_h, dev)
    cols = _ar(mb_w, dev)
    av_l = (cols > 0)[None, None, :, None]
    av_t = ((rows % band_rows) > 0)[None, :, None, None]
    av_tr = av_t & (cols < mb_w - 1)[None, None, :, None]
    a = torch.where(av_l, torch.roll(f16, 1, 2), 0)
    b = torch.where(av_t, torch.roll(f16, 1, 1), 0)
    cc = torch.where(av_tr, torch.roll(f16, (1, -1), (1, 2)), 0)
    med = a + b + cc - torch.minimum(torch.minimum(a, b), cc) \
        - torch.maximum(torch.maximum(a, b), cc)
    pmv = (4 * med).reshape(R, 1, nmb, 2)

    ox = (4 * offs[:, 1]).to(torch.int32)[None, :, None, None]
    oy = (4 * offs[:, 0]).to(torch.int32)[None, :, None, None]
    bits = se_bits(ox - pmv[..., 0][:, None]) \
        + se_bits(oy - pmv[..., 1][:, None])                 # [R, noff, 1, nmb]
    best2 = torch.argmin(_fma(lam_me, bits, sl), dim=1)        # [R, 9, nmb]
    mv2 = torch.stack([offs[best2, 1], offs[best2, 0]], -1).to(torch.int32)
    sad2 = torch.gather(sl, 1, best2[:, None])[:, 0]
    return mv2, sad2, pmv.expand(R, 9, nmb, 2)


# ===========================================================================
# Stage B: subpel refinement
# ===========================================================================

def _gather(flat: torch.Tensor, base: torch.Tensor, row_stride: int,
            bh: int, bw: int) -> torch.Tensor:
    """[..., bh, bw] int32 windows of the 1-D tensor ``flat`` starting at
    ``base [...]`` with rows ``row_stride`` apart."""
    dev = flat.device
    offs = _ar(bh, dev)[:, None] * row_stride + _ar(bw, dev)[None, :]
    return flat[base.to(torch.int64)[..., None, None] + offs].to(torch.int32)


def _luma_base(shape, r, mvx, mvy, y0, x0, bh: int, bw: int, P: int,
               band=None, band_h: int = None):
    """Flat start of the [bh, bw] quarter-pel MC window in planes of
    ``shape`` [R, 4, 4, Hf, Wp]; coordinates are band-local when ``band``
    is given, and the start is clamped to the band's view."""
    _, _, _, Hf, Wp = shape
    mvx = mvx.to(torch.int32)
    mvy = mvy.to(torch.int32)
    iy = y0 + P + (mvy >> 2)
    ix = torch.clamp(x0 + P + (mvx >> 2), 0, Wp - bw)
    if band is None:
        iy = torch.clamp(iy, 0, Hf - bh)
    else:
        iy = torch.clamp(iy, 0, band_h + 2 * P - bh) + band * band_h
    return ((((r * 4 + (mvy & 3)) * 4 + (mvx & 3)).to(torch.int64) * Hf
             + iy) * Wp + ix)


def _satd(diff: torch.Tensor) -> torch.Tensor:
    """4x4 Hadamard SATD of [..., bh, bw] residuals (JM HadamardSAD4x4:
    (|H d H| summed + 1) >> 1 per 4x4 tile, summed) -> [...] int32."""
    *lead, bh, bw = diff.shape
    b = diff.reshape(*lead, bh // 4, 4, bw // 4, 4).transpose(-3, -2)
    s = torch.abs(Q._h4(b)).sum((-1, -2), dtype=torch.int32)
    return ((s + 1) >> 1).sum((-1, -2), dtype=torch.int32)


_SUB_STEPS = {step: [(ddx, ddy) for ddy in (-step, 0, step)
                     for ddx in (-step, 0, step) if ddx or ddy]
              for step in (2, 1)}


def _subpel_refine(org_y, ups, mv_int, pmv2, sr: int, lam_me: float):
    """Refine every (ref, slot, MB) to quarter-pel: the 8 half-pel then the
    8 quarter-pel neighbours of the best so far, by SATD + lambda_me * MVD
    bits; a candidate must be strictly better to win.

    ups [R, 4, 4, H+2P, W+2P] uint8.  Returns (mv_q [R, 9, nmb, 2], dist_q
    [R, 9, nmb])."""
    dev = org_y.device
    H, W = org_y.shape
    mb_h, mb_w = H // 16, W // 16
    nmb = mb_h * mb_w
    P = luma_pad(sr)
    R = ups.shape[0]
    flat = ups.reshape(-1)
    o = org_y.to(torch.int32)
    mb_i = _ar(nmb, dev)
    mb_y = (mb_i // mb_w) * 16
    mb_x = (mb_i % mb_w) * 16
    rr = _ar(R, dev)[:, None, None]
    out_mv, out_sad = [], []
    for s, (cy, cx, ch, cw) in enumerate(SLOTS4):
        bh, bw = ch * 4, cw * 4
        y0 = mb_y + cy * 4
        x0 = mb_x + cx * 4
        ob = _gather(o.reshape(-1), y0 * W + x0, W, bh, bw)  # [nmb, bh, bw]
        pm = pmv2[:, s]                                       # [R, nmb, 2]
        mvx = 4 * mv_int[:, s, :, 0]
        mvy = 4 * mv_int[:, s, :, 1]

        def costs(cx_, cy_):
            """cx_, cy_ [R, nmb, K] -> (sad, cost) [R, nmb, K]."""
            base = _luma_base(ups.shape, rr, cx_, cy_, y0[None, :, None],
                              x0[None, :, None], bh, bw, P)
            pred = _gather(flat, base, ups.shape[-1], bh, bw)
            sad = _satd(ob[None, :, None] - pred)
            bits = se_bits(cx_ - pm[..., 0:1]) + se_bits(cy_ - pm[..., 1:2])
            return sad, _fma(lam_me, bits, sad)

        sad, cost = costs(mvx[..., None], mvy[..., None])
        best_x, best_y, best_s, best_c = mvx, mvy, sad[..., 0], cost[..., 0]
        for step in (2, 1):
            d = _c(f"sub_steps{step}", _SUB_STEPS[step], dev).to(torch.int32)
            cx_ = best_x[..., None] + d[:, 0]
            cy_ = best_y[..., None] + d[:, 1]
            sad, cost = costs(cx_, cy_)
            allc = torch.cat([best_c[..., None], cost], -1)
            k = torch.argmin(allc, -1, keepdim=True)           # first minimum
            kk = torch.clamp(k - 1, min=0)
            take = k[..., 0] > 0
            best_x = torch.where(take, torch.gather(cx_, -1, kk)[..., 0], best_x)
            best_y = torch.where(take, torch.gather(cy_, -1, kk)[..., 0], best_y)
            best_s = torch.where(take, torch.gather(sad, -1, kk)[..., 0], best_s)
            best_c = torch.gather(allc, -1, k)[..., 0]
        out_mv.append(torch.stack([best_x, best_y], -1))
        out_sad.append(best_s)
    return torch.stack(out_mv, 1), torch.stack(out_sad, 1)


# ===========================================================================
# Decision scan helpers: MV prediction on the committed field
# ===========================================================================
#
# ``lc`` holds one wavefront step's lanes: band [L], band-local MB row mby,
# column mbx, and by0/bx0 = 4*mby/4*mbx.  ``st`` is the band state: mv [S,
# sh4, w4, 2], ref [S, sh4, w4] (-2 = not coded).  An overlay (ov_mv [L, *B,
# 4, 4, 2], ov_ref [L, *B, 4, 4]) holds the current MB's own partitions;
# ``None`` is the empty overlay.

def _cell_read(st, lc, ov_mv, ov_ref, ly: int, lx: int, nb: int):
    """One 4x4 MV cell at MB-local (ly, lx): (mv [L, *B, 2], ref [L, *B],
    avail [L, *B]) with ``nb`` = len(B)."""
    L = lc["band"].shape[0]
    if 0 <= ly < 4 and 0 <= lx < 4:
        if ov_mv is None:
            z = torch.zeros((L,) + (1,) * nb, dtype=torch.int32,
                            device=lc["band"].device)
            return torch.zeros_like(z)[..., None].expand(*z.shape, 2), z - 1, z > 0
        mv = ov_mv[..., ly, lx, :]
        ref = ov_ref[..., ly, lx]
        avail = ref > -2
    else:
        sh4, w4 = st["ref"].shape[1:]
        by = lc["by0"] + ly
        bx = lc["bx0"] + lx
        inside = (by >= 0) & (bx >= 0) & (by < sh4) & (bx < w4)
        byc = torch.clamp(by, 0, sh4 - 1)
        bxc = torch.clamp(bx, 0, w4 - 1)
        shp = (L,) + (1,) * nb
        mv = st["mv"][lc["band"], byc, bxc].reshape(*shp, 2)
        ref = st["ref"][lc["band"], byc, bxc].reshape(shp)
        avail = inside.reshape(shp) & (ref > -2)
    mv = torch.where(avail[..., None], mv, 0)
    ref = torch.where(avail, ref, -1)
    return mv, ref, avail


def _predict_mv(st, lc, ov_mv, ov_ref, dy4: int, dx4: int, bw4: int,
                ref_idx, tag: str, nb: int):
    """Spec 8.4.1.3 median predictor of the partition at MB-local 4x4 cell
    (dy4, dx4), width bw4 cells (mirror of inter.MVField.predict)."""
    a = (st, lc, ov_mv, ov_ref)
    mv_a, ref_a, av_a = _cell_read(*a, dy4, dx4 - 1, nb)
    mv_b, ref_b, av_b = _cell_read(*a, dy4 - 1, dx4, nb)
    mv_c, ref_c, av_c = _cell_read(*a, dy4 - 1, dx4 + bw4, nb)
    mv_d, ref_d, av_d = _cell_read(*a, dy4 - 1, dx4 - 1, nb)
    mv_c = torch.where(av_c[..., None], mv_c, mv_d)
    ref_c = torch.where(av_c, ref_c, ref_d)
    av_c = av_c | av_d

    m_a = ref_a == ref_idx
    m_b = ref_b == ref_idx
    m_c = ref_c == ref_idx
    one_hit = (m_a.to(torch.int32) + m_b.to(torch.int32)
               + m_c.to(torch.int32)) == 1
    hit_mv = torch.where(m_a[..., None], mv_a,
                         torch.where(m_b[..., None], mv_b, mv_c))
    med = mv_a + mv_b + mv_c \
        - torch.minimum(torch.minimum(mv_a, mv_b), mv_c) \
        - torch.maximum(torch.maximum(mv_a, mv_b), mv_c)
    only_a = av_a & ~av_b & ~av_c
    pred = torch.where(only_a[..., None], mv_a,
                       torch.where(one_hit[..., None], hit_mv, med))
    if tag == "16x8_top":
        pred = torch.where(m_b[..., None], mv_b, pred)
    elif tag in ("16x8_bot", "8x16_left"):
        pred = torch.where(m_a[..., None], mv_a, pred)
    elif tag == "8x16_right":
        pred = torch.where(m_c[..., None], mv_c, pred)
    return pred


def _skip_mv(st, lc):
    """P_Skip motion vector [L, 2] (spec 8.4.1.1)."""
    mv_a, ref_a, av_a = _cell_read(st, lc, None, None, 0, -1, 0)
    mv_b, ref_b, av_b = _cell_read(st, lc, None, None, -1, 0, 0)
    zero_a = (ref_a == 0) & (mv_a[..., 0] == 0) & (mv_a[..., 1] == 0)
    zero_b = (ref_b == 0) & (mv_b[..., 0] == 0) & (mv_b[..., 1] == 0)
    use_zero = ~av_a | ~av_b | zero_a | zero_b
    pred = _predict_mv(st, lc, None, None, 0, 0, 4, 0, "none", 0)
    return torch.where(use_zero[..., None], 0, pred)


def _luma_nc(nz_cells, lc, nbr):
    """CAVLC nC per 4x4 (spec 9.2.1) of a candidate: nz_cells [L, *B, 4, 4]
    raster TotalCoeff of the candidate; ``nbr`` the committed counts left of
    and above the MB.  Returns [L, *B, 4, 4] raster nC."""
    nb = nz_cells.dim() - 3
    L = nz_cells.shape[0]
    shp = (L,) + (1,) * nb
    lo = nbr["l_nnz"].reshape(*shp, 4, 1).expand(*nz_cells.shape[:-1], 1)
    to = nbr["t_nnz"].reshape(*shp, 1, 4).expand(*nz_cells.shape[:-2], 1, 4)
    nA = torch.cat([lo, nz_cells[..., :, :3]], dim=-1)
    nB = torch.cat([to, nz_cells[..., :3, :]], dim=-2)
    first = _ar(4, nz_cells.device) == 0
    availA = ~first[None, :] | (lc["mbx"] > 0).reshape(*shp, 1, 1)
    availB = ~first[:, None] | (lc["mby"] > 0).reshape(*shp, 1, 1)
    return torch.where(availA & availB, (nA + nB + 1) >> 1,
                       torch.where(availA, nA, torch.where(availB, nB, 0)))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[l, idx[l]] over the lane axis."""
    return x[_ar(x.shape[0], x.device), idx]


# ===========================================================================
# Decision scan helpers: intra evaluation
# ===========================================================================

def _mb_blocks(x: torch.Tensor) -> torch.Tensor:
    """[..., 16, 16] -> [..., 4 (by), 4 (bx), 4, 4]."""
    return x.reshape(*x.shape[:-2], 4, 4, 4, 4).transpose(-3, -2)


def _mb_unblocks(b: torch.Tensor) -> torch.Tensor:
    return b.transpose(-3, -2).reshape(*b.shape[:-4], 16, 16)


def _eval_i16(patch, org16, lc, nbr, qp: int, lam: float, ar_off):
    """Intra 16x16 RD over 4 modes.  patch [L, 17, 25] the reconstruction
    around the MB (row 0 / column 0 are the neighbours)."""
    L = patch.shape[0]
    preds, allowed = IP.pred16x16_all(patch[:, 0, 1:17], patch[:, 1:17, 0],
                                      patch[:, 0, 0], lc["mby"] > 0,
                                      lc["mbx"] > 0)              # [L,4,16,16]
    w = Q.fdct4x4(_mb_blocks(org16[:, None] - preds))             # [L,4,4,4,4,4]
    dc_lev = Q.quant_dc16(Q.hadamard4x4_fwd(w[..., 0, 0]), qp)    # [L,4,4,4]
    dc_deq = Q.dequant_dc16(dc_lev, qp)
    ac_lev = Q.quant4x4(w, qp, True, offsets=ar_off[:, None, None, None])
    ac_lev[..., 0, 0] = 0
    ac_zz = Q.zigzag(ac_lev)[..., 1:]                             # [L,4,4,4,15]
    cbp = (ac_zz != 0).flatten(-3).any(-1)                        # [L,4]
    deq = torch.where(cbp[..., None, None, None, None],
                      Q.dequant4x4(ac_lev, qp), 0)
    deq[..., 0, 0] = dc_deq
    rec = _mb_unblocks(Q.reconstruct(_mb_blocks(preds), Q.idct4x4(deq)))
    ssd = ((org16[:, None] - rec) ** 2).sum((-1, -2), dtype=torch.int32)

    dc_zz = Q.zigzag(dc_lev)                                      # [L,4,16]
    nz_cells = torch.where(cbp[..., None, None],
                           (ac_zz != 0).sum(-1, dtype=torch.int32), 0)
    nc_r = _luma_nc(nz_cells, lc, nbr)                            # [L,4,4,4]
    ac_bits = CD.block_bits_est(ac_zz.reshape(L, 64, 15),
                                nc_r.reshape(L, 64), 15)
    ac_bits = ac_bits.reshape(L, 4, 16).sum(-1, dtype=torch.int32)
    dc_bits = CD.block_bits_est(dc_zz, nc_r[..., 0, 0], 16)
    bits = torch.where(cbp, ac_bits, 0) + dc_bits
    cost = torch.where(allowed, _fma(lam, bits, ssd), BIG)
    m = torch.argmin(cost, -1)
    fadj = Q.ar_fadjust(_take(w, m), _take(ac_lev, m), qp).sum(
        (1, 2), dtype=torch.int32)
    return dict(i16mode=m.to(torch.int32), dc_zz=_take(dc_zz, m),
                ac_zzs=_take(ac_zz, m), cbp_luma=_take(cbp, m),
                rec=_take(rec, m), cost=_take(cost, m), fadj=fadj)


def _eval_i4(patch, org16, lc, nbr, qp: int, lam: float, mb_w: int, ar_off):
    """Intra 4x4 RD: the 16 blocks in coding order, each seeing the
    reconstruction of the ones before it."""
    dev = patch.device
    L = patch.shape[0]
    ar = _ar(L, dev)
    patch = patch.clone()
    modes_loc = torch.full((L, 4, 4), -1, dtype=torch.int32, device=dev)
    nnz_loc = torch.zeros((L, 4, 4), dtype=torch.int32, device=dev)
    ssd_tot = torch.zeros(L, dtype=torch.int32, device=dev)
    bits_tot = torch.zeros(L, dtype=torch.int32, device=dev)
    fadj_tot = torch.zeros((L, 4, 4), dtype=torch.int32, device=dev)
    has_l = lc["mbx"] > 0
    has_t = lc["mby"] > 0
    yes = torch.ones(L, dtype=torch.bool, device=dev)
    nine = _ar(9, dev)
    modes, zzs, flags = [], [], []
    for k in range(16):
        y4, x4 = int(_SCANY[k]), int(_SCANX[k])
        avail_t = has_t if y4 == 0 else yes
        avail_l = has_l if x4 == 0 else yes
        if y4 == 0:
            tr = has_t if x4 < 3 else has_t & (lc["mbx"] < mb_w - 1)
        else:
            tr = yes & bool(_TR_INMB_OK[k]) if x4 < 3 else ~yes
        preds, allowed = IP.pred4x4_all(
            patch[:, 4 * y4, 1 + 4 * x4:9 + 4 * x4],
            patch[:, 1 + 4 * y4:5 + 4 * y4, 4 * x4],
            patch[:, 4 * y4, 4 * x4], avail_t, avail_l, tr)
        if x4 > 0:
            ma, na = modes_loc[:, y4, x4 - 1], nnz_loc[:, y4, x4 - 1]
        else:
            ma = torch.where(has_l, nbr["l_i4m"][:, y4], -2)
            na = torch.where(has_l, nbr["l_nnz"][:, y4], 0)
        if y4 > 0:
            mb_, nb_ = modes_loc[:, y4 - 1, x4], nnz_loc[:, y4 - 1, x4]
        else:
            mb_ = torch.where(has_t, nbr["t_i4m"][:, x4], -2)
            nb_ = torch.where(has_t, nbr["t_nnz"][:, x4], 0)
        mpm = torch.where((ma == -2) | (mb_ == -2), 2,
                          torch.minimum(torch.where(ma >= 0, ma, 2),
                                        torch.where(mb_ >= 0, mb_, 2)))
        nc = torch.where(avail_l & avail_t, (na + nb_ + 1) >> 1,
                         torch.where(avail_l, na,
                                     torch.where(avail_t, nb_, 0)))
        org4 = org16[:, 4 * y4:4 * y4 + 4, 4 * x4:4 * x4 + 4]
        w = Q.fdct4x4(org4[:, None] - preds)                      # [L,9,4,4]
        lev = Q.quant4x4(w, qp, True, offsets=ar_off[:, None])
        zz = Q.zigzag(lev)                                        # [L,9,16]
        rec9 = Q.reconstruct(preds, Q.idct4x4(Q.dequant4x4(lev, qp)))
        ssd9 = ((org4[:, None] - rec9) ** 2).sum((-1, -2), dtype=torch.int32)
        mode_bits9 = torch.where(nine[None] == mpm[:, None], 1, 4)
        coeff9 = CD.block_bits_est(zz, nc[:, None].expand(L, 9), 16)
        bits9 = mode_bits9 + coeff9
        cost9 = torch.where(allowed, _fma(lam, bits9, ssd9), BIG)
        m = torch.argmin(cost9, -1)
        patch[:, 1 + 4 * y4:5 + 4 * y4, 1 + 4 * x4:5 + 4 * x4] = rec9[ar, m]
        m32 = m.to(torch.int32)
        modes_loc[:, y4, x4] = m32
        zz_m = zz[ar, m]
        nnz_loc[:, y4, x4] = (zz_m != 0).sum(-1, dtype=torch.int32)
        ssd_tot = ssd_tot + ssd9[ar, m]
        bits_tot = bits_tot + bits9[ar, m]
        fadj_tot = fadj_tot + Q.ar_fadjust(w[ar, m], lev[ar, m], qp)
        modes.append(m32)
        zzs.append(zz_m)
        flags.append(torch.stack([(m32 == mpm).to(torch.int32),
                                  m32 - (m32 > mpm).to(torch.int32)], -1))
    return dict(modes=torch.stack(modes, 1), zzs=torch.stack(zzs, 1),
                flags=torch.stack(flags, 1), rec=patch[:, 1:17, 1:17],
                nnz_cells=nnz_loc, modes_cells=modes_loc,
                cost=_fma(lam, bits_tot, ssd_tot), fadj=fadj_tot)


def _code_chroma(org2, pred2, qpc: int, intra: bool):
    """Residual coding of both chroma blocks: org2/pred2 [..., 2, 8, 8] ->
    (dc_levels [..., 2, 4], ac_zzs [..., 2, 2, 2, 15], recs [..., 2, 8, 8],
    cbp_chroma [...])."""
    def blocks(x):
        return x.reshape(*x.shape[:-2], 2, 4, 2, 4).transpose(-3, -2)

    w = Q.fdct4x4(blocks(org2 - pred2))                         # [...,2,2,2,4,4]
    dc_lev = Q.quant_dc_chroma(Q.hadamard2x2_fwd(w[..., 0, 0]), qpc, intra)
    ac_lev = Q.quant4x4(w, qpc, intra)
    ac_lev[..., 0, 0] = 0
    ac_zz = Q.zigzag(ac_lev)[..., 1:]                           # [...,2,2,2,15]
    any_ac = (ac_zz != 0).flatten(-4).any(-1)
    any_dc = (dc_lev != 0).flatten(-2).any(-1)
    cbp = torch.where(any_ac, 2, torch.where(any_dc, 1, 0)).to(torch.int32)
    c = cbp[..., None, None, None]
    deq = torch.where((c == 2)[..., None, None], Q.dequant4x4(ac_lev, qpc), 0)
    deq[..., 0, 0] = torch.where(c >= 1, Q.dequant_dc_chroma(dc_lev, qpc), 0)
    rec_b = Q.reconstruct(blocks(pred2), Q.idct4x4(deq))
    recs = rec_b.transpose(-3, -2).reshape(pred2.shape)
    ac_zz = torch.where((c == 2)[..., None], ac_zz, 0)
    dc_lev = torch.where(cbp[..., None, None] >= 1, dc_lev, 0)
    return dc_lev, ac_zz, recs, cbp


def _eval_chroma_intra(pu, pv, org2, lc, qpc: int):
    """Chroma intra: SAD mode pick over both components, then the residual.
    pu/pv [L, 9, 9] reconstruction around the MB; org2 [L, 2, 8, 8]."""
    pr, al = [], None
    for p in (pu, pv):
        preds, al = IP.pred_chroma_all(p[:, 0, 1:9], p[:, 1:9, 0], p[:, 0, 0],
                                       lc["mby"] > 0, lc["mbx"] > 0)
        pr.append(preds)
    preds = torch.stack(pr, 1)                                   # [L,2,4,8,8]
    sad4 = torch.abs(org2[:, :, None] - preds).sum((1, 3, 4), dtype=torch.int32)
    mode = torch.argmin(torch.where(al, sad4.to(torch.float32), BIG), -1)
    pred2 = preds[_ar(preds.shape[0], preds.device), :, mode]    # [L,2,8,8]
    dc, ac, recs, cbp = _code_chroma(org2, pred2, qpc, True)
    return dict(mode=mode.to(torch.int32), dc_levels=dc, ac_zzs=ac,
                recs=recs, cbp_chroma=cbp)


# ===========================================================================
# Decision scan helpers: inter residual coding
# ===========================================================================

def _coeff_cost(zz: torch.Tensor) -> torch.Tensor:
    """JM run-based single-coefficient cost over [..., n] scan levels."""
    n = zz.shape[-1]
    nz = zz != 0
    idx = _ar(n, zz.device).to(torch.int32)
    prev_incl = torch.cummax(torch.where(nz, idx, -1), dim=-1).values
    prev_excl = torch.cat([torch.full_like(prev_incl[..., :1], -1),
                           prev_incl[..., :-1]], dim=-1)
    run = idx - prev_excl - 1
    table = _c("coeff_cost", COEFF_COST, zz.device)
    per = torch.where(torch.abs(zz) > 1, 999999,
                      table[torch.clamp(run, 0, 15).long()])
    return torch.where(nz, per, 0).sum(-1, dtype=torch.int32)


def _cbp_bits(nz_b8: torch.Tensor) -> torch.Tensor:
    """[..., 4] coded flags per 8x8 in b8 order -> cbp_luma bits."""
    w = _c("cbp_weights", np.array([1, 2, 4, 8], np.int32), nz_b8.device)
    return (nz_b8.to(torch.int32) * w).sum(-1, dtype=torch.int32)


def _code_inter_luma(org16, pred16, qp: int, ar_off):
    """Residual coding of [..., 16, 16] predictions -> (zz_coding [..., 16,
    16] in coding order, rec [..., 16, 16], cbp_luma bits [...], fadj [...,
    4, 4] adaptive-rounding adjustment sum)."""
    w = Q.fdct4x4(_mb_blocks(org16 - pred16))                  # [...,4,4,4,4]
    lev = Q.quant4x4(w, qp, False, offsets=ar_off)
    zz = Q.zigzag(lev)                                         # [...,4,4,16]
    rec = _mb_unblocks(Q.reconstruct(_mb_blocks(pred16),
                                     Q.idct4x4(Q.dequant4x4(lev, qp))))
    nz44 = (zz != 0).any(-1)                                   # [..., y4, x4]
    nz8 = nz44.reshape(*nz44.shape[:-2], 2, 2, 2, 2).any(-1).any(-2)
    cbp = _cbp_bits(nz8.reshape(*nz8.shape[:-2], 4))
    sy = _c("scan_y", _SCANY, zz.device)
    sx = _c("scan_x", _SCANX, zz.device)
    fadj = Q.ar_fadjust(w, lev, qp).sum((-3, -4), dtype=torch.int32)
    return zz[..., sy, sx, :], rec, cbp, fadj


# ===========================================================================
# Motion compensation gathers (band-local coordinates, band-view clamps)
# ===========================================================================

def _mc_luma(fr, r, mv, y0, x0, bh: int, bw: int):
    """[L, bh, bw] luma prediction from reference ``r [L]`` at band-local
    (y0, x0) [L] with quarter-pel mv [L, 2]."""
    base = _luma_base(fr["ups"].shape, r, mv[:, 0], mv[:, 1], y0, x0, bh, bw,
                      fr["P"], fr["band"], fr["band_h"])
    return _gather(fr["ups_flat"], base, fr["ups"].shape[-1], bh, bw)


def _mc_chroma(fr, r, mv, cy, cx, bh: int, bw: int):
    """[L, 2, bh, bw] spec 8.4.2.2.2 bilinear chroma prediction (U, V); mv
    in luma quarter-pel."""
    _, Hcf, Wc = fr["us"].shape
    PC, hc = fr["PC"], fr["band_h"] // 2
    mvx = mv[:, 0].to(torch.int32)
    mvy = mv[:, 1].to(torch.int32)
    fx = (mvx & 7)[:, None, None]
    fy = (mvy & 7)[:, None, None]
    y = torch.clamp(cy + PC + (mvy >> 3), 0, hc + 2 * PC - (bh + 1)) \
        + fr["band"] * hc
    x = torch.clamp(cx + PC + (mvx >> 3), 0, Wc - (bw + 1))
    base = (r.to(torch.int64) * Hcf + y) * Wc + x
    out = []
    for flat in (fr["us_flat"], fr["vs_flat"]):
        win = _gather(flat, base, Wc, bh + 1, bw + 1)
        A, B = win[:, :bh, :bw], win[:, :bh, 1:]
        C, D = win[:, 1:, :bw], win[:, 1:, 1:]
        out.append(((8 - fx) * (8 - fy) * A + fx * (8 - fy) * B
                    + (8 - fx) * fy * C + fx * fy * D + 32) >> 6)
    return torch.stack(out, 1)


def _win(plane, band, y0, x0, h: int, w: int):
    """Per-lane [L, h, w, ...] windows of band planes [S, Hp, Wp, ...] with
    starts clamped like ``jax.lax.dynamic_slice``."""
    dev = plane.device
    Hp, Wp = plane.shape[1:3]
    ys = torch.clamp(y0, 0, Hp - h)[:, None] + _ar(h, dev)
    xs = torch.clamp(x0, 0, Wp - w)[:, None] + _ar(w, dev)
    return plane[band[:, None, None], ys[:, :, None], xs[:, None, :]]


def _put(plane, band, y0, x0, val, valid):
    """Write per-lane windows ``val [L, h, w, ...]`` into band planes where
    ``valid [L]``; lanes cover distinct (band, row) pairs, so no two writes
    overlap."""
    dev = plane.device
    h, w = val.shape[1:3]
    ys = y0[:, None] + _ar(h, dev)
    xs = x0[:, None] + _ar(w, dev)
    idx = (band[:, None, None], ys[:, :, None], xs[:, None, :])
    v = valid.reshape(-1, *([1] * (val.dim() - 1)))
    plane[idx] = torch.where(v, val, plane[idx])


# ===========================================================================
# One wavefront step: decisions + residuals of one MB per lane
# ===========================================================================

def _inter_candidates(st, lc, fr, mv_mb, sad_mb, cfg):
    """Reference choice per inter mode by ME cost, and the prediction of
    every candidate: the 4 partition modes, then 16x16/ref0 at the median
    predictor.  Returns a dict of [L, 5, ...] candidate arrays plus the
    P_Skip prediction."""
    dev = mv_mb.device
    L, R = mv_mb.shape[:2]
    ar = _ar(L, dev)
    lam_me, n_valid = cfg["lam_me"], cfg["n_valid"]
    rv = _ar(R, dev).to(torch.int32)[None]                     # [1, R]
    te_r = te_bits(rv, n_valid)
    m_cost, m_bits, m_mvds, m_mvs = [], [], [], []
    for m, (parts, tags, slots) in enumerate(
            zip(MODE_GEO4, MODE_TAGS, MODE_SLOTS)):
        ov_mv = torch.zeros((L, R, 4, 4, 2), dtype=torch.int32, device=dev)
        ov_ref = torch.full((L, R, 4, 4), -2, dtype=torch.int32, device=dev)
        bits = (MODE_HDR_BITS[m] + len(parts) * te_r).expand(L, R)
        sad = torch.zeros((L, R), dtype=torch.int32, device=dev)
        mvds = torch.zeros((L, R, 4, 2), dtype=torch.int32, device=dev)
        mvs = torch.zeros((L, R, 4, 2), dtype=torch.int32, device=dev)
        for pi, ((dy4, dx4, h4p, w4p), tag, slot) in enumerate(
                zip(parts, tags, slots)):
            pm = _predict_mv(st, lc, ov_mv, ov_ref, dy4, dx4, w4p, rv, tag, 1)
            mv = mv_mb[:, :, slot]
            bits = bits + se_bits(mv[..., 0] - pm[..., 0]) \
                + se_bits(mv[..., 1] - pm[..., 1])
            sad = sad + sad_mb[:, :, slot]
            ov_mv[:, :, dy4:dy4 + h4p, dx4:dx4 + w4p] = mv[:, :, None, None]
            ov_ref[:, :, dy4:dy4 + h4p, dx4:dx4 + w4p] = rv[..., None, None]
            mvds[:, :, pi] = mv - pm
            mvs[:, :, pi] = mv
        m_cost.append(_fma(lam_me, bits, sad))
        m_bits.append(bits)
        m_mvds.append(mvds)
        m_mvs.append(mvs)
    cost = torch.stack(m_cost, -1)                              # [L, R, 4]
    cost = torch.where((rv < n_valid)[..., None], cost, BIG)
    ref_m = torch.argmin(cost, 1)                               # [L, 4]
    a4 = _ar(4, dev)[None]
    hdr = torch.stack(m_bits, -1)[ar[:, None], ref_m, a4]       # [L, 4]
    mvds_m = torch.stack(m_mvds, 2)[ar[:, None], ref_m, a4]     # [L, 4, 4, 2]
    mvs_m = torch.stack(m_mvs, 2)[ar[:, None], ref_m, a4]

    y0, x0 = 16 * lc["mby"], 16 * lc["mbx"]
    cy0, cx0 = 8 * lc["mby"], 8 * lc["mbx"]
    lsel, csel = [], []
    for s, (cy, cx, chs, cws) in enumerate(SLOTS):
        rm = ref_m[:, SLOT_MODE[s]]
        mv_s = mv_mb[ar, rm, s]
        lsel.append(_mc_luma(fr, rm, mv_s, y0 + cy * 8, x0 + cx * 8,
                             chs * 8, cws * 8))
        csel.append(_mc_chroma(fr, rm, mv_s, cy0 + cy * 4, cx0 + cx * 4,
                               chs * 4, cws * 4))

    def quad(p):
        return torch.stack([
            p[0], torch.cat([p[1], p[2]], -2), torch.cat([p[3], p[4]], -1),
            torch.cat([torch.cat([p[5], p[6]], -1),
                       torch.cat([p[7], p[8]], -1)], -2)], 1)

    zero = torch.zeros(L, dtype=torch.int64, device=dev)
    smv = _skip_mv(st, lc)
    pm0 = _predict_mv(st, lc, None, None, 0, 0, 4, 0, "none", 0)
    pred16 = torch.cat([quad(lsel),
                        _mc_luma(fr, zero, pm0, y0, x0, 16, 16)[:, None]], 1)
    predc = torch.cat([quad(csel),
                       _mc_chroma(fr, zero, pm0, cy0, cx0, 8, 8)[:, None]], 1)
    hdr = torch.cat([hdr, (3 + te_bits(zero[:, None].to(torch.int32),
                                       n_valid))], 1)
    z42 = torch.zeros((L, 1, 4, 2), dtype=torch.int32, device=dev)
    return dict(
        pred16=pred16, predc=predc, hdr=hdr,
        ref=torch.cat([ref_m, zero[:, None]], 1).to(torch.int32),
        mvds=torch.cat([mvds_m, z42], 1),
        mvs=torch.cat([mvs_m, pm0[:, None, None].expand(L, 1, 4, 2)], 1),
        smv=smv, pred16_sk=_mc_luma(fr, zero, smv, y0, x0, 16, 16),
        predc_sk=_mc_chroma(fr, zero, smv, cy0, cx0, 8, 8))


def _nz_cells(zz_coding):
    """[..., 16, n] coding-order blocks -> [..., 4, 4] raster TotalCoeff."""
    dev = zz_coding.device
    out = torch.zeros((*zz_coding.shape[:-2], 4, 4), dtype=torch.int32,
                      device=dev)
    out[..., _c("scan_y", _SCANY, dev), _c("scan_x", _SCANX, dev)] = \
        (zz_coding != 0).sum(-1, dtype=torch.int32)
    return out


def _luma_bits(zz_coding, cbp, lc, nbr):
    """Estimated CAVLC bits of the coded 4x4 luma blocks of [L, *B, 16, 16]
    coding-order levels with cbp_luma [L, *B]."""
    dev = zz_coding.device
    sy, sx = _c("scan_y", _SCANY, dev), _c("scan_x", _SCANX, dev)
    nc = _luma_nc(_nz_cells(zz_coding), lc, nbr)[..., sy, sx]
    bits = CD.block_bits_est(zz_coding, nc, 16)
    coded = ((cbp[..., None] >> (_ar(16, dev) // 4)) & 1) > 0
    return torch.where(coded, bits, 0).sum(-1, dtype=torch.int32)


def _cbp_ue(cbp):
    tab = _c("cbp_inter", np.asarray(CBP_TO_CODENUM_INTER, np.int64),
             cbp.device)
    return ue_bits(tab[cbp.long()])


def _ssd(a, b, dims):
    return ((a - b) ** 2).sum(dims, dtype=torch.int32)


def _mb_compute(st, lc, fr, mv_mb, sad_mb, forced, cfg):
    """Decisions and residuals of one MB per lane; returns (state updates,
    symbols) as [L, ...] tensors without touching ``st``."""
    dev = lc["band"].device
    L = lc["band"].shape[0]
    ar = _ar(L, dev)
    qp, qpc, lam = cfg["qp"], cfg["qpc"], cfg["lam"]
    band, mby, mbx = lc["band"], lc["mby"], lc["mbx"]
    by0, bx0 = lc["by0"], lc["bx0"]
    ar_i = st["ar_i"][band]
    ar_p = st["ar_p"][band]
    org16 = fr["org16"][lc["g"]]
    org2 = fr["orgc"][lc["g"]]
    lcol = torch.clamp(bx0 - 1, min=0)
    trow = torch.clamp(by0 - 1, min=0)
    nbr = dict(l_nnz=_win(st["nnz_y"], band, by0, lcol, 4, 1)[..., 0],
               t_nnz=_win(st["nnz_y"], band, trow, bx0, 1, 4)[:, 0],
               l_i4m=_win(st["i4m"], band, by0, lcol, 4, 1)[..., 0],
               t_i4m=_win(st["i4m"], band, trow, bx0, 1, 4)[:, 0])

    patch = _win(st["rec_y"], band, 16 * mby, 16 * mbx, 17, 25)
    i16 = _eval_i16(patch, org16, lc, nbr, qp, lam, ar_i)
    i4 = _eval_i4(patch, org16, lc, nbr, qp, lam, cfg["mb_w"], ar_i)
    ch = _eval_chroma_intra(_win(st["rec_u"], band, 8 * mby, 8 * mbx, 9, 9),
                            _win(st["rec_v"], band, 8 * mby, 8 * mbx, 9, 9),
                            org2, lc, qpc)
    i16_cost = _fma(lam, 11.0, i16["cost"])
    i4_cost = _fma(lam, 9.0, i4["cost"])
    zi = torch.zeros(L, dtype=torch.int32, device=dev)

    if cfg["intra_only"]:
        use_i16 = i16_cost <= i4_cost                 # argmin: first wins ties
        is_intra = torch.ones(L, dtype=torch.bool, device=dev)
        is_skip = ~is_intra
        emit_m = win_r = cbp_bits_int = cbp_c_int = zi
        win_mvds = torch.zeros((L, 4, 2), dtype=torch.int32, device=dev)
        win_mvs = win_mvds
        zzc = torch.zeros((L, 16, 16), dtype=torch.int32, device=dev)
        rec16_int = pred16 = zzc
        dcl_int = torch.zeros((L, 2, 4), dtype=torch.int32, device=dev)
        acz_int = torch.zeros((L, 2, 2, 2, 15), dtype=torch.int32, device=dev)
        crecs_int = predc = torch.zeros((L, 2, 8, 8), dtype=torch.int32,
                                        device=dev)
        ar_p_add = torch.zeros((L, 4, 4), dtype=torch.int32, device=dev)
    else:
        cand = _inter_candidates(st, lc, fr, mv_mb, sad_mb, cfg)
        M = cand["pred16"].shape[1]
        zzc_m, rec_m, cbpL_m, fadj_m = _code_inter_luma(
            org16[:, None], cand["pred16"], qp, ar_p[:, None, None, None])
        dcl_m, acz_m, crecs_m, cbpC_m = _code_chroma(
            org2[:, None], cand["predc"], qpc, False)
        ssd_m = _ssd(org16[:, None], rec_m, (-1, -2)) \
            + _ssd(org2[:, None], crecs_m, (-1, -2, -3))
        cbp_m = cbpL_m | (cbpC_m << 4)
        lum_bits = _luma_bits(zzc_m, cbpL_m, lc, nbr)
        cdc_bits = CD.block_bits_est(dcl_m, 0, 4, chroma_dc=True).sum(
            -1, dtype=torch.int32)
        cac_bits = CD.block_bits_est(acz_m.reshape(L, M, 8, 15), 0, 15).sum(
            -1, dtype=torch.int32)
        res_bits = lum_bits + torch.where(cbpC_m >= 1, cdc_bits, 0) \
            + torch.where(cbpC_m == 2, cac_bits, 0)
        bits_m = cand["hdr"] + 1 + _cbp_ue(cbp_m) + (cbp_m > 0).to(torch.int32) \
            + res_bits
        cost_inter = torch.where(forced[:, None], BIG, _fma(lam, bits_m, ssd_m))
        smv, pred16_sk, predc_sk = cand["smv"], cand["pred16_sk"], cand["predc_sk"]
        cost_sk = torch.where(
            forced, BIG,
            _fma(lam, 1.0, _ssd(org16, pred16_sk, (-1, -2))
                 + _ssd(org2, predc_sk, (-1, -2, -3))))

        # intra candidates carry the chroma SSD + bits too
        ch_ssd = _ssd(org2, ch["recs"], (-1, -2, -3)).to(torch.float32)
        ch_dc_b = CD.block_bits_est(ch["dc_levels"], 0, 4, chroma_dc=True).sum(
            -1, dtype=torch.int32)
        ch_ac_b = CD.block_bits_est(ch["ac_zzs"].reshape(L, 8, 15), 0, 15).sum(
            -1, dtype=torch.int32)
        ch_bits = torch.where(ch["cbp_chroma"] >= 1, ch_dc_b, 0) \
            + torch.where(ch["cbp_chroma"] == 2, ch_ac_b, 0) \
            + ue_bits(ch["mode"])
        i16_cost = _fma(lam, ch_bits, i16_cost + ch_ssd)
        i4_cost = _fma(lam, ch_bits, i4_cost + ch_ssd)

        costs = torch.cat([cost_sk[:, None], cost_inter, i16_cost[:, None],
                           i4_cost[:, None]], 1)
        win = torch.argmin(costs, 1)
        skip_cand = win == 0
        is_intra = win >= M + 1
        use_i16 = win == M + 1
        si = skip_cand | is_intra
        win_m = torch.where(si, 0, torch.clamp(win - 1, 0, M - 1))
        win_r = torch.where(si, 0, _take(cand["ref"], win_m))
        win_mvds = torch.where(si[:, None, None], 0, _take(cand["mvds"], win_m))
        win_mvs = torch.where(
            is_intra[:, None, None], 0,
            torch.where(skip_cand[:, None, None], smv[:, None].expand(L, 4, 2),
                        _take(cand["mvs"], win_m)))
        nsk = ~skip_cand
        n1, n2, n3 = nsk[:, None], nsk[:, None, None], nsk[:, None, None, None]
        zzc = torch.where(n2, _take(zzc_m, win_m), 0)
        rec16_int = torch.where(n2, _take(rec_m, win_m), pred16_sk)
        cbp_bits_int = torch.where(nsk, _take(cbpL_m, win_m), 0)
        dcl_int = torch.where(n2, _take(dcl_m, win_m), 0)
        acz_int = torch.where(nsk[:, None, None, None, None],
                              _take(acz_m, win_m), 0)
        crecs_int = torch.where(n3, _take(crecs_m, win_m), predc_sk)
        cbp_c_int = torch.where(nsk, _take(cbpC_m, win_m), 0)
        pred16 = torch.where(n2, _take(cand["pred16"], win_m), pred16_sk)
        predc = torch.where(n3, _take(cand["predc"], win_m), predc_sk)

        # RD-gated decimation of the winner's 8x8 groups whose |level| <= 1
        # coefficients cost more rate than they buy
        c8 = _coeff_cost(zzc).reshape(L, 4, 4).sum(-1, dtype=torch.int32)
        drop8 = c8 <= 4
        drop8 = drop8 | (torch.where(drop8, 0, c8).sum(
            -1, dtype=torch.int32) <= 5)[:, None]
        zz_dec = torch.where(drop8[:, _ar(16, dev) // 4, None], 0, zzc)
        lev_dec = torch.zeros((L, 4, 4, 4, 4), dtype=torch.int32, device=dev)
        lev_dec[:, _c("scan_y", _SCANY, dev), _c("scan_x", _SCANX, dev)] = \
            Q.unzigzag(zz_dec)
        rec_dec = _mb_unblocks(Q.reconstruct(
            _mb_blocks(pred16), Q.idct4x4(Q.dequant4x4(lev_dec, qp))))
        cbp_dec = _cbp_bits((zz_dec != 0).any(-1).reshape(L, 4, 4).any(-1))
        bits_dec = _luma_bits(zz_dec, cbp_dec, lc, nbr)
        bits_cur = _luma_bits(zzc, cbp_bits_int, lc, nbr)
        dcbp = _cbp_ue(cbp_dec | (cbp_c_int << 4)) \
            - _cbp_ue(cbp_bits_int | (cbp_c_int << 4))
        rd_dec = _fma(lam, bits_dec + dcbp, _ssd(org16, rec_dec, (-1, -2)))
        rd_cur = _fma(lam, bits_cur, _ssd(org16, rec16_int, (-1, -2)))
        use_dec = nsk & ~is_intra & (cbp_dec != cbp_bits_int) \
            & (rd_dec < rd_cur)
        zzc = torch.where(use_dec[:, None, None], zz_dec, zzc)
        rec16_int = torch.where(use_dec[:, None, None], rec_dec, rec16_int)
        cbp_bits_int = torch.where(use_dec, cbp_dec, cbp_bits_int)

        # the zero-MVD candidate emits as P_16x16
        emit_m = torch.where(win_m == M - 1, 0, win_m)
        is_skip = skip_cand | (
            (~is_intra) & (emit_m == 0) & (win_r == 0) & (cbp_bits_int == 0)
            & (cbp_c_int == 0) & (win_mvs[:, 0, 0] == smv[:, 0])
            & (win_mvs[:, 0, 1] == smv[:, 1]))
        ar_p_add = torch.where((is_skip | is_intra)[:, None, None], 0,
                               _take(fadj_m, win_m))

    # ---- winner outputs ----
    sel_i16 = is_intra & use_i16
    sel_i4 = is_intra & ~use_i16
    s2 = (sel_i16[:, None, None], sel_i4[:, None, None], is_skip[:, None, None])
    rec16 = torch.where(s2[0], i16["rec"], torch.where(
        s2[1], i4["rec"], torch.where(s2[2], pred16, rec16_int)))
    recc = torch.where(is_intra[:, None, None, None], ch["recs"], torch.where(
        is_skip[:, None, None, None], predc, crecs_int))
    i4_cbp = _cbp_bits((i4["zzs"] != 0).any(-1).reshape(L, 4, 4).any(-1))
    cbp_luma = torch.where(sel_i16, torch.where(i16["cbp_luma"], 15, 0),
                           torch.where(sel_i4, i4_cbp,
                                       torch.where(is_skip, 0, cbp_bits_int)))
    cbp_chroma = torch.where(is_intra, ch["cbp_chroma"],
                             torch.where(is_skip, 0, cbp_c_int))
    sy, sx = _c("scan_y", _SCANY, dev), _c("scan_x", _SCANX, dev)
    i16_zzc = torch.nn.functional.pad(i16["ac_zzs"][:, sy, sx], (0, 1))
    i16_zzc = torch.where(i16["cbp_luma"][:, None, None], i16_zzc, 0)
    zz_out = torch.where(s2[0], i16_zzc, torch.where(
        s2[1], i4["zzs"], torch.where(s2[2], 0, zzc)))
    cdc_out = torch.where(is_intra[:, None, None], ch["dc_levels"],
                          torch.where(is_skip[:, None, None], 0, dcl_int))
    c5 = (is_intra[:, None, None, None, None], is_skip[:, None, None, None, None])
    cac_out = torch.where(c5[0], ch["ac_zzs"], torch.where(c5[1], 0, acz_int))

    nnz_i16 = torch.where(i16["cbp_luma"][:, None, None],
                          (i16["ac_zzs"] != 0).sum(-1, dtype=torch.int32), 0)
    nnz_cells = torch.where(s2[0], nnz_i16, torch.where(
        s2[1], i4["nnz_cells"], torch.where(s2[2], 0, _nz_cells(zzc))))
    part = _c("part_map", _PART_MAP, dev)[torch.clamp(emit_m, max=3).long()]
    mv_cells = torch.where(is_intra[:, None, None, None], 0,
                           win_mvs[ar[:, None, None], part])
    ref_cells = torch.where(is_intra, -1, win_r)[:, None, None].expand(L, 4, 4)
    fadj_intra = torch.where(sel_i16[:, None, None], i16["fadj"], i4["fadj"])
    upd = dict(rec16=rec16, recc=recc, mv_cells=mv_cells, ref_cells=ref_cells,
               nnz_cells=nnz_cells,
               i4m_cells=torch.where(sel_i4[:, None, None], i4["modes_cells"], -1),
               ar_i_add=torch.where(is_intra[:, None, None], fadj_intra, 0),
               ar_p_add=ar_p_add)

    win_code = torch.where(sel_i16, 6, torch.where(
        sel_i4, 5, torch.where(is_skip, 0, 1 + emit_m)))
    i32 = torch.int32
    out = dict(
        win=win_code.to(i32),
        ri=torch.where(is_intra, 0, win_r).to(i32),
        mvd=torch.where(is_intra[:, None, None], 0, win_mvds).to(i32),
        i4flags=i4["flags"].to(i32), i16mode=i16["i16mode"],
        i16dc=i16["dc_zz"].to(i32), cmode=ch["mode"],
        cbp_luma=cbp_luma.to(i32), cbp_chroma=cbp_chroma.to(i32),
        zz=zz_out.to(i32), cdc=cdc_out.to(i32), cac=cac_out.to(i32),
        mb_intra=is_intra)
    return upd, out


# ===========================================================================
# The frame encoder
# ===========================================================================

def search(org_y, ref_ups, sr: int, qp: int, n_slices: int = 1):
    """Stages A and B for every MB of the frame: (mv_q [nmb, R, 9, 2]
    quarter-pel, dist_q [nmb, R, 9] SATD)."""
    mb_h = org_y.shape[0] // 16
    _, lam_me = lambdas(qp)
    ref_pads = ref_ups[:, 0, 0].to(torch.int32)          # integer samples
    mv_int, _sad, pmv2 = _integer_search(org_y, ref_pads, sr, lam_me,
                                         band_rows=mb_h // n_slices)
    mv_q, sad_q = _subpel_refine(org_y, ref_ups, mv_int, pmv2, sr, lam_me)
    return mv_q.permute(2, 0, 1, 3), sad_q.permute(2, 0, 1)


def _frame_inputs(org_y, org_u, org_v, ref_ups, ref_us, ref_vs, sr: int,
                  sb_h: int):
    """Per-MB original blocks and the flat reference planes the decision
    scan gathers from."""
    H, W = org_y.shape
    mb_h, mb_w = H // 16, W // 16
    dev = org_y.device
    org16 = org_y.to(torch.int32).reshape(mb_h, 16, mb_w, 16).transpose(1, 2)
    orgc = torch.stack([org_u, org_v]).to(torch.int32).reshape(
        2, mb_h, 8, mb_w, 8).permute(1, 3, 0, 2, 4)
    lanes = _ar(mb_h, dev)
    return dict(org16=org16.reshape(mb_h * mb_w, 16, 16),
                orgc=orgc.reshape(mb_h * mb_w, 2, 8, 8),
                ups=ref_ups, ups_flat=ref_ups.reshape(-1),
                us=ref_us, us_flat=ref_us.reshape(-1),
                vs_flat=ref_vs.reshape(-1),
                P=luma_pad(sr), PC=chroma_pad(sr), band=lanes // sb_h,
                band_h=sb_h * 16)


def decide(org_y, org_u, org_v, ref_ups, ref_us, ref_vs, mv_q, sad_q,
           qp: int, n_valid: int, force_intra, *, sr: int, sb_h: int,
           intra_only: bool, chroma_qp_offset: int = 0, marks=None):
    """The wavefront decision scan over every row-band slice at once.

    An MB depends on its left, top and top-right neighbours only, so the
    MBs with c == t - 2*r (band-local row r) are independent: step t
    evaluates one MB per MB row of the frame and commits the row-disjoint
    state updates; ``mb_w + 2*(sb_h - 1)`` steps.  Slices reset every
    context, so each band keeps its own state.  Returns (sym dict of [nmb,
    ...] tensors in raster order, band state dict).

    ``marks``: a list; on CUDA, two CUDA events are appended to it, recorded
    after the eager first step and after the graph capture, so that a
    caller can time the capture (the card waits for the host) apart from
    the steps."""
    dev = org_y.device
    H, W = org_y.shape
    mb_h, mb_w = H // 16, W // 16
    S = mb_h // sb_h
    sh4, w4 = sb_h * 4, mb_w * 4
    lam, lam_me = lambdas(qp)
    cfg = dict(qp=qp, qpc=Q.chroma_qp(qp, chroma_qp_offset), lam=lam,
               lam_me=lam_me, n_valid=n_valid, mb_w=mb_w,
               intra_only=intra_only)
    fr = _frame_inputs(org_y, org_u, org_v, ref_ups, ref_us, ref_vs, sr,
                       sb_h)

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.int32, device=dev)

    st = dict(rec_y=full((S, sb_h * 16 + 1, W + 9), 0),
              rec_u=full((S, sb_h * 8 + 1, W // 2 + 1), 0),
              rec_v=full((S, sb_h * 8 + 1, W // 2 + 1), 0),
              mv=full((S, sh4, w4, 2), 0), ref=full((S, sh4, w4), -2),
              nnz_y=full((S, sh4, w4), 0), i4m=full((S, sh4, w4), -1),
              ar_i=full((S, 4, 4), Q.OFFSET_INTRA),
              ar_p=full((S, 4, 4), Q.OFFSET_INTER))
    lane = _ar(mb_h, dev)
    band = lane // sb_h
    lr = lane % sb_h
    force = force_intra.reshape(-1).to(torch.bool)

    def step(t):
        """One wavefront step; ``t`` a 0-dim int64 tensor on the device."""
        cs = t - 2 * lr
        valid = (cs >= 0) & (cs < mb_w)
        mbx = torch.clamp(cs, 0, mb_w - 1)
        g = lane * mb_w + mbx
        lc = dict(band=band, mby=lr, mbx=mbx, by0=4 * lr, bx0=4 * mbx, g=g)
        upd, out = _mb_compute(st, lc, fr, mv_q[g], sad_q[g], force[g], cfg)
        _put(st["rec_y"], band, 16 * lr + 1, 16 * mbx + 1, upd["rec16"], valid)
        _put(st["rec_u"], band, 8 * lr + 1, 8 * mbx + 1, upd["recc"][:, 0],
             valid)
        _put(st["rec_v"], band, 8 * lr + 1, 8 * mbx + 1, upd["recc"][:, 1],
             valid)
        for key, val in (("mv", "mv_cells"), ("ref", "ref_cells"),
                         ("nnz_y", "nnz_cells"), ("i4m", "i4m_cells")):
            _put(st[key], band, 4 * lr, 4 * mbx, upd[val], valid)
        vm = valid[:, None, None]
        for key in ("ar_i", "ar_p"):
            add = torch.where(vm, upd[key + "_add"], 0).reshape(
                S, sb_h, 4, 4).sum(1, dtype=torch.int32)
            st[key].copy_(torch.clamp(st[key] + add, 0, Q.AR_RANGE))
        return out

    T = mb_w + 2 * (sb_h - 1)
    t_dev = torch.zeros((), dtype=torch.int64, device=dev)
    ys = [step(t_dev)]
    if dev.type == "cuda" and T > 1:
        # every step launches the same kernels on the same shapes: capture
        # one into a CUDA graph and replay it (step 0 above ran eagerly, so
        # every constant table is already on the card)
        if marks is not None:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = step(t_dev)
        if marks is not None:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        for t in range(1, T):
            t_dev.fill_(t)
            graph.replay()
            ys.append({k: v.clone() for k, v in out.items()})
        del graph
    else:
        for t in range(1, T):
            t_dev.fill_(t)
            ys.append(step(t_dev))
    # MB (row, c) ran at step c + 2 * (row % sb_h) in lane row
    rows = _ar(mb_h * mb_w, dev) // mb_w
    t_idx = _ar(mb_h * mb_w, dev) % mb_w + 2 * (rows % sb_h)
    sym = {k: torch.stack([y[k] for y in ys])[t_idx, rows] for k in ys[0]}
    return sym, st


def assemble(sym, st, mb_h: int, mb_w: int):
    """Band state -> frame reconstruction and the deblocking context."""
    H, W = mb_h * 16, mb_w * 16
    rec = (st["rec_y"][:, 1:, 1:W + 1].reshape(H, W),
           st["rec_u"][:, 1:, 1:].reshape(H // 2, W // 2),
           st["rec_v"][:, 1:, 1:].reshape(H // 2, W // 2))
    ctx = dict(nnz=st["nnz_y"].reshape(mb_h * 4, mb_w * 4),
               mv=st["mv"].reshape(mb_h * 4, mb_w * 4, 2),
               ref=torch.clamp(st["ref"], min=-1).reshape(mb_h * 4, mb_w * 4),
               mb_intra=sym["mb_intra"].reshape(mb_h, mb_w))
    return rec, ctx


def encode_frame(org_y, org_u, org_v, ref_ups, ref_us, ref_vs, qp: int,
                 n_valid: int, force_intra, *, mb_h: int, mb_w: int, sr: int,
                 intra_only: bool, chroma_qp_offset: int = 0,
                 n_slices: int = 1):
    """Encode one frame's decisions and residuals on the tensors' device.

    org_*: int planes.  ref_ups [R, 4, 4, H+2P, W+2P] uint8 phase-split
    quarter-pel planes of list 0 (most recent first; slots past ``n_valid``
    repeat the last); ref_us/ref_vs [R, H/2+2PC, W/2+2PC] padded chroma;
    force_intra [mb_h, mb_w] bool.  ``n_slices`` equal row-band slices
    (must divide mb_h).  Returns (symbols dict of [nmb, ...] int32 tensors
    in raster order, (rec_y, rec_u, rec_v), ctx dict with nnz/mv/ref/
    mb_intra)."""
    if mb_h % n_slices:
        raise ValueError(f"n_slices {n_slices} must divide mb_h {mb_h}")
    sb_h = mb_h // n_slices
    R = ref_ups.shape[0]
    nmb = mb_h * mb_w
    if intra_only:
        mv_q = torch.zeros((nmb, R, 9, 2), dtype=torch.int32,
                           device=org_y.device)
        sad_q = torch.zeros((nmb, R, 9), dtype=torch.int32,
                            device=org_y.device)
    else:
        mv_q, sad_q = search(org_y, ref_ups, sr, qp, n_slices)
    sym, st = decide(org_y, org_u, org_v, ref_ups, ref_us, ref_vs, mv_q,
                     sad_q, qp, n_valid, force_intra, sr=sr, sb_h=sb_h,
                     intra_only=intra_only, chroma_qp_offset=chroma_qp_offset)
    rec, ctx = assemble(sym, st, mb_h, mb_w)
    return sym, rec, ctx
