"""Conformant H.264 frame encoder on tensors (I, P, B; High-profile P).

Port of ``h264tpu/avc/tpu_enc.py`` for one device: the whole per-frame
decision process — integer motion search over the candidate lattice (Stage
A), quarter-pel refinement (Stage B), and the wavefront decision scan with
full-RD mode decision, intra 4x4/16x16/chroma prediction, residual coding and
reconstruction — runs as tensor ops on one device; only the bit packing stays
on the host (``avc/pack.py``, ``avc/pack_cabac.py``, ``avc/native.py``),
consuming the per-MB symbol arrays emitted here.  High profile adds the
per-MB 8x8 transform with its RD choice (``transform8``), P_8x8
sub-partitions 8x4/4x8/4x4 (``sub8x8``) and the spec default scaling lists
(``scaling_default``).  B frames (:func:`encode_frame_b`) choose among
spatial direct, L0/L1/Bi 16x16 and intra.  The mesh-sharded encoders
(:func:`make_sharded_encode`, :func:`make_sharded_encode_b`) split the
row-band slices over the slots of a ``parallel.Mesh`` axis.

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

QP is one device tensor with a value per lane (MB row), expanded from a
frame QP or from rate control's per-slice QPs (:func:`lane_qp`): the
quantizers take their shifts and tables per lane, and the lambdas are
gathered per lane, so each slice is priced and quantized at its own QP as
the reference's per-band ``vmap`` does.  Explicit weighted prediction
weights the chroma MC of P candidates per reference (``wp_c``); the luma
weighting is applied to the reference planes by the caller.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .. import device_const, trace
from ..parallel.mesh import gather
from ..ops.me import sixtap_phases, edge_pad
from ..ops.transform import COEFF_COST
from . import quant_dev as Q
from . import quant8_dev as Q8
from . import qmatrix as QM
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
# with sub8x8: 8 sub-partition slots per 8x8 cell in z-order, in 4x4-cell
# units (cy4, cx4, h4, w4) — [8x4 top, 8x4 bottom, 4x8 left, 4x8 right,
# 4x4 x4] — for P_8x8 sub_mb_types 1/2/3 (spec Table 7-14)
SUB_SLOTS4 = tuple(
    s for cy, cx in ((0, 0), (0, 1), (1, 0), (1, 1))
    for s in ((2 * cy, 2 * cx, 1, 2), (2 * cy + 1, 2 * cx, 1, 2),
              (2 * cy, 2 * cx, 2, 1), (2 * cy, 2 * cx + 1, 2, 1),
              (2 * cy, 2 * cx, 1, 1), (2 * cy, 2 * cx + 1, 1, 1),
              (2 * cy + 1, 2 * cx, 1, 1), (2 * cy + 1, 2 * cx + 1, 1, 1)))
# per-cell local slot offsets of each sub_mb_type (0 = 8x8 uses the MB-level
# slot 5+c; 1..3 use slot 9 + 8*c + offset), and ue(sub_mb_type) lengths
SUB_OPT_LOCAL = ((None,), (0, 1), (2, 3), (4, 5, 6, 7))
SUB_HDR_BITS = (1, 3, 3, 5)


def slot_geometry(sub8x8: bool, only16: bool = False) -> tuple:
    """The (cy4, cx4, h4, w4) slots Stages A and B search: 9, or 41 with
    the sub-partition slots, or the 16x16 slot alone (``only16``, B
    frames)."""
    if only16:
        return SLOTS4[:1]
    return SLOTS4 + (SUB_SLOTS4 if sub8x8 else ())

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


def lane_qp(qp, mb_h: int, n_slices: int, device) -> torch.Tensor:
    """One QP per MB row as an int32 tensor [mb_h]: ``qp`` is a frame QP
    (int) or a sequence of ``n_slices`` per-slice QPs (basic-unit rate
    control), each spread over its slice's rows."""
    if isinstance(qp, (int, np.integer)):
        return torch.full((mb_h,), int(qp), dtype=torch.int32, device=device)
    q = torch.as_tensor(np.asarray(qp, np.int32).reshape(n_slices))
    return q.to(device).repeat_interleave(mb_h // n_slices)


def lane_lambdas(qp_l: torch.Tensor):
    """(lambda_mode, lambda_me) per lane of ``qp_l``: the float32 values of
    :func:`lambdas` as float64 tensors, so that :func:`_fma` stays one
    exact product-sum."""
    dev = qp_l.device
    idx = qp_l.long()
    return tuple(device_const(name, bits.view(np.float32).astype(np.float64),
                              dev)[idx]
                 for name, bits in (("lam_f64", _LAM_BITS),
                                    ("lam_me_f64", _LAM_ME_BITS)))


def _fma(lam, b, a) -> torch.Tensor:
    """float32(a) + lam * float32(b) rounded once to float32.  The product
    of two float32 values is exact in float64, so one float64 add and one
    narrowing give the fused result XLA's CPU backend computes.  ``lam``:
    a float, or a float64 tensor whose dims lead the result's (one value
    per lane [L]; unit dims are appended)."""
    a = a.to(torch.float32).to(torch.float64)
    nd = a.dim()
    if isinstance(b, torch.Tensor):
        b = b.to(torch.float32).to(torch.float64)
        nd = max(nd, b.dim())
    if isinstance(lam, torch.Tensor):
        lam = lam.reshape(lam.shape + (1,) * (nd - lam.dim()))
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


def weight_luma(up, wy: int, oy: int):
    """Explicit-WP view of one reference's phase-split quarter-pel planes
    (``tpu_codec._weight_luma``): luma MC is a pure gather, so weighting
    the planes is the spec 8.4.2.3.2 post-MC transform (d_l = 5); Stage A
    searches the weighted integer samples too."""
    return torch.clamp(((up.to(torch.int32) * wy + 16) >> 5) + oy,
                       0, 255).to(torch.uint8)


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


def _slot_sads(cells: torch.Tensor, mb_h: int, mb_w: int,
               slots4: tuple) -> torch.Tensor:
    """[..., n4y, n4x] 4x4-cell SADs -> [..., ns, nmb] partition SADs."""
    lead = cells.shape[:-2]
    c = cells.reshape(*lead, mb_h, 4, mb_w, 4).transpose(-3, -2)
    c = c.reshape(*lead, mb_h * mb_w, 4, 4)
    return torch.stack([c[..., cy:cy + ch, cx:cx + cw].sum((-1, -2),
                                                          dtype=torch.int32)
                        for (cy, cx, ch, cw) in slots4], dim=-2)


def _integer_search(org_y, ref_ys, sr: int, lam_me,
                    band_rows: int = None, sub8x8: bool = False,
                    only16: bool = False):
    """Integer-pel search for the partition slots of every MB: the 9 of
    :data:`SLOTS4`, 41 with ``sub8x8``, or the 16x16 one with ``only16``
    (every slot's numbers do not depend on the other slots).

    org_y [H, W]; ref_ys [R, H+2P, W+2P] padded integer luma planes;
    ``lam_me``: a float, or a float64 tensor [1, 1, 1, nmb] of one
    lambda per MB; ``band_rows``: MB rows per slice (default: one slice).
    Returns (mv_int
    [R, ns, nmb, 2] integer pel (x, y), sad_int [R, ns, nmb], pmv2 [R, ns,
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
    slots4 = slot_geometry(sub8x8, only16)
    ns = len(slots4)
    sl = torch.empty((R, n, n, ns, nmb), dtype=torch.int32, device=dev)
    for r in range(R):
        # every candidate window of the reference as one strided view
        win = refs[r].as_strided((n, n, H, W), (Wp, 1, Wp, 1),
                                 refs[r].storage_offset()
                                 + (P - sr) * Wp + (P - sr))
        for dyi in range(n):
            d = torch.abs(o - win[dyi])                       # [n, H, W]
            cells = d.reshape(n, H // 4, 4, W // 4, 4).sum(
                (2, 4), dtype=torch.int32)
            sl[r, dyi] = _slot_sads(cells, mb_h, mb_w, slots4)
    sl = sl.reshape(R, n * n, ns, nmb)
    offs = _c(f"me_offs{sr}", _offsets(sr), dev)             # [noff, 2]

    best1 = torch.argmin(sl.to(torch.float32), dim=1)         # [R, ns, nmb]
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
    best2 = torch.argmin(_fma(lam_me, bits, sl), dim=1)        # [R, ns, nmb]
    mv2 = torch.stack([offs[best2, 1], offs[best2, 0]], -1).to(torch.int32)
    sad2 = torch.gather(sl, 1, best2[:, None])[:, 0]
    return mv2, sad2, pmv.expand(R, ns, nmb, 2)


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


def _subpel_refine(org_y, ups, mv_int, pmv2, sr: int, lam_me,
                   sub8x8: bool = False, only16: bool = False):
    """Refine every (ref, slot, MB) to quarter-pel: the 8 half-pel then the
    8 quarter-pel neighbours of the best so far, by SATD + lambda_me * MVD
    bits; a candidate must be strictly better to win.

    ups [R, 4, 4, H+2P, W+2P] uint8; ``lam_me`` a float or a float64
    tensor [1, nmb, 1] of one lambda per MB.  Returns (mv_q [R, ns, nmb, 2], dist_q
    [R, ns, nmb]) over the slots of :func:`slot_geometry`."""
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
    for s, (cy, cx, ch, cw) in enumerate(slot_geometry(sub8x8, only16)):
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


def _tabs(qm, key: str):
    """(mf, ils) weighted tables of scaling-list group ``key`` ("i4", "p4",
    "p8"), or (None, None) for the flat lists."""
    return (None, None) if qm is None else (qm[key]["mf"], qm[key]["ils"])


def _eval_i16(patch, org16, lc, nbr, qp, lam, ar_off, qm=None):
    """Intra 16x16 RD over 4 modes.  patch [L, 17, 25] the reconstruction
    around the MB (row 0 / column 0 are the neighbours); ``nbr`` None
    estimates every block's bits at nC 0, as the B path does."""
    L = patch.shape[0]
    mf, ils = _tabs(qm, "i4")
    preds, allowed = IP.pred16x16_all(patch[:, 0, 1:17], patch[:, 1:17, 0],
                                      patch[:, 0, 0], lc["mby"] > 0,
                                      lc["mbx"] > 0)              # [L,4,16,16]
    w = Q.fdct4x4(_mb_blocks(org16[:, None] - preds))             # [L,4,4,4,4,4]
    dc_lev = Q.quant_dc16(Q.hadamard4x4_fwd(w[..., 0, 0]), qp,
                          mf4=mf)                                 # [L,4,4,4]
    dc_deq = Q.dequant_dc16(dc_lev, qp, ils=ils)
    ac_lev = Q.quant4x4(w, qp, True, offsets=ar_off[:, None, None, None],
                        mf=mf)
    ac_lev[..., 0, 0] = 0
    ac_zz = Q.zigzag(ac_lev)[..., 1:]                             # [L,4,4,4,15]
    cbp = (ac_zz != 0).flatten(-3).any(-1)                        # [L,4]
    deq = torch.where(cbp[..., None, None, None, None],
                      Q.dequant4x4(ac_lev, qp, ils=ils), 0)
    deq[..., 0, 0] = dc_deq
    rec = _mb_unblocks(Q.reconstruct(_mb_blocks(preds), Q.idct4x4(deq)))
    ssd = ((org16[:, None] - rec) ** 2).sum((-1, -2), dtype=torch.int32)

    dc_zz = Q.zigzag(dc_lev)                                      # [L,4,16]
    nz_cells = torch.where(cbp[..., None, None],
                           (ac_zz != 0).sum(-1, dtype=torch.int32), 0)
    nc_r = torch.zeros_like(nz_cells) if nbr is None else \
        _luma_nc(nz_cells, lc, nbr)                               # [L,4,4,4]
    ac_bits = CD.block_bits_est(ac_zz.reshape(L, 64, 15),
                                nc_r.reshape(L, 64), 15)
    ac_bits = ac_bits.reshape(L, 4, 16).sum(-1, dtype=torch.int32)
    dc_bits = CD.block_bits_est(dc_zz, nc_r[..., 0, 0], 16)
    bits = torch.where(cbp, ac_bits, 0) + dc_bits
    cost = torch.where(allowed, _fma(lam, bits, ssd), BIG)
    m = torch.argmin(cost, -1)
    fadj = Q.ar_fadjust(_take(w, m), _take(ac_lev, m), qp, mf=mf).sum(
        (1, 2), dtype=torch.int32)
    return dict(i16mode=m.to(torch.int32), dc_zz=_take(dc_zz, m),
                ac_zzs=_take(ac_zz, m), cbp_luma=_take(cbp, m),
                rec=_take(rec, m), cost=_take(cost, m), fadj=fadj)


def _eval_i4(patch, org16, lc, nbr, qp, lam, mb_w: int, ar_off,
             qm=None):
    """Intra 4x4 RD: the 16 blocks in coding order, each seeing the
    reconstruction of the ones before it."""
    dev = patch.device
    mf, ils = _tabs(qm, "i4")
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
        lev = Q.quant4x4(w, qp, True, offsets=ar_off[:, None], mf=mf)
        zz = Q.zigzag(lev)                                        # [L,9,16]
        rec9 = Q.reconstruct(preds, Q.idct4x4(Q.dequant4x4(lev, qp,
                                                           ils=ils)))
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
        fadj_tot = fadj_tot + Q.ar_fadjust(w[ar, m], lev[ar, m], qp, mf=mf)
        modes.append(m32)
        zzs.append(zz_m)
        flags.append(torch.stack([(m32 == mpm).to(torch.int32),
                                  m32 - (m32 > mpm).to(torch.int32)], -1))
    return dict(modes=torch.stack(modes, 1), zzs=torch.stack(zzs, 1),
                flags=torch.stack(flags, 1), rec=patch[:, 1:17, 1:17],
                nnz_cells=nnz_loc, modes_cells=modes_loc,
                cost=_fma(lam, bits_tot, ssd_tot), fadj=fadj_tot)


def _code_chroma(org2, pred2, qpc, intra: bool, qm=None):
    """Residual coding of both chroma blocks: org2/pred2 [..., 2, 8, 8] ->
    (dc_levels [..., 2, 4], ac_zzs [..., 2, 2, 2, 15], recs [..., 2, 8, 8],
    cbp_chroma [...])."""
    mf, ils = _tabs(qm, "i4" if intra else "p4")
    def blocks(x):
        return x.reshape(*x.shape[:-2], 2, 4, 2, 4).transpose(-3, -2)

    w = Q.fdct4x4(blocks(org2 - pred2))                         # [...,2,2,2,4,4]
    dc_lev = Q.quant_dc_chroma(Q.hadamard2x2_fwd(w[..., 0, 0]), qpc, intra,
                               mf4=mf)
    ac_lev = Q.quant4x4(w, qpc, intra, mf=mf)
    ac_lev[..., 0, 0] = 0
    ac_zz = Q.zigzag(ac_lev)[..., 1:]                           # [...,2,2,2,15]
    any_ac = (ac_zz != 0).flatten(-4).any(-1)
    any_dc = (dc_lev != 0).flatten(-2).any(-1)
    cbp = torch.where(any_ac, 2, torch.where(any_dc, 1, 0)).to(torch.int32)
    c = cbp[..., None, None, None]
    deq = torch.where((c == 2)[..., None, None],
                      Q.dequant4x4(ac_lev, qpc, ils=ils), 0)
    deq[..., 0, 0] = torch.where(c >= 1, Q.dequant_dc_chroma(dc_lev, qpc,
                                                             ils=ils), 0)
    rec_b = Q.reconstruct(blocks(pred2), Q.idct4x4(deq))
    recs = rec_b.transpose(-3, -2).reshape(pred2.shape)
    ac_zz = torch.where((c == 2)[..., None], ac_zz, 0)
    dc_lev = torch.where(cbp[..., None, None] >= 1, dc_lev, 0)
    return dc_lev, ac_zz, recs, cbp


def _eval_chroma_intra(pu, pv, org2, lc, qpc, qm=None):
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
    dc, ac, recs, cbp = _code_chroma(org2, pred2, qpc, True, qm)
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


def _code_inter_luma(org16, pred16, qp, ar_off, qm=None):
    """Residual coding of [..., 16, 16] predictions -> (zz_coding [..., 16,
    16] in coding order, rec [..., 16, 16], cbp_luma bits [...], fadj [...,
    4, 4] adaptive-rounding adjustment sum)."""
    mf, ils = _tabs(qm, "p4")
    w = Q.fdct4x4(_mb_blocks(org16 - pred16))                  # [...,4,4,4,4]
    lev = Q.quant4x4(w, qp, False, offsets=ar_off, mf=mf)
    zz = Q.zigzag(lev)                                         # [...,4,4,16]
    rec = _mb_unblocks(Q.reconstruct(_mb_blocks(pred16),
                                     Q.idct4x4(Q.dequant4x4(lev, qp,
                                                            ils=ils))))
    nz44 = (zz != 0).any(-1)                                   # [..., y4, x4]
    nz8 = nz44.reshape(*nz44.shape[:-2], 2, 2, 2, 2).any(-1).any(-2)
    cbp = _cbp_bits(nz8.reshape(*nz8.shape[:-2], 4))
    sy = _c("scan_y", _SCANY, zz.device)
    sx = _c("scan_x", _SCANX, zz.device)
    fadj = Q.ar_fadjust(w, lev, qp, mf=mf).sum((-3, -4), dtype=torch.int32)
    return zz[..., sy, sx, :], rec, cbp, fadj


def _code_inter_luma8(org16, pred16, qp, qm=None):
    """High-profile 8x8 luma residual coding of [..., 16, 16] predictions.

    Returns (zz_coding [..., 16, 16] — the four 8x8 blocks' coefficients as
    CAVLC-interleaved 4x4 sub-blocks in coding order (coefficient k of
    sub-block b4 is 8x8 scan position 4k+b4, spec 7.3.5.3.2), rec [..., 16,
    16], cbp_luma bits [...] with one bit per coded 8x8, nnz_cells [..., 4,
    4] per-sub-block counts).  Reference: JM/lencod/src/transform8x8.c:522."""
    mf, ils = _tabs(qm, "p8")
    lead = org16.shape[:-2]

    def blocks8(x):
        return x.reshape(*lead, 2, 8, 2, 8).transpose(-3, -2)

    w = Q8.fdct8x8(blocks8(org16 - pred16))                    # [...,2,2,8,8]
    lev = Q8.quant8x8(w, qp, False, mf=mf)
    zz = Q8.zigzag8(lev)                                       # [...,2,2,64]
    nz8 = (zz != 0).any(-1)                                    # [..., 2, 2]
    lev = torch.where(nz8[..., None, None], lev, 0)
    zz = torch.where(nz8[..., None], zz, 0)
    rec = Q8.reconstruct8(blocks8(pred16),
                          Q8.idct8x8(Q8.dequant8x8(lev, qp, ils=ils)))
    rec = rec.transpose(-3, -2).reshape(*lead, 16, 16)
    cbp = _cbp_bits(nz8.reshape(*lead, 4))
    subs = zz.reshape(*lead, 2, 2, 16, 4).transpose(-1, -2)   # [.,.,.,b4,16]
    counts = (subs != 0).sum(-1, dtype=torch.int32)            # [..., 2, 2, 4]
    nnz_cells = counts.reshape(*lead, 2, 2, 2, 2).transpose(-3, -2).reshape(
        *lead, 4, 4)
    return subs.reshape(*lead, 16, 16), rec, cbp, nnz_cells


# ===========================================================================
# Motion compensation gathers (band-local coordinates, band-view clamps)
# ===========================================================================

def _lane_band(fr, like: torch.Tensor) -> torch.Tensor:
    """The lanes' band index shaped to broadcast against ``like [L, ...]``."""
    return fr["band"].reshape(-1, *([1] * (like.dim() - 1)))


def _mc_luma(fr, r, mv, y0, x0, bh: int, bw: int):
    """[L, ..., bh, bw] luma prediction from reference ``r [L, ...]`` at
    band-local (y0, x0) [L, ...] with quarter-pel mv [L, ..., 2]."""
    base = _luma_base(fr["ups"].shape, r, mv[..., 0], mv[..., 1], y0, x0, bh,
                      bw, fr["P"], _lane_band(fr, r), fr["band_h"])
    return _gather(fr["ups_flat"], base, fr["ups"].shape[-1], bh, bw)


def _mc_chroma(fr, r, mv, cy, cx, bh: int, bw: int):
    """[L, ..., 2, bh, bw] spec 8.4.2.2.2 bilinear chroma prediction (U,
    V) from reference ``r [L, ...]``; mv [L, ..., 2] in luma quarter-pel.
    With explicit WP (``fr["wp_c"]`` [R, 4] = (wu, ou, wv, ov) per list-0
    reference) each prediction is weighted by its reference's weights
    after the interpolation, as the decoder does (spec 8.4.2.3.2, d = 5):
    ``tpu_enc._encode_band``'s ``wpc``."""
    _, Hcf, Wc = fr["us"].shape
    PC, hc = fr["PC"], fr["band_h"] // 2
    mvx = mv[..., 0].to(torch.int32)
    mvy = mv[..., 1].to(torch.int32)
    fx = (mvx & 7)[..., None, None]
    fy = (mvy & 7)[..., None, None]
    y = torch.clamp(cy + PC + (mvy >> 3), 0, hc + 2 * PC - (bh + 1)) \
        + _lane_band(fr, r) * hc
    x = torch.clamp(cx + PC + (mvx >> 3), 0, Wc - (bw + 1))
    base = (r.to(torch.int64) * Hcf + y) * Wc + x
    out = []
    for flat in (fr["us_flat"], fr["vs_flat"]):
        win = _gather(flat, base, Wc, bh + 1, bw + 1)
        A, B = win[..., :bh, :bw], win[..., :bh, 1:]
        C, D = win[..., 1:, :bw], win[..., 1:, 1:]
        out.append(((8 - fx) * (8 - fy) * A + fx * (8 - fy) * B
                    + (8 - fx) * fy * C + fx * fy * D + 32) >> 6)
    if fr.get("wp_c") is not None:
        wo = fr["wp_c"][r.long()][..., None, None, :]     # [L, ..., 1, 1, 4]
        out = [torch.clamp(((pr * wo[..., 2 * ci] + 16) >> 5)
                           + wo[..., 2 * ci + 1], 0, 255)
               for ci, pr in enumerate(out)]
    return torch.stack(out, -3)


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
    cand = dict(
        pred16=pred16, predc=predc, hdr=hdr,
        ref=torch.cat([ref_m, zero[:, None]], 1).to(torch.int32),
        mvds=torch.cat([mvds_m, z42], 1),
        mvs=torch.cat([mvs_m, pm0[:, None, None].expand(L, 1, 4, 2)], 1),
        smv=smv, pred16_sk=_mc_luma(fr, zero, smv, y0, x0, 16, 16),
        predc_sk=_mc_chroma(fr, zero, smv, cy0, cx0, 8, 8))
    if cfg["sub8x8"]:
        # the sub-partitioned P_8x8 is the last candidate; its MVs travel
        # as cells (``sub_ov``), its MVD slots stay zero like the JAX
        # package's
        sub = _sub_candidate(st, lc, fr, mv_mb, sad_mb, cfg)
        for k in ("pred16", "predc", "hdr", "ref"):
            cand[k] = torch.cat([cand[k], sub[k][:, None]], 1)
        for k in ("mvds", "mvs"):
            cand[k] = torch.cat([cand[k], z42], 1)
        cand.update(sub_t=sub["sub"], sub_mvd=sub["mvd_s"], sub_ov=sub["ov"])
    return cand


_CELLS16 = np.array([(cy, cx) for cy in range(4) for cx in range(4)],
                    np.int64)


def _sub_candidate(st, lc, fr, mv_mb, sad_mb, cfg):
    """P_8x8 with a sub_mb_type per 8x8 cell (8x8/8x4/4x8/4x4, spec Table
    7-14): per cell, in z-order, the sub-mode of least SATD + lambda_me *
    (sub_mb_type + MVD bits), each part predicted from the parts before it
    (JM submacroblock_mode_decision, lencod/src/md_low.c); the reference by
    the summed cost.  Returns the candidate's prediction, header bits,
    reference, sub types [L, 4], sub MVDs [L, 4, 4, 2] and MV cells [L, 4,
    4, 2]."""
    dev = mv_mb.device
    L, R = mv_mb.shape[:2]
    lam_me, n_valid = cfg["lam_me"], cfg["n_valid"]
    ar = _ar(L, dev)
    al, rr = ar[:, None], _ar(R, dev)[None]

    def take(x, idx):                        # x[l, r, idx[l, r]]
        return x[al, rr, idx]

    rv = _ar(R, dev).to(torch.int32)[None]                     # [1, R]
    bits = (5 + 4 * te_bits(rv, n_valid)).expand(L, R)         # ue(3) + refs
    satd = torch.zeros((L, R), dtype=torch.int32, device=dev)
    ov_mv = torch.zeros((L, R, 4, 4, 2), dtype=torch.int32, device=dev)
    ov_ref = torch.full((L, R, 4, 4), -2, dtype=torch.int32, device=dev)
    subt, mvd_c = [], []
    for c, (scy, scx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        o_cost, o_bits, o_ov, o_ovr, o_mvd, o_satd = [], [], [], [], [], []
        for t in range(4):
            if t == 0:
                parts = ((5 + c, 2 * scy, 2 * scx, 2, 2),)
            else:
                parts = tuple((9 + 8 * c + off,) + SUB_SLOTS4[8 * c + off]
                              for off in SUB_OPT_LOCAL[t])
            ov_l, ovr_l = ov_mv.clone(), ov_ref.clone()
            tb = torch.full((L, R), SUB_HDR_BITS[t], dtype=torch.int32,
                            device=dev)
            ts = torch.zeros((L, R), dtype=torch.int32, device=dev)
            mvd4 = torch.zeros((L, R, 4, 2), dtype=torch.int32, device=dev)
            for pi, (slot, dy4, dx4, h4p, w4p) in enumerate(parts):
                pm = _predict_mv(st, lc, ov_l, ovr_l, dy4, dx4, w4p, rv,
                                 "none", 1)
                mv = mv_mb[:, :, slot]
                tb = tb + se_bits(mv[..., 0] - pm[..., 0]) \
                    + se_bits(mv[..., 1] - pm[..., 1])
                ts = ts + sad_mb[:, :, slot]
                ov_l[:, :, dy4:dy4 + h4p, dx4:dx4 + w4p] = mv[:, :, None, None]
                ovr_l[:, :, dy4:dy4 + h4p, dx4:dx4 + w4p] = rv[..., None, None]
                mvd4[:, :, pi] = mv - pm
            o_cost.append(_fma(lam_me, tb, ts))
            o_bits.append(tb)
            o_ov.append(ov_l)
            o_ovr.append(ovr_l)
            o_mvd.append(mvd4)
            o_satd.append(ts)
        tsel = torch.argmin(torch.stack(o_cost, -1), -1)        # [L, R]
        ov_mv = take(torch.stack(o_ov, 2), tsel)
        ov_ref = take(torch.stack(o_ovr, 2), tsel)
        bits = bits + take(torch.stack(o_bits, -1), tsel)
        satd = satd + take(torch.stack(o_satd, -1), tsel)
        subt.append(tsel.to(torch.int32))
        mvd_c.append(take(torch.stack(o_mvd, 2), tsel))
    cost = torch.where(rv < n_valid, _fma(lam_me, bits, satd), BIG)
    rsub = torch.argmin(cost, 1)                                # [L]
    ov = ov_mv[ar, rsub]                                        # [L, 4, 4, 2]

    # the prediction: one 4x4 luma / 2x2 chroma block per MV cell
    cells = _c("cells16", _CELLS16, dev)
    r16 = rsub[:, None].expand(L, 16)
    mv16 = ov.reshape(L, 16, 2)
    pl = _mc_luma(fr, r16, mv16, 16 * lc["mby"][:, None] + 4 * cells[:, 0],
                  16 * lc["mbx"][:, None] + 4 * cells[:, 1], 4, 4)
    pc = _mc_chroma(fr, r16, mv16, 8 * lc["mby"][:, None] + 2 * cells[:, 0],
                    8 * lc["mbx"][:, None] + 2 * cells[:, 1], 2, 2)
    return dict(
        pred16=_mb_unblocks(pl.reshape(L, 4, 4, 4, 4)),
        predc=pc.reshape(L, 4, 4, 2, 2, 2).permute(0, 3, 1, 4, 2, 5).reshape(
            L, 2, 8, 8),
        hdr=bits[ar, rsub], ref=rsub.to(torch.int32),
        sub=torch.stack(subt, -1)[ar, rsub],
        mvd_s=torch.stack(mvd_c, 2)[ar, rsub], ov=ov)


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


def _intra_candidates(st, lc, fr, cfg, i16_nc: bool = True):
    """The MB's original blocks, the committed neighbour counts and modes
    (``nbr``), and its intra candidates: I16 (bits at the neighbours' nC,
    or at nC 0 without ``i16_nc``, as the B path estimates), I4 and
    chroma."""
    band, mby, mbx = lc["band"], lc["mby"], lc["mbx"]
    by0, bx0 = lc["by0"], lc["bx0"]
    qp, lam, qm = cfg["qp"], cfg["lam"], cfg["qm"]
    ar_i = st["ar_i"][band]
    org16 = fr["org16"][lc["g"]]
    org2 = fr["orgc"][lc["g"]]
    lcol = torch.clamp(bx0 - 1, min=0)
    trow = torch.clamp(by0 - 1, min=0)
    nbr = dict(l_nnz=_win(st["nnz_y"], band, by0, lcol, 4, 1)[..., 0],
               t_nnz=_win(st["nnz_y"], band, trow, bx0, 1, 4)[:, 0],
               l_i4m=_win(st["i4m"], band, by0, lcol, 4, 1)[..., 0],
               t_i4m=_win(st["i4m"], band, trow, bx0, 1, 4)[:, 0])
    patch = _win(st["rec_y"], band, 16 * mby, 16 * mbx, 17, 25)
    i16 = _eval_i16(patch, org16, lc, nbr if i16_nc else None, qp, lam, ar_i,
                    qm)
    i4 = _eval_i4(patch, org16, lc, nbr, qp, lam, cfg["mb_w"], ar_i, qm)
    ch = _eval_chroma_intra(_win(st["rec_u"], band, 8 * mby, 8 * mbx, 9, 9),
                            _win(st["rec_v"], band, 8 * mby, 8 * mbx, 9, 9),
                            org2, lc, cfg["qpc"], qm)
    return org16, org2, nbr, i16, i4, ch


def _chroma_intra_rd(ch, org2):
    """(SSD as float32, estimated bits with the mode) of the chroma intra
    candidate, which the intra candidates of an inter frame carry."""
    L = org2.shape[0]
    ch_ssd = _ssd(org2, ch["recs"], (-1, -2, -3)).to(torch.float32)
    ch_dc_b = CD.block_bits_est(ch["dc_levels"], 0, 4, chroma_dc=True).sum(
        -1, dtype=torch.int32)
    ch_ac_b = CD.block_bits_est(ch["ac_zzs"].reshape(L, 8, 15), 0, 15).sum(
        -1, dtype=torch.int32)
    ch_bits = torch.where(ch["cbp_chroma"] >= 1, ch_dc_b, 0) \
        + torch.where(ch["cbp_chroma"] == 2, ch_ac_b, 0) + ue_bits(ch["mode"])
    return ch_ssd, ch_bits


def _winner_outputs(i16, i4, ch, sel_i16, sel_i4, is_skip, pred16, predc,
                    inter):
    """Reconstruction, coded block patterns, levels and neighbour-state
    cells of the chosen candidate per lane: I16, I4, skip (the prediction
    ``pred16``/``predc``, nothing coded) or the coded inter winner
    ``inter`` (dict of rec16, recc, zzc, cbp_luma, cbp_chroma, dcl, acz)."""
    dev = pred16.device
    L = pred16.shape[0]
    is_intra = sel_i16 | sel_i4
    s2 = (sel_i16[:, None, None], sel_i4[:, None, None], is_skip[:, None, None])
    rec16 = torch.where(s2[0], i16["rec"], torch.where(
        s2[1], i4["rec"], torch.where(s2[2], pred16, inter["rec16"])))
    recc = torch.where(is_intra[:, None, None, None], ch["recs"], torch.where(
        is_skip[:, None, None, None], predc, inter["recc"]))
    i4_cbp = _cbp_bits((i4["zzs"] != 0).any(-1).reshape(L, 4, 4).any(-1))
    cbp_luma = torch.where(sel_i16, torch.where(i16["cbp_luma"], 15, 0),
                           torch.where(sel_i4, i4_cbp, torch.where(
                               is_skip, 0, inter["cbp_luma"])))
    cbp_chroma = torch.where(is_intra, ch["cbp_chroma"],
                             torch.where(is_skip, 0, inter["cbp_chroma"]))
    sy, sx = _c("scan_y", _SCANY, dev), _c("scan_x", _SCANX, dev)
    i16_zzc = torch.nn.functional.pad(i16["ac_zzs"][:, sy, sx], (0, 1))
    i16_zzc = torch.where(i16["cbp_luma"][:, None, None], i16_zzc, 0)
    zz = torch.where(s2[0], i16_zzc, torch.where(
        s2[1], i4["zzs"], torch.where(s2[2], 0, inter["zzc"])))
    cdc = torch.where(is_intra[:, None, None], ch["dc_levels"],
                      torch.where(is_skip[:, None, None], 0, inter["dcl"]))
    c5 = (is_intra[:, None, None, None, None],
          is_skip[:, None, None, None, None])
    cac = torch.where(c5[0], ch["ac_zzs"], torch.where(c5[1], 0, inter["acz"]))
    nnz_i16 = torch.where(i16["cbp_luma"][:, None, None],
                          (i16["ac_zzs"] != 0).sum(-1, dtype=torch.int32), 0)
    nnz_cells = torch.where(s2[0], nnz_i16, torch.where(
        s2[1], i4["nnz_cells"], torch.where(s2[2], 0, _nz_cells(inter["zzc"]))))
    fadj_intra = torch.where(sel_i16[:, None, None], i16["fadj"], i4["fadj"])
    return dict(rec16=rec16, recc=recc, cbp_luma=cbp_luma,
                cbp_chroma=cbp_chroma, zz=zz, cdc=cdc, cac=cac,
                nnz_cells=nnz_cells,
                i4m_cells=torch.where(sel_i4[:, None, None],
                                      i4["modes_cells"], -1),
                ar_i_add=torch.where(is_intra[:, None, None], fadj_intra, 0))


def _mb_compute(st, lc, fr, mv_mb, sad_mb, forced, cfg):
    """Decisions and residuals of one MB per lane; returns (state updates,
    symbols) as [L, ...] tensors without touching ``st``."""
    dev = lc["band"].device
    L = lc["band"].shape[0]
    ar = _ar(L, dev)
    qp, qpc, lam, qm = cfg["qp"], cfg["qpc"], cfg["lam"], cfg["qm"]
    ar_p = st["ar_p"][lc["band"]]
    org16, org2, nbr, i16, i4, ch = _intra_candidates(st, lc, fr, cfg)
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
        t8 = is_skip
    else:
        cand = _inter_candidates(st, lc, fr, mv_mb, sad_mb, cfg)
        M = cand["pred16"].shape[1]
        zzc_m, rec_m, cbpL_m, fadj_m = _code_inter_luma(
            org16[:, None], cand["pred16"], qp, ar_p[:, None, None, None], qm)
        dcl_m, acz_m, crecs_m, cbpC_m = _code_chroma(
            org2[:, None], cand["predc"], qpc, False, qm)
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
        ch_ssd, ch_bits = _chroma_intra_rd(ch, org2)
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

        t8 = torch.zeros_like(nsk)
        if cfg["transform8"]:
            # High profile: re-code the winning prediction with the 8x8
            # transform; per-MB transform_size_8x8_flag by RD (luma SSD +
            # bits only: chroma is the same both ways)
            zz8, rec8, cbp8, _ = _code_inter_luma8(org16, pred16, qp, qm)
            db = _cbp_ue(cbp8 | (cbp_c_int << 4)) \
                - _cbp_ue(cbp_bits_int | (cbp_c_int << 4))
            rd8 = _fma(lam, _luma_bits(zz8, cbp8, lc, nbr) + db,
                       _ssd(org16, rec8, (-1, -2)))
            rd4 = _fma(lam, _take(lum_bits, win_m),
                       _ssd(org16, rec16_int, (-1, -2)))
            t8 = nsk & ~is_intra & (cbp8 > 0) & (rd8 < rd4)
            if cfg["sub8x8"]:
                # the flag is illegal when a partition is below 8x8
                t8 = t8 & (win_m != M - 1)
            zzc = torch.where(t8[:, None, None], zz8, zzc)
            rec16_int = torch.where(t8[:, None, None], rec8, rec16_int)
            cbp_bits_int = torch.where(t8, cbp8, cbp_bits_int)

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
            _mb_blocks(pred16), Q.idct4x4(Q.dequant4x4(
                lev_dec, qp, ils=_tabs(qm, "p4")[1]))))
        cbp_dec = _cbp_bits((zz_dec != 0).any(-1).reshape(L, 4, 4).any(-1))
        bits_dec = _luma_bits(zz_dec, cbp_dec, lc, nbr)
        bits_cur = _luma_bits(zzc, cbp_bits_int, lc, nbr)
        dcbp = _cbp_ue(cbp_dec | (cbp_c_int << 4)) \
            - _cbp_ue(cbp_bits_int | (cbp_c_int << 4))
        rd_dec = _fma(lam, bits_dec + dcbp, _ssd(org16, rec_dec, (-1, -2)))
        rd_cur = _fma(lam, bits_cur, _ssd(org16, rec16_int, (-1, -2)))
        use_dec = nsk & ~is_intra & ~t8 & (cbp_dec != cbp_bits_int) \
            & (rd_dec < rd_cur)
        zzc = torch.where(use_dec[:, None, None], zz_dec, zzc)
        rec16_int = torch.where(use_dec[:, None, None], rec_dec, rec16_int)
        cbp_bits_int = torch.where(use_dec, cbp_dec, cbp_bits_int)

        # the zero-MVD candidate emits as P_16x16 (it is the last one, or
        # the one before the sub-partitioned P_8x8)
        emit_m = torch.where(win_m == (M - 2 if cfg["sub8x8"] else M - 1), 0,
                             win_m)
        is_skip = skip_cand | (
            (~is_intra) & (emit_m == 0) & (win_r == 0) & (cbp_bits_int == 0)
            & (cbp_c_int == 0) & (win_mvs[:, 0, 0] == smv[:, 0])
            & (win_mvs[:, 0, 1] == smv[:, 1]))
        ar_p_add = torch.where((is_skip | is_intra)[:, None, None], 0,
                               _take(fadj_m, win_m))

    # ---- winner outputs ----
    sel_i16 = is_intra & use_i16
    sel_i4 = is_intra & ~use_i16
    w = _winner_outputs(i16, i4, ch, sel_i16, sel_i4, is_skip, pred16, predc,
                        dict(rec16=rec16_int, recc=crecs_int, zzc=zzc,
                             cbp_luma=cbp_bits_int, cbp_chroma=cbp_c_int,
                             dcl=dcl_int, acz=acz_int))
    part = _c("part_map", _PART_MAP, dev)[torch.clamp(emit_m, max=3).long()]
    mv_cells = torch.where(is_intra[:, None, None, None], 0,
                           win_mvs[ar[:, None, None], part])
    inter_code = 1 + emit_m
    if cfg["sub8x8"] and not cfg["intra_only"]:
        is_subw = ~is_intra & ~is_skip & (emit_m == M - 1)
        mv_cells = torch.where(is_subw[:, None, None, None], cand["sub_ov"],
                               mv_cells)
        inter_code = torch.where(emit_m == M - 1, 7, inter_code)
    ref_cells = torch.where(is_intra, -1, win_r)[:, None, None].expand(L, 4, 4)
    upd = dict(rec16=w["rec16"], recc=w["recc"], mv_cells=mv_cells,
               ref_cells=ref_cells, nnz_cells=w["nnz_cells"],
               i4m_cells=w["i4m_cells"], ar_i_add=w["ar_i_add"],
               ar_p_add=ar_p_add)

    win_code = torch.where(sel_i16, 6, torch.where(
        sel_i4, 5, torch.where(is_skip, 0, inter_code)))
    i32 = torch.int32
    out = dict(
        win=win_code.to(i32),
        ri=torch.where(is_intra, 0, win_r).to(i32),
        mvd=torch.where(is_intra[:, None, None], 0, win_mvds).to(i32),
        i4flags=i4["flags"].to(i32), i16mode=i16["i16mode"],
        i16dc=i16["dc_zz"].to(i32), cmode=ch["mode"],
        **{k: w[k].to(i32) for k in ("cbp_luma", "cbp_chroma", "zz", "cdc",
                                     "cac")},
        mb_intra=is_intra)
    if cfg["transform8"]:
        out["t8"] = (t8 & ~is_intra & ~is_skip).to(i32)
    if cfg["sub8x8"]:
        if cfg["intra_only"]:
            out["sub"] = torch.zeros((L, 4), dtype=i32, device=dev)
            out["mvd_s"] = torch.zeros((L, 4, 4, 2), dtype=i32, device=dev)
        else:
            out["sub"] = torch.where(is_subw[:, None], cand["sub_t"], 0)
            out["mvd_s"] = torch.where(is_subw[:, None, None, None],
                                       cand["sub_mvd"], 0)
    return upd, out


# ===========================================================================
# The frame encoder
# ===========================================================================

def search(org_y, ref_ups, sr: int, qp, n_slices: int = 1,
           sub8x8: bool = False, only16: bool = False):
    """Stages A and B for every MB of the frame: (mv_q [nmb, R, ns, 2]
    quarter-pel, dist_q [nmb, R, ns] SATD) over :func:`slot_geometry`.
    ``qp``: the frame QP or the per-slice QPs (:func:`lane_qp`); each MB's
    motion costs are priced at its slice's lambda_me."""
    mb_h, mb_w = org_y.shape[0] // 16, org_y.shape[1] // 16
    qp_l = lane_qp(qp, mb_h, n_slices, org_y.device)
    lam_me = lane_lambdas(qp_l)[1].repeat_interleave(mb_w)   # [nmb]
    ref_pads = ref_ups[:, 0, 0].to(torch.int32)          # integer samples
    mv_int, _sad, pmv2 = _integer_search(org_y, ref_pads, sr,
                                         lam_me.reshape(1, 1, 1, -1),
                                         band_rows=mb_h // n_slices,
                                         sub8x8=sub8x8, only16=only16)
    mv_q, sad_q = _subpel_refine(org_y, ref_ups, mv_int, pmv2, sr,
                                 lam_me.reshape(1, -1, 1),
                                 sub8x8=sub8x8, only16=only16)
    return mv_q.permute(2, 0, 1, 3), sad_q.permute(2, 0, 1)


def _frame_inputs(org_y, org_u, org_v, ref_ups, ref_us, ref_vs, sr: int,
                  sb_h: int, wp_c=None):
    """Per-MB original blocks and the flat reference planes the decision
    scan gathers from, and the chroma WP weights ``wp_c`` [R, 4] (None: no
    weighting)."""
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
                band_h=sb_h * 16, wp_c=wp_c)


_CAPTURE = threading.local()


def _capture(step, t_dev):
    """Capture ``step(t_dev)`` into a CUDA graph; returns (graph, output).

    Threads that share the card (GOP workers) may launch, allocate and
    synchronize while one of them captures: the capture runs in
    thread-local mode, which restricts only the capturing thread, on a
    side stream of the capturing thread's own."""
    dev = t_dev.device
    side = getattr(_CAPTURE, "stream", None)
    if side is None or side.device != dev:
        side = _CAPTURE.stream = torch.cuda.Stream(dev)
    cur = torch.cuda.current_stream(dev)
    side.wait_stream(cur)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            out = step(t_dev)
        finally:
            graph.capture_end()
    cur.wait_stream(side)
    return graph, out


def _scan(step, T: int, dev) -> list:
    """Run the ``T`` wavefront steps of a decision scan: ``step(t)`` with a
    0-dim int64 step index on the device, returning a dict of per-lane
    symbols.  On CUDA every step launches the same kernels on the same
    shapes: step 0 runs eagerly (so every constant table is on the card),
    one step is captured into a CUDA graph (:func:`_capture`) and replayed
    for the others.  Spans: ``avc.scan.eager`` (step 0),
    ``avc.scan.capture`` (the card waits while the host captures) and
    ``avc.scan.replay`` (steps 1 to T - 1 with their output clones; eager
    steps off the card)."""
    t_dev = torch.zeros((), dtype=torch.int64, device=dev)
    with trace.span("avc.scan.eager", dev):
        ys = [step(t_dev)]
    if dev.type == "cuda" and T > 1:
        with trace.span("avc.scan.capture", dev):
            graph, out = _capture(step, t_dev)
        with trace.span("avc.scan.replay", dev):
            for t in range(1, T):
                t_dev.fill_(t)
                graph.replay()
                ys.append({k: v.clone() for k, v in out.items()})
        del graph
    else:
        with trace.span("avc.scan.replay", dev):
            for t in range(1, T):
                t_dev.fill_(t)
                ys.append(step(t_dev))
    return ys


def _lane_cfg(qp, mb_h: int, sb_h: int, chroma_qp_offset: int, dev) -> dict:
    """The per-lane QP tensors of a decision scan: qp, its chroma QP and
    the two lambdas, each [mb_h]; made before the scan's steps (and so
    before the CUDA-graph capture)."""
    qp_l = lane_qp(qp, mb_h, mb_h // sb_h, dev)
    qpc_tab = device_const(
        f"chroma_qp{chroma_qp_offset}",
        np.array([Q.chroma_qp(q, chroma_qp_offset) for q in range(52)],
                 np.int32), dev)
    lam, lam_me = lane_lambdas(qp_l)
    return dict(qp=qp_l, qpc=qpc_tab[qp_l.long()], lam=lam, lam_me=lam_me)


def decide(org_y, org_u, org_v, ref_ups, ref_us, ref_vs, mv_q, sad_q,
           qp, n_valid: int, force_intra, *, sr: int, sb_h: int,
           intra_only: bool, chroma_qp_offset: int = 0,
           transform8: bool = False, sub8x8: bool = False,
           scaling_default: bool = False, wp_c=None):
    """The wavefront decision scan over every row-band slice at once.

    An MB depends on its left, top and top-right neighbours only, so the
    MBs with c == t - 2*r (band-local row r) are independent: step t
    evaluates one MB per MB row of the frame and commits the row-disjoint
    state updates; ``mb_w + 2*(sb_h - 1)`` steps.  Slices reset every
    context, so each band keeps its own state.  ``qp``: the frame QP or one
    QP per slice, as one per-lane tensor through every step
    (:func:`_lane_cfg`); ``wp_c``: the chroma WP weights.  Returns (sym
    dict of [nmb, ...] tensors in raster order, band state dict).  The
    steps run in :func:`_scan`'s spans."""
    dev = org_y.device
    H, W = org_y.shape
    mb_h, mb_w = H // 16, W // 16
    S = mb_h // sb_h
    sh4, w4 = sb_h * 4, mb_w * 4
    qm = None
    if scaling_default:
        # the spec default matrices' weighted LevelScale / InvLevelScale
        qm = {k: {m: device_const(f"qm_{k}_{m}", t, dev)
                  for m, t in tabs.items()}
              for k, tabs in QM.enc_tables_default().items()}
    cfg = dict(_lane_cfg(qp, mb_h, sb_h, chroma_qp_offset, dev),
               n_valid=n_valid, mb_w=mb_w, intra_only=intra_only,
               transform8=transform8, sub8x8=sub8x8, qm=qm)
    fr = _frame_inputs(org_y, org_u, org_v, ref_ups, ref_us, ref_vs, sr,
                       sb_h, wp_c)

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

    ys = _scan(step, mb_w + 2 * (sb_h - 1), dev)
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
    if "t8" in sym:
        ctx["t8"] = sym["t8"].reshape(mb_h, mb_w)
    return rec, ctx


def encode_frame(org_y, org_u, org_v, ref_ups, ref_us, ref_vs, qp,
                 n_valid: int, force_intra, wp_c=None, *, mb_h: int,
                 mb_w: int, sr: int, intra_only: bool,
                 chroma_qp_offset: int = 0, n_slices: int = 1,
                 transform8: bool = False, sub8x8: bool = False,
                 scaling_default: bool = False):
    """Encode one frame's decisions and residuals on the tensors' device.

    org_*: int planes.  ref_ups [R, 4, 4, H+2P, W+2P] uint8 phase-split
    quarter-pel planes of list 0 (most recent first; slots past ``n_valid``
    repeat the last); ref_us/ref_vs [R, H/2+2PC, W/2+2PC] padded chroma;
    force_intra [mb_h, mb_w] bool.  ``qp``: the frame QP (int) or
    ``n_slices`` per-slice QPs (basic-unit rate control; each slice header
    carries its own).  ``wp_c`` [R, 4] int32: explicit-WP chroma weights
    (wu, ou, wv, ov) per reference, applied after chroma MC (the luma
    weights are already in ``ref_ups``); None without WP.  ``n_slices``
    equal row-band slices (must divide mb_h).  High profile: ``transform8`` (per-MB 8x8
    transform), ``sub8x8`` (P_8x8 sub-partitions), ``scaling_default`` (the
    spec default scaling lists).  Returns (symbols dict of [nmb, ...] int32
    tensors in raster order — with ``t8`` / ``sub`` and ``mvd_s`` when
    those options are on — (rec_y, rec_u, rec_v), ctx dict with nnz/mv/
    ref/mb_intra, and t8 with ``transform8``)."""
    if mb_h % n_slices:
        raise ValueError(f"n_slices {n_slices} must divide mb_h {mb_h}")
    sym, st = _encode_bands(
        org_y, org_u, org_v, ref_ups, ref_us, ref_vs, qp, n_valid,
        force_intra, wp_c, sr=sr, n_slices=n_slices, intra_only=intra_only,
        chroma_qp_offset=chroma_qp_offset, transform8=transform8,
        sub8x8=sub8x8, scaling_default=scaling_default)
    rec, ctx = assemble(sym, st, mb_h, mb_w)
    return sym, rec, ctx


def _encode_bands(org_y, org_u, org_v, ref_ups, ref_us, ref_vs, qp,
                  n_valid: int, force_intra, wp_c=None, *, sr: int,
                  n_slices: int, intra_only: bool, sub8x8: bool, **opts):
    """Stages A and B (span ``avc.search``), then the decision scan, of the
    ``n_slices`` row bands of a picture (or of one mesh slot's bands):
    (sym, band state) of :func:`decide`; ``opts`` are its High-profile and
    chroma options."""
    mb_h, mb_w = org_y.shape[0] // 16, org_y.shape[1] // 16
    R = ref_ups.shape[0]
    nmb = mb_h * mb_w
    if intra_only:
        ns = len(slot_geometry(sub8x8))
        mv_q = torch.zeros((nmb, R, ns, 2), dtype=torch.int32,
                           device=org_y.device)
        sad_q = torch.zeros((nmb, R, ns), dtype=torch.int32,
                            device=org_y.device)
    else:
        with trace.span("avc.search", org_y.device):
            mv_q, sad_q = search(org_y, ref_ups, sr, qp, n_slices, sub8x8)
    return decide(org_y, org_u, org_v, ref_ups, ref_us, ref_vs, mv_q, sad_q,
                  qp, n_valid, force_intra, sr=sr, sb_h=mb_h // n_slices,
                  intra_only=intra_only, sub8x8=sub8x8, wp_c=wp_c, **opts)


# ===========================================================================
# B slices (spec 7.4.3 / 8.4.1.2; JM twins pred_struct.c, mc_direct.c)
# ===========================================================================
#
# Candidates per MB, with the full RD of the P path: B_Direct_16x16 (spatial,
# direct_8x8_inference_flag = 1), B_L0/L1/Bi_16x16 with the best reference
# of each list by ME cost, I16 and I4; B_Skip when direct wins with cbp 0.
# The band state holds one MV field per list (mv0/ref0, mv1/ref1); a list
# an MB does not use has ref -1 in its cells.

# win codes of a B frame's symbols (avc/pack.py WIN_B_*): 0 skip, 1 direct,
# 2 L0, 3 L1, 4 Bi, 5 I4, 6 I16
_QUADS = np.array([(0, 0), (0, 1), (1, 0), (1, 1)], np.int64)


def _minpos(a, b):
    """spec 8.4.1.2.2 MinPositive, elementwise."""
    both = (a >= 0) & (b >= 0)
    return torch.where(both, torch.minimum(a, b), torch.maximum(a, b))


def _direct_spatial_mb(f0, f1, lc, col_mv, col_ref):
    """Spatial direct derivation of one MB per lane (8x8 inference).

    ``f0``/``f1``: the lists' band MV fields (dicts of mv [S, sh4, w4, 2] and
    ref [S, sh4, w4]); col_mv/col_ref: the first list-1 reference's stored
    motion in the same band layout.  Returns (r0, r1 [L], used0, used1
    [L], qmv0, qmv1 [L, 2, 2, 2]): per 8x8 quadrant the MVs, zeroed where
    the colocated MB's corner cell is still (intra colocated counts as
    moving)."""
    dev = lc["band"].device

    def nbr_ref(f):
        _, ra, _ = _cell_read(f, lc, None, None, 0, -1, 0)
        _, rb, _ = _cell_read(f, lc, None, None, -1, 0, 0)
        _, rc, av_c = _cell_read(f, lc, None, None, -1, 4, 0)
        _, rd, _ = _cell_read(f, lc, None, None, -1, -1, 0)
        return _minpos(_minpos(ra, rb), torch.where(av_c, rc, rd))

    r0, r1 = nbr_ref(f0), nbr_ref(f1)
    direct_zero = (r0 < 0) & (r1 < 0)
    used0 = (r0 >= 0) | direct_zero
    used1 = (r1 >= 0) | direct_zero
    r0c = torch.clamp(r0, min=0)
    r1c = torch.clamp(r1, min=0)
    mv0 = _predict_mv(f0, lc, None, None, 0, 0, 4, r0c, "none", 0)
    mv1 = _predict_mv(f1, lc, None, None, 0, 0, 4, r1c, "none", 0)
    mv0 = torch.where(((r0 >= 0) & ~direct_zero)[:, None], mv0, 0)
    mv1 = torch.where(((r1 >= 0) & ~direct_zero)[:, None], mv1, 0)

    # the colocated MB's corner cells (0 / 3) per quadrant
    sh4, w4 = col_ref.shape[1:]
    cyx = _c("corner03", np.array([0, 3], np.int64), dev)
    ys = torch.clamp(lc["by0"][:, None, None] + cyx[:, None], 0, sh4 - 1)
    xs = torch.clamp(lc["bx0"][:, None, None] + cyx[None, :], 0, w4 - 1)
    b = lc["band"][:, None, None]
    rcq = col_ref[b, ys, xs]                                   # [L, 2, 2]
    mcq = col_mv[b, ys, xs]                                    # [L, 2, 2, 2]
    col_zero = (rcq == 0) & (torch.abs(mcq) <= 1).all(-1)
    live = ~direct_zero[:, None, None] & col_zero
    z0 = live & (used0 & (r0c == 0))[:, None, None]
    z1 = live & (used1 & (r1c == 0))[:, None, None]
    L = mv0.shape[0]
    qmv0 = torch.where(z0[..., None], 0, mv0[:, None, None].expand(L, 2, 2, 2))
    qmv1 = torch.where(z1[..., None], 0, mv1[:, None, None].expand(L, 2, 2, 2))
    return (r0c.to(torch.int32), r1c.to(torch.int32), used0, used1,
            qmv0.to(torch.int32), qmv1.to(torch.int32))


def _quad_mc(fr, r, qmv, lc):
    """Per-8x8-quadrant MC of a 16x16 MB and its 8x8 chroma from one list:
    reference ``r`` [L], quadrant MVs qmv [L, 2, 2, 2] -> ([L, 16, 16],
    [L, 2, 8, 8])."""
    dev = r.device
    L = r.shape[0]
    q = _c("quads", _QUADS, dev)
    r4 = r[:, None].expand(L, 4)
    mv4 = qmv.reshape(L, 4, 2)
    pl = _mc_luma(fr, r4, mv4, 16 * lc["mby"][:, None] + 8 * q[:, 0],
                  16 * lc["mbx"][:, None] + 8 * q[:, 1], 8, 8)  # [L, 4, 8, 8]
    pc = _mc_chroma(fr, r4, mv4, 8 * lc["mby"][:, None] + 4 * q[:, 0],
                    8 * lc["mbx"][:, None] + 4 * q[:, 1], 4, 4)  # [L,4,2,4,4]
    return (pl.reshape(L, 2, 2, 8, 8).transpose(2, 3).reshape(L, 16, 16),
            pc.reshape(L, 2, 2, 2, 4, 4).permute(0, 3, 1, 4, 2, 5).reshape(
                L, 2, 8, 8))


def _b_side(f, lc, fr, mv_mb, sad_mb, nv: int, lam_me):
    """One list's 16x16 candidate: the reference of least SAD + lambda_me *
    (ref + MVD bits) among the ``nv`` valid ones, its MVD, bits and
    prediction.  mv_mb [L, R, 2], sad_mb [L, R]."""
    dev = mv_mb.device
    L, R = mv_mb.shape[:2]
    ar = _ar(L, dev)
    rv = _ar(R, dev).to(torch.int32)[None]                     # [1, R]
    pm = _predict_mv(f, lc, None, None, 0, 0, 4, rv, "none", 1)  # [L, R, 2]
    bits = te_bits(rv, nv) + se_bits(mv_mb[..., 0] - pm[..., 0]) \
        + se_bits(mv_mb[..., 1] - pm[..., 1])
    cost = torch.where(rv < nv, _fma(lam_me, bits, sad_mb), BIG)
    ri = torch.argmin(cost, 1)                                  # first minimum
    mv = mv_mb[ar, ri]
    y0, x0 = 16 * lc["mby"], 16 * lc["mbx"]
    return dict(ri=ri.to(torch.int32), mv=mv, mvd=(mv_mb - pm)[ar, ri],
                bits=bits[ar, ri],
                pl=_mc_luma(fr, ri, mv, y0, x0, 16, 16),
                pc=_mc_chroma(fr, ri, mv, y0 // 2, x0 // 2, 8, 8))


def _mb_compute_b(st, lc, fr0, fr1, mv0_mb, sad0_mb, mv1_mb, sad1_mb, col,
                  cfg):
    """Decisions and residuals of one B MB per lane (the counterpart of
    ``tpu_enc._encode_band_b``'s ``mb_compute``); returns (state updates,
    symbols) as [L, ...] tensors without touching ``st``."""
    dev = lc["band"].device
    L = lc["band"].shape[0]
    qp, qpc, lam = cfg["qp"], cfg["qpc"], cfg["lam"]
    ar_p = st["ar_p"][lc["band"]]

    # ---- intra candidates (I16 estimates its bits at nC 0 here) ----
    org16, org2, _, i16, i4, ch = _intra_candidates(st, lc, fr0, cfg,
                                                    i16_nc=False)
    ch_ssd, ch_bits = _chroma_intra_rd(ch, org2)
    i16_cost = _fma(lam, ch_bits, _fma(lam, 13.0, i16["cost"]) + ch_ssd)
    i4_cost = _fma(lam, ch_bits, _fma(lam, 11.0, i4["cost"]) + ch_ssd)

    # ---- direct candidate ----
    f0 = dict(mv=st["mv0"], ref=st["ref0"])
    f1 = dict(mv=st["mv1"], ref=st["ref1"])
    r0d, r1d, used0, used1, qmv0, qmv1 = _direct_spatial_mb(
        f0, f1, lc, col["mv"], col["ref"])
    d0l, d0c = _quad_mc(fr0, r0d, qmv0, lc)
    d1l, d1c = _quad_mc(fr1, r1d, qmv1, lc)
    both = used0 & used1

    def combine(a, b):
        sh = (-1,) + (1,) * (a.dim() - 1)
        return torch.where(both.reshape(sh), (a + b + 1) >> 1,
                           torch.where(used0.reshape(sh), a, b))

    # ---- L0 / L1 / Bi 16x16 ----
    s0 = _b_side(f0, lc, fr0, mv0_mb, sad0_mb, cfg["nv0"], cfg["lam_me"])
    s1 = _b_side(f1, lc, fr1, mv1_mb, sad1_mb, cfg["nv1"], cfg["lam_me"])
    preds_l = torch.stack([combine(d0l, d1l), s0["pl"], s1["pl"],
                           (s0["pl"] + s1["pl"] + 1) >> 1], 1)  # [L,4,16,16]
    preds_c = torch.stack([combine(d0c, d1c), s0["pc"], s1["pc"],
                           (s0["pc"] + s1["pc"] + 1) >> 1], 1)  # [L,4,2,8,8]

    # ---- full RD over the 4 B modes (CAVLC estimates at nC 0) ----
    zzc_m, rec_m, cbpL_m, fadj_m = _code_inter_luma(
        org16[:, None], preds_l, qp, ar_p[:, None, None, None])
    dcl_m, acz_m, crecs_m, cbpC_m = _code_chroma(org2[:, None], preds_c, qpc,
                                                 False)
    ssd_m = _ssd(org16[:, None], rec_m, (-1, -2)) \
        + _ssd(org2[:, None], crecs_m, (-1, -2, -3))
    cbp_m = cbpL_m | (cbpC_m << 4)
    lum_bits = CD.block_bits_est(zzc_m, 0, 16)                  # [L, 4, 16]
    coded = ((cbpL_m[..., None] >> (_ar(16, dev) // 4)) & 1) > 0
    lum_bits = torch.where(coded, lum_bits, 0).sum(-1, dtype=torch.int32)
    cdc_bits = CD.block_bits_est(dcl_m, 0, 4, chroma_dc=True).sum(
        -1, dtype=torch.int32)
    cac_bits = CD.block_bits_est(acz_m.reshape(L, 4, 8, 15), 0, 15).sum(
        -1, dtype=torch.int32)
    res_bits = lum_bits + torch.where(cbpC_m >= 1, cdc_bits, 0) \
        + torch.where(cbpC_m == 2, cac_bits, 0)
    # header bits: mb_type ue + ref te + mvd (direct: mb_type only)
    hdr = torch.stack([torch.ones_like(s0["bits"]), 3 + s0["bits"],
                       3 + s1["bits"], 5 + s0["bits"] + s1["bits"]], 1)
    bits_m = hdr + 1 + _cbp_ue(cbp_m) + (cbp_m > 0).to(torch.int32) + res_bits
    cost_m = _fma(lam, bits_m, ssd_m)

    costs = torch.cat([cost_m, i16_cost[:, None], i4_cost[:, None]], 1)
    win = torch.argmin(costs, 1)                                # 0..5
    is_intra = win >= 4
    use_i16 = win == 4
    win_m = torch.where(is_intra, 0, win)
    is_direct = win == 0
    is_skip = is_direct & (cbpL_m[:, 0] == 0) & (cbpC_m[:, 0] == 0)
    sel_i16 = is_intra & use_i16
    sel_i4 = is_intra & ~use_i16
    nsk = ~is_skip
    n2, n3 = nsk[:, None, None], nsk[:, None, None, None]

    pred16 = _take(preds_l, win_m)
    predc = _take(preds_c, win_m)
    zzc = torch.where(n2, _take(zzc_m, win_m), 0)
    rec16_int = torch.where(n2, _take(rec_m, win_m), pred16)
    cbp_bits_int = torch.where(nsk, _take(cbpL_m, win_m), 0)
    dcl_int = torch.where(n2, _take(dcl_m, win_m), 0)
    acz_int = torch.where(nsk[:, None, None, None, None], _take(acz_m, win_m),
                          0)
    crecs_int = torch.where(n3, _take(crecs_m, win_m), predc)
    cbp_c_int = torch.where(nsk, _take(cbpC_m, win_m), 0)

    w = _winner_outputs(i16, i4, ch, sel_i16, sel_i4, is_skip, pred16, predc,
                        dict(rec16=rec16_int, recc=crecs_int, zzc=zzc,
                             cbp_luma=cbp_bits_int, cbp_chroma=cbp_c_int,
                             dcl=dcl_int, acz=acz_int))

    # ---- MV-field cell updates per winner ----
    use0 = ~is_intra & torch.where(is_direct, used0,
                                   (win_m == 1) | (win_m == 3))
    use1 = ~is_intra & torch.where(is_direct, used1,
                                   (win_m == 2) | (win_m == 3))
    d4 = is_direct[:, None, None, None]

    def cells(qmv, side, use):
        dir_mv = qmv.repeat_interleave(2, 1).repeat_interleave(2, 2)
        mv = torch.where(d4, dir_mv, side["mv"][:, None, None].expand(
            L, 4, 4, 2))
        return torch.where(use[:, None, None, None], mv, 0)

    def ref_cells(rd, side, use):
        r = torch.where(use, torch.where(is_direct, rd, side["ri"]), -1)
        return r[:, None, None].expand(L, 4, 4)

    upd = dict(rec16=w["rec16"], recc=w["recc"],
               mv0_cells=cells(qmv0, s0, use0),
               ref0_cells=ref_cells(r0d, s0, use0),
               mv1_cells=cells(qmv1, s1, use1),
               ref1_cells=ref_cells(r1d, s1, use1),
               nnz_cells=w["nnz_cells"], i4m_cells=w["i4m_cells"],
               ar_i_add=w["ar_i_add"],
               ar_p_add=torch.where((is_skip | is_intra)[:, None, None], 0,
                                    _take(fadj_m, win_m)))

    win_code = torch.where(sel_i16, 6, torch.where(
        sel_i4, 5, torch.where(is_skip, 0, 1 + win_m)))
    i32 = torch.int32
    no_mvd = (is_intra | is_direct)[:, None]
    out = dict(
        win=win_code.to(i32),
        ri0=torch.where(use0 & ~is_direct, s0["ri"], 0).to(i32),
        ri1=torch.where(use1 & ~is_direct, s1["ri"], 0).to(i32),
        mvd0=torch.where(no_mvd, 0, s0["mvd"]).to(i32),
        mvd1=torch.where(no_mvd, 0, s1["mvd"]).to(i32),
        i4flags=i4["flags"].to(i32), i16mode=i16["i16mode"],
        i16dc=i16["dc_zz"].to(i32), cmode=ch["mode"],
        **{k: w[k].to(i32) for k in ("cbp_luma", "cbp_chroma", "zz", "cdc",
                                     "cac")},
        mb_intra=is_intra)
    return upd, out


def decide_b(org_y, org_u, org_v, r0, r1, mv0_q, sad0_q, mv1_q, sad1_q,
             col_mv, col_ref, qp, nv0: int, nv1: int, *, sr: int,
             sb_h: int, chroma_qp_offset: int = 0):
    """The B frame's wavefront decision scan over every row-band slice at
    once, stepped like :func:`decide` (one step eager, the others replayed
    from one CUDA graph on the card, in :func:`_scan`'s spans).

    r0/r1: (ups, us, vs) reference stacks of lists 0 and 1; mv*_q [nmb, R,
    2] / sad*_q [nmb, R] the 16x16 search results of each list; col_mv
    [mb_h*4, mb_w*4, 2] / col_ref [mb_h*4, mb_w*4] the first list-1
    reference's motion.  ``qp`` is the frame's (B sequences take no
    rate control), in the same per-lane form as :func:`decide`'s.
    Returns (sym dict of [nmb, ...] tensors in raster order, band state
    dict)."""
    dev = org_y.device
    H, W = org_y.shape
    mb_h, mb_w = H // 16, W // 16
    S = mb_h // sb_h
    sh4, w4 = sb_h * 4, mb_w * 4
    cfg = dict(_lane_cfg(qp, mb_h, sb_h, chroma_qp_offset, dev),
               nv0=nv0, nv1=nv1, mb_w=mb_w, qm=None)
    fr0 = _frame_inputs(org_y, org_u, org_v, *r0, sr, sb_h)
    fr1 = _frame_inputs(org_y, org_u, org_v, *r1, sr, sb_h)
    col = dict(mv=col_mv.to(torch.int32).reshape(S, sh4, w4, 2),
               ref=col_ref.to(torch.int32).reshape(S, sh4, w4))

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.int32, device=dev)

    st = dict(rec_y=full((S, sb_h * 16 + 1, W + 9), 0),
              rec_u=full((S, sb_h * 8 + 1, W // 2 + 1), 0),
              rec_v=full((S, sb_h * 8 + 1, W // 2 + 1), 0),
              mv0=full((S, sh4, w4, 2), 0), ref0=full((S, sh4, w4), -2),
              mv1=full((S, sh4, w4, 2), 0), ref1=full((S, sh4, w4), -2),
              nnz_y=full((S, sh4, w4), 0), i4m=full((S, sh4, w4), -1),
              ar_i=full((S, 4, 4), Q.OFFSET_INTRA),
              ar_p=full((S, 4, 4), Q.OFFSET_INTER))
    lane = _ar(mb_h, dev)
    band = lane // sb_h
    lr = lane % sb_h

    def step(t):
        """One wavefront step; ``t`` a 0-dim int64 tensor on the device."""
        cs = t - 2 * lr
        valid = (cs >= 0) & (cs < mb_w)
        mbx = torch.clamp(cs, 0, mb_w - 1)
        g = lane * mb_w + mbx
        lc = dict(band=band, mby=lr, mbx=mbx, by0=4 * lr, bx0=4 * mbx, g=g)
        upd, out = _mb_compute_b(st, lc, fr0, fr1, mv0_q[g], sad0_q[g],
                                 mv1_q[g], sad1_q[g], col, cfg)
        _put(st["rec_y"], band, 16 * lr + 1, 16 * mbx + 1, upd["rec16"], valid)
        _put(st["rec_u"], band, 8 * lr + 1, 8 * mbx + 1, upd["recc"][:, 0],
             valid)
        _put(st["rec_v"], band, 8 * lr + 1, 8 * mbx + 1, upd["recc"][:, 1],
             valid)
        for key in ("mv0", "ref0", "mv1", "ref1"):
            _put(st[key], band, 4 * lr, 4 * mbx, upd[key + "_cells"], valid)
        for key, val in (("nnz_y", "nnz_cells"), ("i4m", "i4m_cells")):
            _put(st[key], band, 4 * lr, 4 * mbx, upd[val], valid)
        vm = valid[:, None, None]
        for key in ("ar_i", "ar_p"):
            add = torch.where(vm, upd[key + "_add"], 0).reshape(
                S, sb_h, 4, 4).sum(1, dtype=torch.int32)
            st[key].copy_(torch.clamp(st[key] + add, 0, Q.AR_RANGE))
        return out

    ys = _scan(step, mb_w + 2 * (sb_h - 1), dev)
    rows = _ar(mb_h * mb_w, dev) // mb_w
    t_idx = _ar(mb_h * mb_w, dev) % mb_w + 2 * (rows % sb_h)
    sym = {k: torch.stack([y[k] for y in ys])[t_idx, rows] for k in ys[0]}
    return sym, st


def encode_frame_b(org_y, org_u, org_v, r0_ups, r0_us, r0_vs, r1_ups, r1_us,
                   r1_vs, col_mv, col_ref, qp, nv0: int, nv1: int, *,
                   mb_h: int, mb_w: int, sr: int, chroma_qp_offset: int = 0,
                   n_slices: int = 1):
    """Encode one B frame's decisions and residuals on the tensors' device
    (port of ``tpu_enc.encode_frame_b``).

    The contract of :func:`encode_frame` plus the list-1 reference stack
    and the colocated motion (mv [mb_h*4, mb_w*4, 2] / ref [mb_h*4,
    mb_w*4] of the first list-1 reference, for spatial direct).  Stages A
    and B run per list over the 16x16 slot.  Returns (sym, rec, ctx with
    nnz/mv0/ref0/mv1/ref1/mb_intra)."""
    if mb_h % n_slices:
        raise ValueError(f"n_slices {n_slices} must divide mb_h {mb_h}")
    sym, st = _encode_bands_b(
        org_y, org_u, org_v, (r0_ups, r0_us, r0_vs), (r1_ups, r1_us, r1_vs),
        col_mv, col_ref, qp, nv0, nv1, sr=sr, n_slices=n_slices,
        chroma_qp_offset=chroma_qp_offset)
    return (sym,) + assemble_b(sym, st, mb_h, mb_w)


def _encode_bands_b(org_y, org_u, org_v, r0, r1, col_mv, col_ref, qp,
                    nv0: int, nv1: int, *, sr: int, n_slices: int,
                    chroma_qp_offset: int = 0):
    """Both lists' Stages A and B over the 16x16 slot, then the B decision
    scan, of the ``n_slices`` row bands of a picture (or of one mesh slot's
    bands); r0/r1 the (ups, us, vs) stacks (span ``avc.search`` around
    both lists' stages).  Returns (sym, band state)."""
    with trace.span("avc.search", org_y.device):
        (mv0_q, sad0_q), (mv1_q, sad1_q) = (
            tuple(x[:, :, 0] for x in search(org_y, r[0], sr, qp, n_slices,
                                              only16=True))
            for r in (r0, r1))
    return decide_b(org_y, org_u, org_v, r0, r1, mv0_q, sad0_q, mv1_q,
                    sad1_q, col_mv, col_ref, qp, nv0, nv1, sr=sr,
                    sb_h=org_y.shape[0] // 16 // n_slices,
                    chroma_qp_offset=chroma_qp_offset)


def assemble_b(sym, st, mb_h: int, mb_w: int):
    """B band state -> frame reconstruction and the deblocking context."""
    H, W = mb_h * 16, mb_w * 16
    h4, w4 = mb_h * 4, mb_w * 4
    rec = (st["rec_y"][:, 1:, 1:W + 1].reshape(H, W),
           st["rec_u"][:, 1:, 1:].reshape(H // 2, W // 2),
           st["rec_v"][:, 1:, 1:].reshape(H // 2, W // 2))
    ctx = dict(nnz=st["nnz_y"].reshape(h4, w4),
               mv0=st["mv0"].reshape(h4, w4, 2),
               ref0=torch.clamp(st["ref0"], min=-1).reshape(h4, w4),
               mv1=st["mv1"].reshape(h4, w4, 2),
               ref1=torch.clamp(st["ref1"], min=-1).reshape(h4, w4),
               mb_intra=sym["mb_intra"].reshape(mb_h, mb_w))
    return rec, ctx


# ===========================================================================
# Mesh sharding: row-band slices over the slots of one mesh axis
# ===========================================================================
#
# Slices reset every context, so a picture's bands are independent: each
# slot encodes its run of bands on its own device with the band views the
# unsharded encoder reads (the padded reference rows a band's view covers
# are real neighbour-band pixels), and the host puts the bands back
# together in order.  Each slot's decision scan captures its own CUDA graph
# (``_capture`` runs per thread on a side stream of the slot's device).

def band_slots(mesh, axis: str, mb_h: int, n_slices: int):
    """(slot devices along ``axis``, bands per slot); raises unless the
    bands divide the picture and split evenly over the slots."""
    if mb_h % n_slices:
        raise ValueError(f"n_slices {n_slices} must divide mb_h {mb_h}")
    devs = mesh.axis_devices(axis)
    if n_slices % len(devs):
        raise ValueError(f"n_slices {n_slices} must divide over "
                         f"{len(devs)} devices on mesh axis {axis!r}")
    return devs, n_slices // len(devs)


def _slot_rows(b0: int, nb: int, sb_h: int, sr: int):
    """Row ranges of slot bands [b0, b0 + nb): (luma rows of the picture,
    luma rows of the padded reference planes, their chroma twins), as
    ``tpu_enc._band_views`` gives each band rows [s*bandH, s*bandH + bandH
    + 2P) of the padded planes."""
    band_h = sb_h * 16
    y0, y1 = b0 * band_h, (b0 + nb) * band_h
    P, PC = luma_pad(sr), chroma_pad(sr)
    return (slice(y0, y1), slice(y0, y1 + 2 * P),
            slice(y0 // 2, y1 // 2), slice(y0 // 2, y1 // 2 + 2 * PC))


def _slot_qp(qp, b0: int, nb: int):
    """The frame QP, or the slot's run of per-slice QPs."""
    if isinstance(qp, (int, np.integer)):
        return int(qp)
    return [int(q) for q in np.asarray(qp).reshape(-1)[b0:b0 + nb]]


def _to(x, dev):
    return x.to(dev).contiguous()


def _gather_bands(parts, home) -> dict:
    """Per-slot dicts of band-major tensors -> one dict on ``home``."""
    return {k: gather([p[k] for p in parts], home) for k in parts[0]}


def make_sharded_encode(mesh, axis: str, *, mb_h: int, mb_w: int, sr: int,
                        intra_only: bool, chroma_qp_offset: int = 0,
                        n_slices: int = 1, transform8: bool = False,
                        sub8x8: bool = False, scaling_default: bool = False):
    """A frame encoder sharded over the slots of ``mesh`` axis ``axis``
    (``tpu_enc.make_sharded_encode``): the picture's ``n_slices`` row-band
    slices are split over the slots (``n_slices`` a multiple of the slot
    count) and each slot runs Stages A and B and the decision scan of its
    bands on its own device.  The returned callable has the signature and
    outputs of :func:`encode_frame`, on the device of ``org_y``, and gives
    the same symbols; explicit WP (``wp_c``) is not sharded and raises."""
    devs, nb = band_slots(mesh, axis, mb_h, n_slices)
    sb_h = mb_h // n_slices
    opts = dict(sr=sr, n_slices=nb, intra_only=intra_only, sub8x8=sub8x8,
                chroma_qp_offset=chroma_qp_offset, transform8=transform8,
                scaling_default=scaling_default)

    def encode(org_y, org_u, org_v, ref_ups, ref_us, ref_vs, qp,
               n_valid: int, force_intra, wp_c=None):
        if wp_c is not None:
            raise NotImplementedError("WP is not mesh-sharded")
        home = org_y.device
        syms, sts = [], []
        for k, dev in enumerate(devs):
            ry, rp, rc, rpc = _slot_rows(k * nb, nb, sb_h, sr)
            sym, st = _encode_bands(
                _to(org_y[ry], dev), _to(org_u[rc], dev),
                _to(org_v[rc], dev), _to(ref_ups[..., rp, :], dev),
                _to(ref_us[:, rpc], dev), _to(ref_vs[:, rpc], dev),
                _slot_qp(qp, k * nb, nb), n_valid,
                _to(force_intra[k * nb * sb_h:(k + 1) * nb * sb_h], dev),
                **opts)
            syms.append(sym)
            sts.append(st)
        sym = _gather_bands(syms, home)
        rec, ctx = assemble(sym, _gather_bands(sts, home), mb_h, mb_w)
        return sym, rec, ctx

    return encode


def make_sharded_encode_b(mesh, axis: str, *, mb_h: int, mb_w: int,
                          sr: int, chroma_qp_offset: int = 0,
                          n_slices: int = 1):
    """The mesh-sharded twin of :func:`encode_frame_b`
    (``tpu_enc.make_sharded_encode_b``): row-band slices over the slots of
    ``axis``, each slot with its bands' views of both lists' references and
    its rows of the colocated motion."""
    devs, nb = band_slots(mesh, axis, mb_h, n_slices)
    sb_h = mb_h // n_slices

    def encode(org_y, org_u, org_v, r0_ups, r0_us, r0_vs, r1_ups, r1_us,
               r1_vs, col_mv, col_ref, qp, nv0: int, nv1: int):
        home = org_y.device
        syms, sts = [], []
        for k, dev in enumerate(devs):
            ry, rp, rc, rpc = _slot_rows(k * nb, nb, sb_h, sr)
            c4 = slice(k * nb * sb_h * 4, (k + 1) * nb * sb_h * 4)
            refs = [(_to(ups[..., rp, :], dev), _to(us[:, rpc], dev),
                     _to(vs[:, rpc], dev))
                    for ups, us, vs in ((r0_ups, r0_us, r0_vs),
                                        (r1_ups, r1_us, r1_vs))]
            sym, st = _encode_bands_b(
                _to(org_y[ry], dev), _to(org_u[rc], dev),
                _to(org_v[rc], dev), *refs, _to(col_mv[c4], dev),
                _to(col_ref[c4], dev), _slot_qp(qp, k * nb, nb), nv0, nv1,
                sr=sr, n_slices=nb, chroma_qp_offset=chroma_qp_offset)
            syms.append(sym)
            sts.append(st)
        sym = _gather_bands(syms, home)
        return (sym,) + assemble_b(sym, _gather_bands(sts, home), mb_h, mb_w)

    return encode
