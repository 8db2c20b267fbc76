"""Conformant H.264 I-slice encoder (host reference model, numpy).

Encodes a frame as one IDR I slice in real H.264 syntax (CAVLC, Baseline):
MBs in raster order, intra 4x4 (9 modes) + intra 16x16 (4 modes) with
Lagrangian RD mode decision, chroma 8x8 intra, per-spec CBP / mb_qp_delta /
residual ordering, and per-spec nC (TotalCoeff) neighbor contexts.

The output decodes bit-exactly in JM 18.5 ``ldecod`` (conformance oracle;
tests/test_avc_conformance.py).  Reference call stack: SURVEY §3.1 —
``i_encode_one_macroblock`` FR/src/rdopt.c:1682, ``write_one_macroblock``
FR/src/macroblock.c:2487; JM 18.5 twins ``JM/lencod/src/macroblock.c``,
``JM/ldecod/src/mb_read.c:1139``.

The port's own copy of ``h264tpu/avc/slice_enc.py`` (host numpy, as there;
it imports nothing from ``h264tpu``).  Spatial direct comes from the port's
decoder, which defines it once for both; the coefficient-cost table from
``ops/transform.py``.
"""

from __future__ import annotations

import numpy as np

from ..entropy.bitio import BitWriter
from . import quant as Q
from . import intra_pred as IP
from . import cavlc as CV
from .tables import (BLOCK_SCAN, BLOCK_SCAN_INV, CBP_TO_CODENUM_INTRA,
                     mb_type_i16, MB_I4x4)
from .params import AVCParams, write_slice_header, SLICE_I


def lambda_mode(qp: int) -> float:
    """Lagrangian multiplier for mode decision (JM: 0.85 * 2^((QP-12)/3))."""
    return 0.85 * 2.0 ** ((qp - 12) / 3.0)


class FrameState:
    """Per-frame reconstruction + entropy-context state (one slice)."""

    def __init__(self, p: AVCParams):
        self.p = p
        h, w = p.height, p.width
        self.rec_y = np.zeros((h, w), np.int64)
        self.rec_u = np.zeros((h // 2, w // 2), np.int64)
        self.rec_v = np.zeros((h // 2, w // 2), np.int64)
        # TotalCoeff per 4x4 block (decoder-visible nnz bookkeeping)
        self.nnz_y = np.zeros((p.mb_h * 4, p.mb_w * 4), np.int64)
        self.nnz_c = np.zeros((2, p.mb_h * 2, p.mb_w * 2), np.int64)
        # intra 4x4 mode per block; -1 = "not coded in Intra_4x4" (spec -> DC)
        self.i4_modes = np.full((p.mb_h * 4, p.mb_w * 4), -1, np.int64)
        self.mb_qp = np.full((p.mb_h, p.mb_w), p.qp, np.int64)
        self.mb_intra = np.zeros((p.mb_h, p.mb_w), bool)
        # slice machinery (spec 6.4.11 availability: same slice + decoded).
        # Single-slice raster default: slice 0, decoded-before == raster-<.
        self.slice_id = np.zeros((p.mb_h, p.mb_w), np.int64)
        self.mb_decoded = np.zeros((p.mb_h, p.mb_w), bool)
        self.cur_slice = 0

    def mb_avail(self, mby: int, mbx: int) -> bool:
        """Neighbor MB availability: inside picture, already decoded, and in
        the current slice (spec 6.4.11 with FMO slice groups)."""
        if mby < 0 or mbx < 0 or mby >= self.p.mb_h or mbx >= self.p.mb_w:
            return False
        return bool(self.mb_decoded[mby, mbx]) and \
            int(self.slice_id[mby, mbx]) == self.cur_slice


def _blk_avail(st: FrameState, by: int, bx: int, cells: int,
               cur_mby: int, cur_mbx: int) -> bool:
    """Availability of the 4x4/chroma block (by, bx) seen from the MB
    currently being coded; ``cells`` = blocks per MB side (4 luma, 2 ch)."""
    if by < 0 or bx < 0:
        return False
    nb_mby, nb_mbx = by // cells, bx // cells
    if (nb_mby, nb_mbx) == (cur_mby, cur_mbx):
        return True                    # same MB, earlier in coding order
    return st.mb_avail(nb_mby, nb_mbx)


def _nc_luma(st: FrameState, by: int, bx: int) -> int:
    """nC for the luma 4x4 block at plane block coords (by, bx)."""
    cur = (by // 4, bx // 4)
    has_a = _blk_avail(st, by, bx - 1, 4, *cur)
    has_b = _blk_avail(st, by - 1, bx, 4, *cur)
    na = int(st.nnz_y[by, bx - 1]) if has_a else 0
    nb = int(st.nnz_y[by - 1, bx]) if has_b else 0
    if has_a and has_b:
        return (na + nb + 1) >> 1
    return na if has_a else (nb if has_b else 0)


def _nc_chroma(st: FrameState, comp: int, by: int, bx: int) -> int:
    cur = (by // 2, bx // 2)
    has_a = _blk_avail(st, by, bx - 1, 2, *cur)
    has_b = _blk_avail(st, by - 1, bx, 2, *cur)
    na = int(st.nnz_c[comp, by, bx - 1]) if has_a else 0
    nb = int(st.nnz_c[comp, by - 1, bx]) if has_b else 0
    if has_a and has_b:
        return (na + nb + 1) >> 1
    return na if has_a else (nb if has_b else 0)


def _gather_i4_neighbors(rec: np.ndarray, y: int, x: int, avail_tr: bool):
    """top9 / left4 / corner samples for a 4x4 block at pixel (y, x)."""
    H, W = rec.shape
    top9 = np.zeros(8, np.int64)
    if y > 0:
        hi = min(x + 8, W)
        top9[:hi - x] = rec[y - 1, x:hi]
        if hi - x < 8:
            top9[hi - x:] = rec[y - 1, hi - 1]
    left4 = rec[y:y + 4, x - 1] if x > 0 else np.zeros(4, np.int64)
    corner = rec[y - 1, x - 1] if (y > 0 and x > 0) else 0
    return top9, left4, corner


def _code_4x4(org: np.ndarray, pred: np.ndarray, qp: int):
    """Transform/quant/recon one 4x4 residual (intra).  -> (zz16, recon)."""
    w = Q.fdct4x4(org - pred)
    lev = Q.quant4x4(w, qp, intra=True)
    rec = Q.reconstruct(pred, Q.idct4x4(Q.dequant4x4(lev, qp)))
    return Q.zigzag(lev), rec


def encode_i4x4_mb(st: FrameState, org_y: np.ndarray, mby: int, mbx: int,
                   qp: int, lam: float):
    """Intra 4x4 coding of one MB.  Returns dict with modes, zz levels,
    recon written into st.rec_y, total RD cost and bits."""
    p = st.p
    y0, x0 = mby * 16, mbx * 16
    modes = np.zeros(16, np.int64)
    zzs = np.zeros((16, 16), np.int64)
    flags = []          # (prev_flag, rem) pairs in coding order
    ssd_total = 0
    bits_total = 0

    for k in range(16):
        y4, x4 = int(BLOCK_SCAN[k][0]), int(BLOCK_SCAN[k][1])
        by, bx = mby * 4 + y4, mbx * 4 + x4
        y, x = y0 + y4 * 4, x0 + x4 * 4
        avail_t = _blk_avail(st, by - 1, bx, 4, mby, mbx)
        avail_l = _blk_avail(st, by, bx - 1, 4, mby, mbx)
        # top-right 4x4 (spec 6.4.11.4): available same-slice MB, or the
        # same MB with a smaller coding-order index
        tr_by, tr_bx = by - 1, bx + 1
        if tr_by < 0 or tr_bx >= p.mb_w * 4:
            avail_tr = False
        elif (tr_by // 4, tr_bx // 4) == (mby, mbx):
            avail_tr = int(BLOCK_SCAN_INV[y4 - 1, x4 + 1]) < k
        else:
            avail_tr = st.mb_avail(tr_by // 4, tr_bx // 4)

        top9, left4, corner = _gather_i4_neighbors(st.rec_y, y, x, avail_tr)
        preds, allowed = IP.pred4x4_all(top9, left4, corner,
                                        avail_t, avail_l, avail_tr)
        # most probable mode (spec 8.3.1.1)
        ma = int(st.i4_modes[by, bx - 1]) if avail_l else -2
        mb_ = int(st.i4_modes[by - 1, bx]) if avail_t else -2
        if ma == -2 or mb_ == -2:
            mpm = 2
        else:
            mpm = min(ma if ma >= 0 else 2, mb_ if mb_ >= 0 else 2)

        org = org_y[y:y + 4, x:x + 4].astype(np.int64)
        nc = _nc_luma(st, by, bx)
        best = None
        for m in range(9):
            if not allowed[m]:
                continue
            zz, rec = _code_4x4(org, preds[m], qp)
            ssd = int(((org - rec) ** 2).sum())
            mode_bits = 1 if m == mpm else 4
            coeff_bits = CV.block_bits(zz, nc, 16)
            cost = ssd + lam * (mode_bits + coeff_bits)
            if best is None or cost < best[0]:
                best = (cost, m, zz, rec, mode_bits + coeff_bits, ssd)
        _, m, zz, rec, bits, ssd = best
        modes[k] = m
        zzs[k] = zz
        st.rec_y[y:y + 4, x:x + 4] = rec
        st.i4_modes[by, bx] = m
        st.nnz_y[by, bx] = int((zz != 0).sum())
        if m == mpm:
            flags.append((1, None))
        else:
            flags.append((0, m - (1 if m > mpm else 0)))
        ssd_total += ssd
        bits_total += bits
    return dict(modes=modes, zzs=zzs, flags=flags,
                cost=ssd_total + lam * bits_total, ssd=ssd_total)


def encode_i16_mb(st: FrameState, org_y: np.ndarray, mby: int, mbx: int,
                  qp: int, lam: float):
    """Intra 16x16 coding of one MB (all 4 modes, RD pick).

    Returns dict with i16mode, dc_zz (16 scan levels), ac_zzs [16,15],
    cbp_luma flag, recon (16x16), cost."""
    p = st.p
    y0, x0 = mby * 16, mbx * 16
    avail_t = st.mb_avail(mby - 1, mbx)
    avail_l = st.mb_avail(mby, mbx - 1)
    top16 = st.rec_y[y0 - 1, x0:x0 + 16] if avail_t else np.zeros(16, np.int64)
    left16 = st.rec_y[y0:y0 + 16, x0 - 1] if avail_l else np.zeros(16, np.int64)
    corner = st.rec_y[y0 - 1, x0 - 1] if (avail_t and avail_l) else 0
    preds, allowed = IP.pred16x16_all(top16, left16, corner, avail_t, avail_l)
    org = org_y[y0:y0 + 16, x0:x0 + 16].astype(np.int64)

    best = None
    for m in range(4):
        if not allowed[m]:
            continue
        res = org - preds[m]
        blocks = res.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3)  # [y4][x4][4][4]
        w = Q.fdct4x4(blocks)
        dc = w[:, :, 0, 0]
        had = Q.hadamard4x4_fwd(dc)
        dc_lev = Q.quant_dc16(had, qp)
        dc_deq = Q.dequant_dc16(dc_lev, qp)

        ac_lev = Q.quant4x4(w, qp, intra=True)
        ac_lev[:, :, 0, 0] = 0
        ac_zz_all = Q.zigzag(ac_lev)[:, :, 1:]                   # [4,4,15]
        cbp_luma = bool((ac_zz_all != 0).any())
        deq = Q.dequant4x4(ac_lev, qp) if cbp_luma else np.zeros_like(w)
        deq[:, :, 0, 0] = dc_deq
        rec_b = Q.reconstruct(preds[m].reshape(4, 4, 4, 4).transpose(0, 2, 1, 3),
                              Q.idct4x4(deq))
        rec = rec_b.transpose(0, 2, 1, 3).reshape(16, 16)
        ssd = int(((org - rec) ** 2).sum())

        # dc scan levels in 4x4 zig-zag over the DC block
        dc_zz = Q.zigzag(dc_lev.reshape(1, 4, 4))[0]
        # bits: mb_type (depends on cbp -> accounted by caller), residual
        bits = 0
        # order ac zz by coding order for bit counting (nC needs state; use
        # in-MB approximation nc=0 for cost only — exact bits are written later)
        for k in range(16):
            y4, x4 = int(BLOCK_SCAN[k][0]), int(BLOCK_SCAN[k][1])
            if cbp_luma:
                bits += CV.block_bits(ac_zz_all[y4, x4], 0, 15)
        bits += CV.block_bits(dc_zz, 0, 16)
        cost = ssd + lam * bits
        if best is None or cost < best[0]:
            best = (cost, m, dc_zz, ac_zz_all, cbp_luma, rec, ssd)
    cost, m, dc_zz, ac_zz_all, cbp_luma, rec, ssd = best
    return dict(i16mode=m, dc_zz=dc_zz, ac_zzs=ac_zz_all, cbp_luma=cbp_luma,
                rec=rec, cost=cost, ssd=ssd)


def encode_chroma_mb(st: FrameState, org_u, org_v, mby: int, mbx: int,
                     qpc: int):
    """Chroma intra coding for one MB: mode decision (SAD) + residual.

    Returns dict with mode, per-component dc levels [4], ac_zzs [2,2,2,15],
    recons, cbp_chroma."""
    y0, x0 = mby * 8, mbx * 8
    avail_t = st.mb_avail(mby - 1, mbx)
    avail_l = st.mb_avail(mby, mbx - 1)
    comps = []
    for rec_p, org_p in ((st.rec_u, org_u), (st.rec_v, org_v)):
        top8 = rec_p[y0 - 1, x0:x0 + 8] if avail_t else np.zeros(8, np.int64)
        left8 = rec_p[y0:y0 + 8, x0 - 1] if avail_l else np.zeros(8, np.int64)
        corner = rec_p[y0 - 1, x0 - 1] if (avail_t and avail_l) else 0
        preds, allowed = IP.pred_chroma_all(top8, left8, corner,
                                            avail_t, avail_l)
        org = org_p[y0:y0 + 8, x0:x0 + 8].astype(np.int64)
        comps.append((preds, allowed, org))

    best_mode, best_sad = None, None
    for m in range(4):
        if not (comps[0][1][m] and comps[1][1][m]):
            continue
        sad = sum(int(np.abs(c[2] - c[0][m]).sum()) for c in comps)
        if best_sad is None or sad < best_sad:
            best_mode, best_sad = m, sad

    dc_levels = np.zeros((2, 4), np.int64)
    ac_zzs = np.zeros((2, 2, 2, 15), np.int64)
    recs = []
    any_dc = False
    any_ac = False
    for ci, (preds, _allowed, org) in enumerate(comps):
        pred = preds[best_mode]
        res = org - pred
        blocks = res.reshape(2, 4, 2, 4).transpose(0, 2, 1, 3)   # [2][2][4][4]
        w = Q.fdct4x4(blocks)
        dc = w[:, :, 0, 0]                                       # [2,2]
        had = Q.hadamard2x2_fwd(dc)                              # [4]
        dc_lev = Q.quant_dc_chroma(had, qpc, intra=True)
        dc_deq = Q.dequant_dc_chroma(dc_lev, qpc)                # [2,2]
        ac_lev = Q.quant4x4(w, qpc, intra=True)
        ac_lev[:, :, 0, 0] = 0
        ac_zz = Q.zigzag(ac_lev)[:, :, 1:]
        any_ac |= bool((ac_zz != 0).any())
        any_dc |= bool((dc_lev != 0).any())
        dc_levels[ci] = dc_lev
        ac_zzs[ci] = ac_zz
        recs.append((pred, ac_lev, dc_deq))

    cbp_chroma = 2 if any_ac else (1 if any_dc else 0)
    out_recs = []
    for pred, ac_lev, dc_deq in recs:
        deq = Q.dequant4x4(ac_lev, qpc) if cbp_chroma == 2 else \
            np.zeros_like(ac_lev)
        deq[:, :, 0, 0] = dc_deq if cbp_chroma >= 1 else 0
        rec_b = Q.reconstruct(pred.reshape(2, 4, 2, 4).transpose(0, 2, 1, 3),
                              Q.idct4x4(deq))
        out_recs.append(rec_b.transpose(0, 2, 1, 3).reshape(8, 8))
    if cbp_chroma < 2:
        ac_zzs[:] = 0
    if cbp_chroma < 1:
        dc_levels[:] = 0
    return dict(mode=best_mode, dc_levels=dc_levels, ac_zzs=ac_zzs,
                recs=out_recs, cbp_chroma=cbp_chroma)


def write_intra_mb(w: BitWriter, st: FrameState, mby: int, mbx: int,
                   luma, chroma, use_i16: bool, qp_delta: int = 0):
    """Emit macroblock_layer() for one intra MB (spec 7.3.5), updating nnz."""
    p = st.p
    if use_i16:
        cbp_luma_bits = 15 if luma["cbp_luma"] else 0
        w.ue(mb_type_i16(luma["i16mode"], chroma["cbp_chroma"],
                         luma["cbp_luma"]))
    else:
        w.ue(MB_I4x4)
        for flag, rem in luma["flags"]:
            w.u(flag, 1)
            if not flag:
                w.u(rem, 3)
    w.ue(chroma["mode"])
    if not use_i16:
        # coding order groups blocks by 8x8: block k belongs to b8 = k // 4
        cbp_luma_bits = 0
        for b8 in range(4):
            if (luma["zzs"][4 * b8:4 * b8 + 4] != 0).any():
                cbp_luma_bits |= 1 << b8
        cbp = cbp_luma_bits | (chroma["cbp_chroma"] << 4)
        w.ue(int(CBP_TO_CODENUM_INTRA[cbp]))
    else:
        cbp = cbp_luma_bits | (chroma["cbp_chroma"] << 4)

    if cbp > 0 or use_i16:
        w.se(qp_delta)

    # ---- residual() ----
    if use_i16:
        nc = _nc_luma(st, mby * 4, mbx * 4)
        CV.write_block(w, luma["dc_zz"], nc, 16)
        for k in range(16):
            y4, x4 = int(BLOCK_SCAN[k][0]), int(BLOCK_SCAN[k][1])
            by, bx = mby * 4 + y4, mbx * 4 + x4
            if luma["cbp_luma"]:
                nc = _nc_luma(st, by, bx)
                tot = CV.write_block(w, luma["ac_zzs"][y4, x4], nc, 15)
                st.nnz_y[by, bx] = tot
            else:
                st.nnz_y[by, bx] = 0
    else:
        for k in range(16):
            y4, x4 = int(BLOCK_SCAN[k][0]), int(BLOCK_SCAN[k][1])
            by, bx = mby * 4 + y4, mbx * 4 + x4
            b8 = (y4 // 2) * 2 + (x4 // 2)
            if cbp_luma_bits & (1 << b8):
                nc = _nc_luma(st, by, bx)
                tot = CV.write_block(w, luma["zzs"][k], nc, 16)
                st.nnz_y[by, bx] = tot
            else:
                st.nnz_y[by, bx] = 0

    if chroma["cbp_chroma"] > 0:
        for ci in range(2):
            CV.write_block(w, chroma["dc_levels"][ci], -1, 4)
    for ci in range(2):
        for by4 in range(2):
            for bx4 in range(2):
                cby, cbx = mby * 2 + by4, mbx * 2 + bx4
                if chroma["cbp_chroma"] == 2:
                    nc = _nc_chroma(st, ci, cby, cbx)
                    tot = CV.write_block(w, chroma["ac_zzs"][ci, by4, bx4],
                                         nc, 15)
                    st.nnz_c[ci, cby, cbx] = tot
                else:
                    st.nnz_c[ci, cby, cbx] = 0


def slice_group_map(p: AVCParams) -> np.ndarray:
    """FMO mapUnitToSliceGroupMap (spec 8.2.2) -> [mb_h, mb_w] group ids.

    Types: 0 interleaved (runs of one MB row, matching the PPS run lengths
    we emit), 1 dispersed (spec 8.2.2.2 formula).  TPU-framework twin of
    ``FR/src/fmo.c:233`` FmoInit; the full 7-type generator toolbox lives in
    ``models/resilience.py`` (FVC path)."""
    G = p.slice_groups
    mbs = np.arange(p.mb_h * p.mb_w)
    if G == 1:
        grp = np.zeros_like(mbs)
    elif p.slice_group_map_type == 0:
        grp = (mbs // p.mb_w) % G
    elif p.slice_group_map_type == 1:
        grp = ((mbs % p.mb_w) + (((mbs // p.mb_w) * G) // 2)) % G
    else:
        raise NotImplementedError("map type 2..6 (use models/resilience)")
    return grp.reshape(p.mb_h, p.mb_w)


def encode_i_frame(org_yuv, p: AVCParams, qp: int = None, frame_num: int = 0,
                   idr: bool = True, idr_pic_id: int = 0,
                   long_term_idr: bool = False, poc_lsb: int = 0):
    """Encode one frame as IDR I slice(s) — one slice per FMO slice group.

    org_yuv: (Y [H,W], U, V) uint8 arrays.
    Returns (rbsp bytes | list of rbsp bytes when slice_groups > 1,
    (rec_y, rec_u, rec_v) BEFORE deblocking, stats dict).  The caller applies
    the spec deblocking filter (avc.deblock) to get the decoder-output
    reconstruction.
    """
    qp = p.qp if qp is None else qp
    qpc = Q.chroma_qp(qp, p.chroma_qp_offset)
    lam = lambda_mode(qp)
    org_y, org_u, org_v = (np.asarray(x, np.int64) for x in org_yuv)
    st = FrameState(p)
    st.mb_intra[:] = True
    st.mb_qp[:] = qp
    gmap = slice_group_map(p)
    st.slice_id[:] = gmap

    rbsps = []
    n_i16 = 0
    for g in range(p.slice_groups):
        order = [(int(a) // p.mb_w, int(a) % p.mb_w)
                 for a in np.flatnonzero(gmap.reshape(-1) == g)]
        st.cur_slice = g
        w = BitWriter()
        write_slice_header(w, p, SLICE_I, frame_num, idr, qp,
                           idr_pic_id=idr_pic_id,
                           first_mb=order[0][0] * p.mb_w + order[0][1],
                           long_term_idr=long_term_idr, poc_lsb=poc_lsb)
        for mby, mbx in order:
            # evaluate I16 first on the current recon state, then I4 (which
            # mutates rec_y block by block); restore if I16 wins
            i16 = encode_i16_mb(st, org_y, mby, mbx, qp, lam)
            saved_rec = st.rec_y[mby * 16:mby * 16 + 16,
                                 mbx * 16:mbx * 16 + 16].copy()
            saved_modes = st.i4_modes[mby * 4:mby * 4 + 4,
                                      mbx * 4:mbx * 4 + 4].copy()
            saved_nnz = st.nnz_y[mby * 4:mby * 4 + 4,
                                 mbx * 4:mbx * 4 + 4].copy()
            i4 = encode_i4x4_mb(st, org_y, mby, mbx, qp, lam)
            # syntax-bit difference: I4 pays CBP + 16 mode flags; I16 pays
            # mb_type range; both folded into the per-mode bit counts above
            use_i16 = i16["cost"] < i4["cost"]
            if use_i16:
                st.rec_y[mby * 16:mby * 16 + 16,
                         mbx * 16:mbx * 16 + 16] = i16["rec"]
                st.i4_modes[mby * 4:mby * 4 + 4,
                            mbx * 4:mbx * 4 + 4] = -1
                st.nnz_y[mby * 4:mby * 4 + 4,
                         mbx * 4:mbx * 4 + 4] = saved_nnz  # rewritten below
                n_i16 += 1
            ch = encode_chroma_mb(st, org_u, org_v, mby, mbx, qpc)
            st.rec_u[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = ch["recs"][0]
            st.rec_v[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = ch["recs"][1]
            write_intra_mb(w, st, mby, mbx, i16 if use_i16 else i4, ch,
                           use_i16)
            st.mb_decoded[mby, mbx] = True
            del saved_rec, saved_modes
        w.u(1, 1)      # rbsp_stop_one_bit (rbsp_slice_trailing_bits)
        rbsps.append(w.to_bytes())
    stats = dict(bits=sum(len(r) for r in rbsps) * 8, n_i16=n_i16,
                 n_mb=p.mb_h * p.mb_w)
    out = rbsps[0] if p.slice_groups == 1 else rbsps
    return out, (st.rec_y, st.rec_u, st.rec_v), stats


# ===========================================================================
# P slices (conformant inter path; spec 7.3.5 / 8.4)
# ===========================================================================

from ..ops.transform import COEFF_COST as _COEFF_COST          # noqa: E402
from .tables import CBP_TO_CODENUM_INTER                        # noqa: E402
from .params import SLICE_P, SLICE_B                            # noqa: E402
from . import inter as INTER                                    # noqa: E402
from .slice_dec import spatial_direct_16x16                     # noqa: E402


def lambda_me(qp: int) -> float:
    """Motion-search multiplier: sqrt(lambda_mode) (JM get_lambdas)."""
    return lambda_mode(qp) ** 0.5


def _coeff_cost_zz(zz: np.ndarray) -> int:
    """JM run-based single-coefficient cost of one 4x4 block (zig-zag)."""
    cost, run = 0, 0
    for v in zz:
        if v == 0:
            run += 1
        else:
            cost += 999999 if abs(v) > 1 else int(_COEFF_COST[min(run, 15)])
            run = 0
    return cost


def code_inter_luma_mb(org16: np.ndarray, pred16: np.ndarray, qp: int):
    """Inter luma residual: 4x4 T/Q + JM coefficient-cost thresholding
    (drop an 8x8 when cost<=4, the MB when total<=5;
    FR/src/macroblock.c:995-1166 semantics).  Returns (zz [16,16] in coding
    order, recon 16x16, cbp_luma_bits)."""
    res = org16 - pred16
    blocks = res.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3)
    w = Q.fdct4x4(blocks)
    lev = Q.quant4x4(w, qp, intra=False)
    zz = Q.zigzag(lev)                     # [y4][x4][16]

    cost8 = np.zeros(4, np.int64)
    for b8 in range(4):
        for k in range(4):
            y4 = (b8 >> 1) * 2 + (k >> 1)
            x4 = (b8 & 1) * 2 + (k & 1)
            cost8[b8] += _coeff_cost_zz(zz[y4, x4])
    drop8 = cost8 <= 4
    if int(np.where(drop8, 0, cost8).sum()) <= 5:
        drop8[:] = True
    for b8 in range(4):
        if drop8[b8]:
            y4g, x4g = (b8 >> 1) * 2, (b8 & 1) * 2
            zz[y4g:y4g + 2, x4g:x4g + 2] = 0
            lev[y4g:y4g + 2, x4g:x4g + 2] = 0

    deq = Q.dequant4x4(lev, qp)
    rec_b = Q.reconstruct(pred16.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3),
                          Q.idct4x4(deq))
    rec = rec_b.transpose(0, 2, 1, 3).reshape(16, 16)
    cbp_bits = 0
    for b8 in range(4):
        if not drop8[b8]:
            y4g, x4g = (b8 >> 1) * 2, (b8 & 1) * 2
            if (zz[y4g:y4g + 2, x4g:x4g + 2] != 0).any():
                cbp_bits |= 1 << b8
    # reorder to coding order [k, 16]
    zz_coding = np.zeros((16, 16), np.int64)
    for k in range(16):
        y4, x4 = int(BLOCK_SCAN[k][0]), int(BLOCK_SCAN[k][1])
        zz_coding[k] = zz[y4, x4]
    return zz_coding, rec, cbp_bits


def code_inter_chroma_mb(org_u8, org_v8, pred_u8, pred_v8, qpc: int):
    """Inter chroma residual (DC 2x2 Hadamard path).  Returns
    (dc_levels [2,4], ac_zzs [2,2,2,15], recons, cbp_chroma)."""
    dc_levels = np.zeros((2, 4), np.int64)
    ac_zzs = np.zeros((2, 2, 2, 15), np.int64)
    deqs = []
    any_dc = any_ac = False
    for ci, (org, pred) in enumerate(((org_u8, pred_u8), (org_v8, pred_v8))):
        res = org.astype(np.int64) - pred
        blocks = res.reshape(2, 4, 2, 4).transpose(0, 2, 1, 3)
        w = Q.fdct4x4(blocks)
        had = Q.hadamard2x2_fwd(w[:, :, 0, 0])
        dc_lev = Q.quant_dc_chroma(had, qpc, intra=False)
        ac_lev = Q.quant4x4(w, qpc, intra=False)
        ac_lev[:, :, 0, 0] = 0
        ac_zz = Q.zigzag(ac_lev)[:, :, 1:]
        # JM chroma AC coefficient-cost threshold (_CHROMA_COEFF_COST_ = 4)
        c_cost = sum(_coeff_cost_zz(ac_zz[j, i])
                     for j in range(2) for i in range(2))
        if c_cost < 4:
            ac_zz[:] = 0
            ac_lev[:] = 0
        any_dc |= bool((dc_lev != 0).any())
        any_ac |= bool((ac_zz != 0).any())
        dc_levels[ci] = dc_lev
        ac_zzs[ci] = ac_zz
        deqs.append((pred, ac_lev, Q.dequant_dc_chroma(dc_lev, qpc)))
    cbp_chroma = 2 if any_ac else (1 if any_dc else 0)
    recs = []
    for pred, ac_lev, dc_deq in deqs:
        deq = Q.dequant4x4(ac_lev, qpc) if cbp_chroma == 2 else \
            np.zeros_like(ac_lev)
        deq[:, :, 0, 0] = dc_deq if cbp_chroma >= 1 else 0
        rec_b = Q.reconstruct(
            np.asarray(pred).reshape(2, 4, 2, 4).transpose(0, 2, 1, 3),
            Q.idct4x4(deq))
        recs.append(rec_b.transpose(0, 2, 1, 3).reshape(8, 8))
    if cbp_chroma < 2:
        ac_zzs[:] = 0
    if cbp_chroma < 1:
        dc_levels[:] = 0
    return dc_levels, ac_zzs, recs, cbp_chroma


def _write_inter_residual(w: BitWriter, st: FrameState, mby, mbx, zz_coding,
                          cbp_luma_bits, dc_levels, ac_zzs, cbp_chroma):
    for k in range(16):
        y4, x4 = int(BLOCK_SCAN[k][0]), int(BLOCK_SCAN[k][1])
        by, bx = mby * 4 + y4, mbx * 4 + x4
        b8 = (y4 // 2) * 2 + (x4 // 2)
        if cbp_luma_bits & (1 << b8):
            nc = _nc_luma(st, by, bx)
            st.nnz_y[by, bx] = CV.write_block(w, zz_coding[k], nc, 16)
        else:
            st.nnz_y[by, bx] = 0
    if cbp_chroma > 0:
        for ci in range(2):
            CV.write_block(w, dc_levels[ci], -1, 4)
    for ci in range(2):
        for by4 in range(2):
            for bx4 in range(2):
                cby, cbx = mby * 2 + by4, mbx * 2 + bx4
                if cbp_chroma == 2:
                    nc = _nc_chroma(st, ci, cby, cbx)
                    st.nnz_c[ci, cby, cbx] = CV.write_block(
                        w, ac_zzs[ci, by4, bx4], nc, 15)
                else:
                    st.nnz_c[ci, cby, cbx] = 0


def _te_bits(v: int, num_ref: int) -> int:
    """Bit cost of ref_idx_l0 as te(v)."""
    if num_ref <= 1:
        return 0
    if num_ref == 2:
        return 1
    k = 0
    while (v + 1) >> (k + 1):
        k += 1
    return 2 * k + 1


def encode_p_frame(org_yuv, ref, p: AVCParams,
                   qp: int = None, frame_num: int = 1, sr: int = 16,
                   try_intra: bool = True, force_intra_mask=None,
                   use_satd: bool = False, poc_lsb: int = 0, wp=None,
                   mmco=None, redundant_pic_cnt: int = 0,
                   me_method: str = "full"):
    """Encode one frame as a single P slice.

    ``ref``: one RefPlanes or a list of them (reference list 0, most recent
    first — multi-ref per JM NumberReferenceFrames).  Modes per MB: P_Skip,
    P_16x16, P_16x8, P_8x16, P_8x8 (8x8 sub-partitions), intra 4x4 / 16x16
    (``try_intra``); RD pick by SAD/SSD + lambda*bits, optional SATD subpel
    metric (JM Hadamard).  ``force_intra_mask`` [mb_h, mb_w] bool forces
    intra coding per MB (errdo / intra-refresh hook, ref
    FR/src/intrarefresh.c + errdo force-intra semantics).
    Returns (rbsp, recon_before_deblock, deblock ctx, stats).
    """
    refs = ref if isinstance(ref, (list, tuple)) else [ref]
    num_ref = len(refs)
    qp = p.qp if qp is None else qp
    qpc = Q.chroma_qp(qp, p.chroma_qp_offset)
    lam = lambda_mode(qp)
    lam_me = lambda_me(qp)
    # integer-ME strategy dispatch (mv_search.c:145-168 IntPelME shape)
    search_block = {"full": INTER.full_search_block,
                    "umhex": INTER.umhex_search_block}[me_method]
    org_y, org_u, org_v = (np.asarray(x, np.int64) for x in org_yuv)
    st = FrameState(p)
    mvf = INTER.MVField(p.mb_h, p.mb_w)

    w = BitWriter()
    write_slice_header(w, p, SLICE_P, frame_num, False, qp,
                       num_ref_idx_l0=num_ref, poc_lsb=poc_lsb, wp=wp,
                       mmco=mmco, redundant_pic_cnt=redundant_pic_cnt)
    skip_run = 0
    n_skip = n_intra = 0

    for mby in range(p.mb_h):
        for mbx in range(p.mb_w):
            y0, x0 = mby * 16, mbx * 16
            by, bx = mby * 4, mbx * 4
            org16 = org_y[y0:y0 + 16, x0:x0 + 16]
            forced = bool(force_intra_mask is not None and
                          force_intra_mask[mby, mbx])
            # raster single-slice decode order (availability bookkeeping);
            # safe to set early: same-MB queries short-circuit in _blk_avail
            st.mb_decoded[mby, mbx] = True

            cands = []
            if not forced:
                for ri in range(num_ref):
                    rp = refs[ri]
                    rbits = _te_bits(ri, num_ref)
                    # ---- P_16x16 ----
                    pmv = mvf.predict(by, bx, 4, 4, ri)
                    mv16, _ = search_block(
                        org_y, rp, y0, x0, 16, 16, sr, pmv, lam_me,
                        use_satd=use_satd)
                    pred16 = rp.luma_block(y0, x0, 16, 16, int(mv16[0]),
                                           int(mv16[1]))
                    sad16 = int(np.abs(org16 - pred16).sum())
                    bits16 = 1 + rbits + INTER.mvd_bits(
                        int(mv16[0] - pmv[0]), int(mv16[1] - pmv[1]))
                    cands.append(("16x16", sad16 + lam * bits16,
                                  dict(mvs=[mv16], pmvs=[pmv], pred=pred16,
                                       ris=[ri])))

                    # ---- P_16x8 / P_8x16 / P_8x8 ----
                    for mode, parts in (
                        ("16x8", [((by, bx, 4, 2), "16x8_top"),
                                  ((by + 2, bx, 4, 2), "16x8_bot")]),
                        ("8x16", [((by, bx, 2, 4), "8x16_left"),
                                  ((by, bx + 2, 2, 4), "8x16_right")]),
                        ("8x8", [((by, bx, 2, 2), "none"),
                                 ((by, bx + 2, 2, 2), "none"),
                                 ((by + 2, bx, 2, 2), "none"),
                                 ((by + 2, bx + 2, 2, 2), "none")]),
                    ):
                        scratch = (mvf.mv.copy(), mvf.ref.copy(),
                                   mvf.decoded.copy())
                        mvs, pmvs = [], []
                        pred = np.zeros((16, 16), np.int64)
                        sad = 0
                        # mb_type ue + (P8x8: 4x sub_mb_type ue(0))
                        bits = {"16x8": 3, "8x16": 3, "8x8": 5 + 4}[mode]
                        bits += len(parts) * rbits
                        for (pby, pbx, w4, h4), tag in parts:
                            pm = mvf.predict(pby, pbx, w4, h4, ri, tag)
                            py, px = pby * 4, pbx * 4
                            mv, _ = search_block(
                                org_y, rp, py, px, h4 * 4, w4 * 4, sr, pm,
                                lam_me, use_satd=use_satd)
                            blk = rp.luma_block(py, px, h4 * 4, w4 * 4,
                                                int(mv[0]), int(mv[1]))
                            pred[py - y0:py - y0 + h4 * 4,
                                 px - x0:px - x0 + w4 * 4] = blk
                            sad += int(np.abs(
                                org_y[py:py + h4 * 4,
                                      px:px + w4 * 4] - blk).sum())
                            bits += INTER.mvd_bits(int(mv[0] - pm[0]),
                                                   int(mv[1] - pm[1]))
                            mvf.set_partition(pby, pbx, w4, h4, mv, ri)
                            mvs.append(mv)
                            pmvs.append(pm)
                        mvf.mv, mvf.ref, mvf.decoded = scratch
                        cands.append((mode, sad + lam * bits,
                                      dict(mvs=mvs, pmvs=pmvs, pred=pred,
                                           ris=[ri] * len(parts))))

            # ---- intra candidates ----
            i4 = i16 = None
            if try_intra or forced:
                i16 = encode_i16_mb(st, org_y, mby, mbx, qp, lam)
                saved_rec = st.rec_y[y0:y0 + 16, x0:x0 + 16].copy()
                saved_modes = st.i4_modes[by:by + 4, bx:bx + 4].copy()
                saved_nnz = st.nnz_y[by:by + 4, bx:bx + 4].copy()
                i4 = encode_i4x4_mb(st, org_y, mby, mbx, qp, lam)
                # undo I4 state; re-applied if I4 wins
                i4_rec = st.rec_y[y0:y0 + 16, x0:x0 + 16].copy()
                i4_modes_mb = st.i4_modes[by:by + 4, bx:bx + 4].copy()
                st.rec_y[y0:y0 + 16, x0:x0 + 16] = saved_rec
                st.i4_modes[by:by + 4, bx:bx + 4] = saved_modes
                st.nnz_y[by:by + 4, bx:bx + 4] = saved_nnz
                # intra mb_type in P pays ~ue(5+) bits
                cands.append(("i16", i16["cost"] + lam * 11, dict()))
                cands.append(("i4", i4["cost"] + lam * 9, dict()))
            if forced:
                cands = [c for c in cands if c[0] in ("i16", "i4")]

            cands.sort(key=lambda c: c[1])
            mode, _, info = cands[0]

            if mode in ("i16", "i4"):
                n_intra += 1
                use_i16 = mode == "i16"
                if use_i16:
                    st.rec_y[y0:y0 + 16, x0:x0 + 16] = i16["rec"]
                    st.i4_modes[by:by + 4, bx:bx + 4] = -1
                else:
                    st.rec_y[y0:y0 + 16, x0:x0 + 16] = i4_rec
                    st.i4_modes[by:by + 4, bx:bx + 4] = i4_modes_mb
                ch = encode_chroma_mb(st, org_u, org_v, mby, mbx, qpc)
                st.rec_u[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = ch["recs"][0]
                st.rec_v[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = ch["recs"][1]
                w.ue(skip_run)
                skip_run = 0
                # intra mb_type in P slices = 5 + I-slice mb_type
                if use_i16:
                    w.ue(5 + mb_type_i16(i16["i16mode"], ch["cbp_chroma"],
                                         i16["cbp_luma"]))
                    w.ue(ch["mode"])
                    w.se(0)      # mb_qp_delta (I16 always)
                    # residual
                    nc = _nc_luma(st, by, bx)
                    CV.write_block(w, i16["dc_zz"], nc, 16)
                    for k in range(16):
                        y4, x4 = int(BLOCK_SCAN[k][0]), int(BLOCK_SCAN[k][1])
                        bby, bbx = by + y4, bx + x4
                        if i16["cbp_luma"]:
                            nc = _nc_luma(st, bby, bbx)
                            st.nnz_y[bby, bbx] = CV.write_block(
                                w, i16["ac_zzs"][y4, x4], nc, 15)
                        else:
                            st.nnz_y[bby, bbx] = 0
                    if ch["cbp_chroma"] > 0:
                        for ci in range(2):
                            CV.write_block(w, ch["dc_levels"][ci], -1, 4)
                    for ci in range(2):
                        for by4 in range(2):
                            for bx4 in range(2):
                                cby, cbx = mby * 2 + by4, mbx * 2 + bx4
                                if ch["cbp_chroma"] == 2:
                                    nc = _nc_chroma(st, ci, cby, cbx)
                                    st.nnz_c[ci, cby, cbx] = CV.write_block(
                                        w, ch["ac_zzs"][ci, by4, bx4], nc, 15)
                                else:
                                    st.nnz_c[ci, cby, cbx] = 0
                else:
                    w.ue(5 + MB_I4x4)
                    for flag, rem in i4["flags"]:
                        w.u(flag, 1)
                        if not flag:
                            w.u(rem, 3)
                    w.ue(ch["mode"])
                    cbp_luma_bits = 0
                    for b8 in range(4):
                        if (i4["zzs"][4 * b8:4 * b8 + 4] != 0).any():
                            cbp_luma_bits |= 1 << b8
                    cbp = cbp_luma_bits | (ch["cbp_chroma"] << 4)
                    w.ue(int(CBP_TO_CODENUM_INTRA[cbp]))
                    if cbp > 0:
                        w.se(0)
                    for k in range(16):
                        y4, x4 = int(BLOCK_SCAN[k][0]), int(BLOCK_SCAN[k][1])
                        bby, bbx = by + y4, bx + x4
                        b8 = (y4 // 2) * 2 + (x4 // 2)
                        if cbp_luma_bits & (1 << b8):
                            nc = _nc_luma(st, bby, bbx)
                            st.nnz_y[bby, bbx] = CV.write_block(
                                w, i4["zzs"][k], nc, 16)
                        else:
                            st.nnz_y[bby, bbx] = 0
                    if ch["cbp_chroma"] > 0:
                        for ci in range(2):
                            CV.write_block(w, ch["dc_levels"][ci], -1, 4)
                    for ci in range(2):
                        for by4 in range(2):
                            for bx4 in range(2):
                                cby, cbx = mby * 2 + by4, mbx * 2 + bx4
                                if ch["cbp_chroma"] == 2:
                                    nc = _nc_chroma(st, ci, cby, cbx)
                                    st.nnz_c[ci, cby, cbx] = CV.write_block(
                                        w, ch["ac_zzs"][ci, by4, bx4], nc, 15)
                                else:
                                    st.nnz_c[ci, cby, cbx] = 0
                mvf.set_partition(by, bx, 4, 4, np.zeros(2, np.int64), -1)
                st.mb_intra[mby, mbx] = True
                continue

            # ---- inter coding path ----
            st.mb_intra[mby, mbx] = False
            pred16 = info["pred"]
            zz_coding, rec16, cbp_luma_bits = code_inter_luma_mb(
                org16, pred16, qp)
            mv0 = info["mvs"][0]
            ris = info["ris"]
            part_geo = {            # chroma-plane (dy, dx, w, h) per partition
                "16x16": [(0, 0, 8, 8)],
                "16x8": [(0, 0, 8, 4), (4, 0, 8, 4)],
                "8x16": [(0, 0, 4, 8), (0, 4, 4, 8)],
                "8x8": [(0, 0, 4, 4), (0, 4, 4, 4),
                        (4, 0, 4, 4), (4, 4, 4, 4)],
            }[mode]
            pred_u = np.zeros((8, 8), np.int64)
            pred_v = np.zeros((8, 8), np.int64)
            for (dy, dx, pw, ph), mv, ri in zip(part_geo, info["mvs"], ris):
                rp = refs[ri]
                pred_u[dy:dy + ph, dx:dx + pw] = rp.chroma_block(
                    "u", mby * 8 + dy, mbx * 8 + dx, ph, pw,
                    int(mv[0]), int(mv[1]))
                pred_v[dy:dy + ph, dx:dx + pw] = rp.chroma_block(
                    "v", mby * 8 + dy, mbx * 8 + dx, ph, pw,
                    int(mv[0]), int(mv[1]))
            dc_levels, ac_zzs, ch_recs, cbp_chroma = code_inter_chroma_mb(
                org_u[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8],
                org_v[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8],
                pred_u, pred_v, qpc)
            cbp = cbp_luma_bits | (cbp_chroma << 4)

            # ---- P_Skip check ----
            skip_mv = mvf.skip_mv(by, bx)
            if (mode == "16x16" and cbp == 0 and ris[0] == 0 and
                    int(info["mvs"][0][0]) == int(skip_mv[0]) and
                    int(info["mvs"][0][1]) == int(skip_mv[1])):
                skip_run += 1
                n_skip += 1
                st.rec_y[y0:y0 + 16, x0:x0 + 16] = pred16
                st.rec_u[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = pred_u
                st.rec_v[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = pred_v
                st.nnz_y[by:by + 4, bx:bx + 4] = 0
                st.nnz_c[:, mby * 2:mby * 2 + 2, mbx * 2:mbx * 2 + 2] = 0
                st.i4_modes[by:by + 4, bx:bx + 4] = -1
                mvf.set_partition(by, bx, 4, 4, info["mvs"][0], 0)
                continue

            st.rec_y[y0:y0 + 16, x0:x0 + 16] = rec16
            st.rec_u[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = ch_recs[0]
            st.rec_v[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = ch_recs[1]
            st.i4_modes[by:by + 4, bx:bx + 4] = -1

            w.ue(skip_run)
            skip_run = 0
            mb_type = {"16x16": 0, "16x8": 1, "8x16": 2, "8x8": 3}[mode]
            w.ue(mb_type)
            if mode == "8x8":
                for _ in range(4):
                    w.ue(0)          # sub_mb_type = P_L0_8x8
            if num_ref > 1:          # ref_idx_l0 per partition, te(v)
                for ri in ris:
                    if num_ref == 2:
                        w.u(1 - ri, 1)
                    else:
                        w.ue(ri)
            for mv, pm in zip(info["mvs"], info["pmvs"]):
                w.se(int(mv[0] - pm[0]))
                w.se(int(mv[1] - pm[1]))
            w.ue(int(CBP_TO_CODENUM_INTER[cbp]))
            if cbp > 0:
                w.se(0)
                _write_inter_residual(w, st, mby, mbx, zz_coding,
                                      cbp_luma_bits, dc_levels, ac_zzs,
                                      cbp_chroma)
            else:
                st.nnz_y[by:by + 4, bx:bx + 4] = 0
                st.nnz_c[:, mby * 2:mby * 2 + 2, mbx * 2:mbx * 2 + 2] = 0

            # commit MV field (block-coord geometry per mode)
            geo4 = {
                "16x16": [(0, 0, 4, 4)],
                "16x8": [(0, 0, 4, 2), (2, 0, 4, 2)],
                "8x16": [(0, 0, 2, 4), (0, 2, 2, 4)],
                "8x8": [(0, 0, 2, 2), (0, 2, 2, 2),
                        (2, 0, 2, 2), (2, 2, 2, 2)],
            }[mode]
            for (dy4, dx4, w4, h4), mv, ri in zip(geo4, info["mvs"], ris):
                mvf.set_partition(by + dy4, bx + dx4, w4, h4, mv, ri)

    if skip_run > 0:
        w.ue(skip_run)
    w.u(1, 1)
    rbsp = w.to_bytes()
    stats = dict(bits=len(rbsp) * 8, n_skip=n_skip, n_intra=n_intra,
                 n_mb=p.mb_h * p.mb_w)
    ctx = dict(mvf=mvf, nnz=st.nnz_y.copy(), mb_intra=st.mb_intra.copy())
    return rbsp, (st.rec_y, st.rec_u, st.rec_v), ctx, stats


# ===========================================================================
# B slices (spec 7.4.3 / 8.4.1.2; JM twins pred_struct.c + mc_direct.c)
# ===========================================================================

def _mc_16x16_cells(rp, y0, x0, mv_cells):
    """Luma+chroma MC of a 16x16 MB with per-4x4-cell MVs."""
    pred = np.zeros((16, 16), np.int64)
    pu = np.zeros((8, 8), np.int64)
    pv = np.zeros((8, 8), np.int64)
    for cy in range(4):
        for cx4 in range(4):
            mv = mv_cells[cy, cx4]
            pred[cy * 4:cy * 4 + 4, cx4 * 4:cx4 * 4 + 4] = rp.luma_block(
                y0 + cy * 4, x0 + cx4 * 4, 4, 4, int(mv[0]), int(mv[1]))
    # chroma: per 4x4 luma cell -> 2x2 chroma block
    for cy in range(4):
        for cx4 in range(4):
            mv = mv_cells[cy, cx4]
            pu[cy * 2:cy * 2 + 2, cx4 * 2:cx4 * 2 + 2] = rp.chroma_block(
                "u", y0 // 2 + cy * 2, x0 // 2 + cx4 * 2, 2, 2,
                int(mv[0]), int(mv[1]))
            pv[cy * 2:cy * 2 + 2, cx4 * 2:cx4 * 2 + 2] = rp.chroma_block(
                "v", y0 // 2 + cy * 2, x0 // 2 + cx4 * 2, 2, 2,
                int(mv[0]), int(mv[1]))
    return pred, pu, pv


def encode_b_frame(org_yuv, refs0, refs1, col_motion, p: AVCParams,
                   qp: int = None, frame_num: int = 0, poc_lsb: int = 0,
                   sr: int = 16, use_satd: bool = False,
                   ref_pocs0=None, ref_pocs1=None):
    """Encode one frame as a single B slice (spatial direct).

    refs0/refs1: RefPlanes lists (list0 backward, list1 forward in the
    IbbP sense).  col_motion: (mv [h4,w4,2], ref [h4,w4]) of the first
    list-1 reference (colocated data for spatial direct).  Modes per MB:
    B_Skip/B_Direct_16x16, B_L0/L1/Bi_16x16, intra 4x4/16x16.
    Returns (rbsp, recon, deblock ctx, stats)."""
    qp = p.qp if qp is None else qp
    qpc = Q.chroma_qp(qp, p.chroma_qp_offset)
    lam = lambda_mode(qp)
    lam_me = lambda_me(qp)
    org_y, org_u, org_v = (np.asarray(x, np.int64) for x in org_yuv)
    st = FrameState(p)
    mvf0 = INTER.MVField(p.mb_h, p.mb_w)
    mvf1 = INTER.MVField(p.mb_h, p.mb_w)
    col_mv, col_ref = col_motion

    w = BitWriter()
    write_slice_header(w, p, SLICE_B, frame_num, False, qp,
                       num_ref_idx_l0=len(refs0), num_ref_idx_l1=len(refs1),
                       poc_lsb=poc_lsb, ref_pic=False)
    skip_run = 0
    n_skip = n_direct = n_intra = 0

    for mby in range(p.mb_h):
        for mbx in range(p.mb_w):
            y0, x0 = mby * 16, mbx * 16
            by, bx = mby * 4, mbx * 4
            org16 = org_y[y0:y0 + 16, x0:x0 + 16]
            org_u8 = org_u[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8]
            org_v8 = org_v[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8]
            st.mb_decoded[mby, mbx] = True

            # ---- direct candidate ----
            r0d, r1d, mv0c, mv1c, used0, used1 = spatial_direct_16x16(
                mvf0, mvf1, by, bx, col_mv, col_ref)
            preds = []
            if used0:
                preds.append(_mc_16x16_cells(refs0[r0d], y0, x0, mv0c))
            if used1:
                preds.append(_mc_16x16_cells(refs1[r1d], y0, x0, mv1c))
            if len(preds) == 2:
                dp_ = tuple((a + b + 1) >> 1 for a, b in zip(*preds))
            else:
                dp_ = preds[0]
            sad_dir = int(np.abs(org16 - dp_[0]).sum())
            cands = [("direct", sad_dir + lam * 1.0,
                      dict(pred=dp_, mvs=None))]

            # ---- L0 / L1 / Bi 16x16 ----
            sides = {}
            for lname, refs, mvf in (("l0", refs0, mvf0), ("l1", refs1, mvf1)):
                pmv = mvf.predict(by, bx, 4, 4, 0)
                mv, _ = INTER.full_search_block(
                    org_y, refs[0], y0, x0, 16, 16, sr, pmv, lam_me,
                    use_satd=use_satd)
                pl = refs[0].luma_block(y0, x0, 16, 16, int(mv[0]), int(mv[1]))
                pu = refs[0].chroma_block("u", mby * 8, mbx * 8, 8, 8,
                                          int(mv[0]), int(mv[1]))
                pv = refs[0].chroma_block("v", mby * 8, mbx * 8, 8, 8,
                                          int(mv[0]), int(mv[1]))
                bits = 3 + INTER.mvd_bits(int(mv[0] - pmv[0]),
                                          int(mv[1] - pmv[1]))
                sad = int(np.abs(org16 - pl).sum())
                sides[lname] = dict(mv=mv, pmv=pmv, pred=(pl, pu, pv))
                cands.append((lname, sad + lam * bits, sides[lname]))
            bi_pred = tuple((a + b + 1) >> 1 for a, b in
                            zip(sides["l0"]["pred"], sides["l1"]["pred"]))
            bi_bits = 5 + INTER.mvd_bits(*(sides["l0"]["mv"]
                                           - sides["l0"]["pmv"])) \
                + INTER.mvd_bits(*(sides["l1"]["mv"] - sides["l1"]["pmv"]))
            cands.append(("bi", int(np.abs(org16 - bi_pred[0]).sum())
                          + lam * bi_bits, dict(pred=bi_pred)))

            # ---- intra ----
            i16 = encode_i16_mb(st, org_y, mby, mbx, qp, lam)
            saved_rec = st.rec_y[y0:y0 + 16, x0:x0 + 16].copy()
            saved_modes = st.i4_modes[by:by + 4, bx:bx + 4].copy()
            saved_nnz = st.nnz_y[by:by + 4, bx:bx + 4].copy()
            i4 = encode_i4x4_mb(st, org_y, mby, mbx, qp, lam)
            i4_rec = st.rec_y[y0:y0 + 16, x0:x0 + 16].copy()
            i4_modes_mb = st.i4_modes[by:by + 4, bx:bx + 4].copy()
            st.rec_y[y0:y0 + 16, x0:x0 + 16] = saved_rec
            st.i4_modes[by:by + 4, bx:bx + 4] = saved_modes
            st.nnz_y[by:by + 4, bx:bx + 4] = saved_nnz
            cands.append(("i16", i16["cost"] + lam * 13, dict()))
            cands.append(("i4", i4["cost"] + lam * 11, dict()))

            cands.sort(key=lambda c: c[1])
            mode, _, info = cands[0]

            if mode in ("i16", "i4"):
                n_intra += 1
                use_i16 = mode == "i16"
                if use_i16:
                    st.rec_y[y0:y0 + 16, x0:x0 + 16] = i16["rec"]
                    st.i4_modes[by:by + 4, bx:bx + 4] = -1
                else:
                    st.rec_y[y0:y0 + 16, x0:x0 + 16] = i4_rec
                    st.i4_modes[by:by + 4, bx:bx + 4] = i4_modes_mb
                ch = encode_chroma_mb(st, org_u, org_v, mby, mbx, qpc)
                st.rec_u[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = \
                    ch["recs"][0]
                st.rec_v[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = \
                    ch["recs"][1]
                w.ue(skip_run)
                skip_run = 0
                # intra mb_type in B = 23 + I code (Table 7-14)
                if use_i16:
                    w.ue(23 + mb_type_i16(i16["i16mode"], ch["cbp_chroma"],
                                          i16["cbp_luma"]))
                    w.ue(ch["mode"])
                    w.se(0)
                    nc = _nc_luma(st, by, bx)
                    CV.write_block(w, i16["dc_zz"], nc, 16)
                    for k in range(16):
                        y4, x4 = int(BLOCK_SCAN[k][0]), int(BLOCK_SCAN[k][1])
                        bby, bbx = by + y4, bx + x4
                        if i16["cbp_luma"]:
                            nc = _nc_luma(st, bby, bbx)
                            st.nnz_y[bby, bbx] = CV.write_block(
                                w, i16["ac_zzs"][y4, x4], nc, 15)
                        else:
                            st.nnz_y[bby, bbx] = 0
                    if ch["cbp_chroma"] > 0:
                        for ci in range(2):
                            CV.write_block(w, ch["dc_levels"][ci], -1, 4)
                    for ci in range(2):
                        for by4 in range(2):
                            for bx4 in range(2):
                                cby, cbx = mby * 2 + by4, mbx * 2 + bx4
                                if ch["cbp_chroma"] == 2:
                                    nc = _nc_chroma(st, ci, cby, cbx)
                                    st.nnz_c[ci, cby, cbx] = CV.write_block(
                                        w, ch["ac_zzs"][ci, by4, bx4], nc, 15)
                                else:
                                    st.nnz_c[ci, cby, cbx] = 0
                else:
                    w.ue(23 + MB_I4x4)
                    for flag, rem in i4["flags"]:
                        w.u(flag, 1)
                        if not flag:
                            w.u(rem, 3)
                    w.ue(ch["mode"])
                    cbp_luma_bits = 0
                    for b8 in range(4):
                        if (i4["zzs"][4 * b8:4 * b8 + 4] != 0).any():
                            cbp_luma_bits |= 1 << b8
                    cbp = cbp_luma_bits | (ch["cbp_chroma"] << 4)
                    w.ue(int(CBP_TO_CODENUM_INTRA[cbp]))
                    if cbp > 0:
                        w.se(0)
                    for k in range(16):
                        y4, x4 = int(BLOCK_SCAN[k][0]), int(BLOCK_SCAN[k][1])
                        bby, bbx = by + y4, bx + x4
                        b8 = (y4 // 2) * 2 + (x4 // 2)
                        if cbp_luma_bits & (1 << b8):
                            nc = _nc_luma(st, bby, bbx)
                            st.nnz_y[bby, bbx] = CV.write_block(
                                w, i4["zzs"][k], nc, 16)
                        else:
                            st.nnz_y[bby, bbx] = 0
                    if ch["cbp_chroma"] > 0:
                        for ci in range(2):
                            CV.write_block(w, ch["dc_levels"][ci], -1, 4)
                    for ci in range(2):
                        for by4 in range(2):
                            for bx4 in range(2):
                                cby, cbx = mby * 2 + by4, mbx * 2 + bx4
                                if ch["cbp_chroma"] == 2:
                                    nc = _nc_chroma(st, ci, cby, cbx)
                                    st.nnz_c[ci, cby, cbx] = CV.write_block(
                                        w, ch["ac_zzs"][ci, by4, bx4], nc, 15)
                                else:
                                    st.nnz_c[ci, cby, cbx] = 0
                mvf0.set_partition(by, bx, 4, 4, np.zeros(2, np.int64), -1)
                mvf1.set_partition(by, bx, 4, 4, np.zeros(2, np.int64), -1)
                st.mb_intra[mby, mbx] = True
                continue

            # ---- inter B path ----
            st.mb_intra[mby, mbx] = False
            if mode == "direct":
                pred16, pred_u8, pred_v8 = info["pred"]
            elif mode == "bi":
                pred16, pred_u8, pred_v8 = info["pred"]
            else:
                pred16, pred_u8, pred_v8 = info["pred"]

            zz_coding, rec16, cbp_luma_bits = code_inter_luma_mb(
                org16, pred16, qp)
            dc_levels, ac_zzs, ch_recs, cbp_chroma = code_inter_chroma_mb(
                org_u8, org_v8, pred_u8, pred_v8, qpc)
            cbp = cbp_luma_bits | (cbp_chroma << 4)

            # commit MV fields
            if mode == "direct":
                if used0:
                    for cy in range(4):
                        for cx4 in range(4):
                            mvf0.set_partition(by + cy, bx + cx4, 1, 1,
                                               mv0c[cy, cx4], r0d)
                else:
                    mvf0.set_partition(by, bx, 4, 4,
                                       np.zeros(2, np.int64), -1)
                if used1:
                    for cy in range(4):
                        for cx4 in range(4):
                            mvf1.set_partition(by + cy, bx + cx4, 1, 1,
                                               mv1c[cy, cx4], r1d)
                else:
                    mvf1.set_partition(by, bx, 4, 4,
                                       np.zeros(2, np.int64), -1)
            elif mode == "l0":
                mvf0.set_partition(by, bx, 4, 4, info["mv"], 0)
                mvf1.set_partition(by, bx, 4, 4, np.zeros(2, np.int64), -1)
            elif mode == "l1":
                mvf0.set_partition(by, bx, 4, 4, np.zeros(2, np.int64), -1)
                mvf1.set_partition(by, bx, 4, 4, info["mv"], 0)
            else:
                mvf0.set_partition(by, bx, 4, 4, sides["l0"]["mv"], 0)
                mvf1.set_partition(by, bx, 4, 4, sides["l1"]["mv"], 0)

            # ---- B_Skip ----
            if mode == "direct" and cbp == 0:
                skip_run += 1
                n_skip += 1
                st.rec_y[y0:y0 + 16, x0:x0 + 16] = pred16
                st.rec_u[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = pred_u8
                st.rec_v[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = pred_v8
                st.nnz_y[by:by + 4, bx:bx + 4] = 0
                st.nnz_c[:, mby * 2:mby * 2 + 2, mbx * 2:mbx * 2 + 2] = 0
                st.i4_modes[by:by + 4, bx:bx + 4] = -1
                continue

            st.rec_y[y0:y0 + 16, x0:x0 + 16] = rec16
            st.rec_u[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = ch_recs[0]
            st.rec_v[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = ch_recs[1]
            st.i4_modes[by:by + 4, bx:bx + 4] = -1

            w.ue(skip_run)
            skip_run = 0
            mb_type = {"direct": 0, "l0": 1, "l1": 2, "bi": 3}[mode]
            w.ue(mb_type)
            if mode == "direct":
                n_direct += 1
            if mode in ("l0", "bi") and len(refs0) > 1:
                w.u(1, 1) if len(refs0) == 2 else w.ue(0)   # ref 0 te(v)
            if mode in ("l1", "bi") and len(refs1) > 1:
                w.u(1, 1) if len(refs1) == 2 else w.ue(0)
            if mode in ("l0", "bi"):
                w.se(int(sides["l0"]["mv"][0] - sides["l0"]["pmv"][0]))
                w.se(int(sides["l0"]["mv"][1] - sides["l0"]["pmv"][1]))
            if mode in ("l1", "bi"):
                w.se(int(sides["l1"]["mv"][0] - sides["l1"]["pmv"][0]))
                w.se(int(sides["l1"]["mv"][1] - sides["l1"]["pmv"][1]))
            w.ue(int(CBP_TO_CODENUM_INTER[cbp]))
            if cbp > 0:
                w.se(0)
                _write_inter_residual(w, st, mby, mbx, zz_coding,
                                      cbp_luma_bits, dc_levels, ac_zzs,
                                      cbp_chroma)
            else:
                st.nnz_y[by:by + 4, bx:bx + 4] = 0
                st.nnz_c[:, mby * 2:mby * 2 + 2, mbx * 2:mbx * 2 + 2] = 0

    if skip_run > 0:
        w.ue(skip_run)
    w.u(1, 1)
    rbsp = w.to_bytes()
    stats = dict(bits=len(rbsp) * 8, n_skip=n_skip, n_direct=n_direct,
                 n_intra=n_intra, n_mb=p.mb_h * p.mb_w)
    # deblock ctx: two-list motion with per-cell PICTURE ids (spec 8.7.2.1
    # compares reference pictures, not list indices)
    rp0 = ref_pocs0 if ref_pocs0 is not None else list(range(len(refs0)))
    rp1 = ref_pocs1 if ref_pocs1 is not None else \
        [100 + i for i in range(len(refs1))]

    def ids(mvf, pocs):
        out = np.full_like(mvf.ref, -1)
        for i, pid in enumerate(pocs):
            out[mvf.ref == i] = pid
        return out

    ctx = dict(mv=mvf0.mv.copy(), ref=ids(mvf0, rp0),
               mv1=mvf1.mv.copy(), ref1=ids(mvf1, rp1),
               nnz=st.nnz_y.copy(), mb_intra=st.mb_intra.copy())
    return rbsp, (st.rec_y, st.rec_u, st.rec_v), ctx, stats


def encode_i_frame_pcm(org_yuv, p: AVCParams, frame_num: int = 0,
                       idr: bool = True, idr_pic_id: int = 0,
                       poc_lsb: int = 0):
    """Lossless picture: every MB coded I_PCM (spec 7.3.5 mb_type 25 +
    pcm_alignment_zero_bit + raw 8-bit samples; 8.3.5).  JM's lossless
    surface is PCM / transform-bypass (``transform8x8.c:663`` _ls paths);
    PCM is the profile-independent member, exact at every QP.  The
    deblocking filter never fires (PCM MBs deblock with QPY 0 ->
    alpha/beta thresholds 0), so reconstruction == source bit-exactly.

    Returns (rbsp, (rec_y, rec_u, rec_v), stats) like encode_i_frame.
    """
    org_y = np.asarray(org_yuv[0], np.int64)
    org_u = np.asarray(org_yuv[1], np.int64)
    org_v = np.asarray(org_yuv[2], np.int64)
    w = BitWriter()
    write_slice_header(w, p, SLICE_I, frame_num, idr, p.qp,
                       idr_pic_id=idr_pic_id, poc_lsb=poc_lsb)
    for mby in range(p.mb_h):
        for mbx in range(p.mb_w):
            w.ue(25)                       # mb_type I_PCM
            pad = (-w.bit_length()) % 8
            if pad:
                w.u(0, pad)                # pcm_alignment_zero_bit(s)
            y0, x0 = mby * 16, mbx * 16
            cy0, cx0 = mby * 8, mbx * 8
            w.u(org_y[y0:y0 + 16, x0:x0 + 16].reshape(-1), 8)
            w.u(org_u[cy0:cy0 + 8, cx0:cx0 + 8].reshape(-1), 8)
            w.u(org_v[cy0:cy0 + 8, cx0:cx0 + 8].reshape(-1), 8)
    w.u(1, 1)                              # rbsp_stop_one_bit
    rbsp = w.to_bytes()
    stats = dict(bits=len(rbsp) * 8, n_i16=0, n_i4=0)
    return rbsp, (org_y.copy(), org_u.copy(), org_v.copy()), stats
