"""CABAC slice packing of the TPU encoder's symbol arrays (Main profile).

Same symbol arrays as the CAVLC packer (``avc/pack.py``), entropy-coded
per spec 9.3 via :mod:`h264tpu_torch.avc.cabac`: the slice header is written
with the BitWriter, cabac_alignment_one_bits pad to a byte boundary, and
the M-coder bytes follow.  Reference flow: ``JM/lencod/src/macroblock.c``
writeMBLayer with SymbolMode=CABAC.

The port's own copy of ``h264tpu/avc/pack_cabac.py``; it imports nothing
from ``h264tpu``.
"""

from __future__ import annotations

import numpy as np

from ..entropy.bitio import BitWriter
from .tables import BLOCK_SCAN, mb_type_i16
from .params import AVCParams, write_slice_header, SLICE_I, SLICE_P
from . import cabac as CB

_SCAN = np.asarray(BLOCK_SCAN)
_GEO4 = {1: ((0, 0, 4, 4),),
         2: ((0, 0, 2, 4), (2, 0, 2, 4)),
         3: ((0, 0, 4, 2), (0, 2, 4, 2)),
         4: ((0, 0, 2, 2), (0, 2, 2, 2), (2, 0, 2, 2), (2, 2, 2, 2))}


def _assemble(hw: BitWriter, payload: bytes) -> bytes:
    """header bits + cabac_alignment_one_bit padding + M-coder bytes."""
    pad = (-hw.bit_length()) % 8
    if pad:
        hw.u((1 << pad) - 1, pad)
    return hw.to_bytes() + payload


def _write_intra_mb(wtr: CB.CabacWriter, c, sym, i, mby, mbx, wc, in_p,
                    transform_8x8: bool = False):
    st = wtr.st
    cbp_luma = int(sym["cbp_luma"][i])
    cbp_chroma = int(sym["cbp_chroma"][i])
    cbp = cbp_luma | (cbp_chroma << 4)
    cmode = int(sym["cmode"][i])
    if wc == 6:
        code = mb_type_i16(int(sym["i16mode"][i]), cbp_chroma, cbp_luma != 0)
        if in_p:
            wtr.mb_type_p_slice(6, code)
        else:
            wtr.mb_type_i_slice(c, code)
        st.cat[mby, mbx] = CB.MBState.CAT_I16
    else:
        if in_p:
            wtr.mb_type_p_slice(5)
        else:
            wtr.mb_type_i_slice(c, None)
        if transform_8x8:
            wtr.transform_size_flag(c, False)   # we emit I4x4
        flags = np.asarray(sym["i4flags"][i])
        for k in range(16):
            wtr.intra_pred_mode(int(flags[k, 0]), int(flags[k, 1]))
        st.cat[mby, mbx] = CB.MBState.CAT_I4
    wtr.chroma_pred_mode(c, cmode)
    st.cipred[mby, mbx] = cmode
    if wc == 5:
        wtr.cbp(c, cbp)
    st.cbp[mby, mbx] = cbp

    if cbp > 0 or wc == 6:
        wtr.mb_qp_delta(c, 0)
    else:
        st.last_dqp = 0

    zz = np.asarray(sym["zz"][i])
    if wc == 6:
        wtr.residual_block(c, CB.LUMA_16DC, np.asarray(sym["i16dc"][i]))
        if cbp_luma:
            for k in range(16):
                y4, x4 = int(_SCAN[k][0]), int(_SCAN[k][1])
                wtr.residual_block(c, CB.LUMA_16AC, zz[k][:15],
                                   by=mby * 4 + y4, bx=mbx * 4 + x4)
    else:
        for k in range(16):
            y4, x4 = int(_SCAN[k][0]), int(_SCAN[k][1])
            b8 = (y4 // 2) * 2 + (x4 // 2)
            if cbp_luma & (1 << b8):
                wtr.residual_block(c, CB.LUMA_4x4, zz[k],
                                   by=mby * 4 + y4, bx=mbx * 4 + x4)
    _write_chroma_residual(wtr, c, sym, i, mby, mbx, cbp_chroma)


def _write_chroma_residual(wtr, c, sym, i, mby, mbx, cbp_chroma):
    if cbp_chroma > 0:
        cdc = np.asarray(sym["cdc"][i])
        for ci in range(2):
            wtr.residual_block(c, CB.CHROMA_DC, cdc[ci], comp=ci)
    if cbp_chroma == 2:
        cac = np.asarray(sym["cac"][i])
        for ci in range(2):
            for by4 in range(2):
                for bx4 in range(2):
                    wtr.residual_block(c, CB.CHROMA_AC, cac[ci, by4, bx4],
                                       by=mby * 2 + by4, bx=mbx * 2 + bx4,
                                       comp=ci)


def pack_i_slice_cabac(sym, p: AVCParams, qp: int, frame_num: int = 0,
                       idr: bool = True, idr_pic_id: int = 0,
                       row0: int = 0, n_rows: int = None) -> bytes:
    mb_h, mb_w = p.mb_h, p.mb_w
    n_rows = mb_h - row0 if n_rows is None else n_rows
    hw = BitWriter()
    write_slice_header(hw, p, SLICE_I, frame_num, idr, qp,
                       idr_pic_id=idr_pic_id, first_mb=row0 * mb_w)
    st = CB.MBState(mb_w, mb_h)
    st.first_mb = row0 * mb_w
    wtr = CB.CabacWriter(SLICE_I, qp, st)
    win = np.asarray(sym["win"])
    last = (row0 + n_rows) * mb_w - 1
    payload = None
    for i in range(row0 * mb_w, (row0 + n_rows) * mb_w):
        mby, mbx = i // mb_w, i % mb_w
        c = CB._Common(st, mby, mbx, intra=True)
        _write_intra_mb(wtr, c, sym, i, mby, mbx, int(win[i]), in_p=False,
                        transform_8x8=p.transform_8x8)
        payload = wtr.end_of_slice(i == last)
    return _assemble(hw, payload)


def pack_p_slice_cabac(sym, p: AVCParams, qp: int, frame_num: int,
                       num_ref: int, row0: int = 0,
                       n_rows: int = None, poc_lsb: int = 0,
                       mmco=None, reorder_l0=None) -> bytes:
    mb_h, mb_w = p.mb_h, p.mb_w
    n_rows = mb_h - row0 if n_rows is None else n_rows
    hw = BitWriter()
    write_slice_header(hw, p, SLICE_P, frame_num, False, qp,
                       num_ref_idx_l0=num_ref, first_mb=row0 * mb_w,
                       poc_lsb=poc_lsb, mmco=mmco, reorder_l0=reorder_l0)
    st = CB.MBState(mb_w, mb_h)
    st.first_mb = row0 * mb_w
    wtr = CB.CabacWriter(SLICE_P, qp, st)
    win = np.asarray(sym["win"])
    mvd = np.asarray(sym["mvd"])
    ri = np.asarray(sym["ri"])
    last = (row0 + n_rows) * mb_w - 1
    payload = None
    for i in range(row0 * mb_w, (row0 + n_rows) * mb_w):
        mby, mbx = i // mb_w, i % mb_w
        by0, bx0 = mby * 4, mbx * 4
        wc = int(win[i])
        intra = wc in (5, 6)
        c = CB._Common(st, mby, mbx, intra=intra)
        wtr.mb_skip_flag(c, wc == 0)
        st.skip[mby, mbx] = wc == 0
        if wc == 0:
            st.cat[mby, mbx] = CB.MBState.CAT_SKIP
            st.cbp[mby, mbx] = 0
            st.cipred[mby, mbx] = 0
            st.last_dqp = 0
        elif intra:
            _write_intra_mb(wtr, c, sym, i, mby, mbx, wc, in_p=True,
                            transform_8x8=p.transform_8x8)
        else:
            wtr.mb_type_p_slice(wc)
            parts = _GEO4[wc]
            if wc == 4:
                for _ in range(4):
                    wtr.sub_mb_type(0)
            r = int(ri[i])
            for (dy4, dx4, h4p, w4p) in parts:
                # interleave write/store: later partitions' ref ctx reads
                # earlier partitions' cells
                if num_ref > 1:
                    wtr.ref_idx(c, by0 + dy4, bx0 + dx4, r)
                st.ref[by0 + dy4:by0 + dy4 + h4p,
                       bx0 + dx4:bx0 + dx4 + w4p] = r
            for pi, (dy4, dx4, h4p, w4p) in enumerate(parts):
                dx = int(mvd[i, pi, 0])
                dy = int(mvd[i, pi, 1])
                wtr.mvd(c, by0 + dy4, bx0 + dx4, 0, dx)
                wtr.mvd(c, by0 + dy4, bx0 + dx4, 1, dy)
                st.mvd[by0 + dy4:by0 + dy4 + h4p,
                       bx0 + dx4:bx0 + dx4 + w4p] = (dx, dy)
            cbp_luma = int(sym["cbp_luma"][i])
            cbp_chroma = int(sym["cbp_chroma"][i])
            cbp = cbp_luma | (cbp_chroma << 4)
            wtr.cbp(c, cbp)
            st.cbp[mby, mbx] = cbp
            st.cat[mby, mbx] = CB.MBState.CAT_INTER
            st.cipred[mby, mbx] = 0
            t8 = bool(sym["t8"][i]) if "t8" in sym else False
            if p.transform_8x8 and cbp_luma > 0:
                # every inter shape we emit is >= 8x8 (spec 7.3.5)
                wtr.transform_size_flag(c, t8)
            if cbp > 0:
                wtr.mb_qp_delta(c, 0)
                zz = np.asarray(sym["zz"][i])
                if t8:
                    # cat-5: one 64-coeff block per coded 8x8 (the rows
                    # hold CAVLC-interleaved 4x4 sub-blocks: de-leave)
                    for b8 in range(4):
                        if not (cbp_luma & (1 << b8)):
                            continue
                        zz64 = zz[4 * b8:4 * b8 + 4].T.reshape(64)
                        wtr.residual_block(c, CB.LUMA_8x8, zz64)
                        for cy in range(2):
                            for cx4 in range(2):
                                c.set_cbf(CB.LUMA_4x4,
                                          by0 + 2 * (b8 >> 1) + cy,
                                          bx0 + 2 * (b8 & 1) + cx4)
                else:
                    for k in range(16):
                        y4, x4 = int(_SCAN[k][0]), int(_SCAN[k][1])
                        b8 = (y4 // 2) * 2 + (x4 // 2)
                        if cbp_luma & (1 << b8):
                            wtr.residual_block(c, CB.LUMA_4x4, zz[k],
                                               by=by0 + y4, bx=bx0 + x4)
                _write_chroma_residual(wtr, c, sym, i, mby, mbx, cbp_chroma)
            else:
                st.last_dqp = 0
        payload = wtr.end_of_slice(i == last)
    return _assemble(hw, payload)


def pack_b_slice_cabac(sym, p: AVCParams, qp: int, frame_num: int,
                       num_ref0: int, num_ref1: int, poc_lsb: int = 0,
                       ref_pic: bool = False, row0: int = 0,
                       n_rows: int = None) -> bytes:
    """CABAC B slice from the device B symbols (win codes: 0 skip,
    1 direct, 2 L0, 3 L1, 4 Bi, 5 I4, 6 I16).  Syntax: Table 9-37 B
    mb_type binarization; mvd/ref contexts read per-list neighbor state
    with the direct-counts-as-zero rule (writeRefPic_B_CABAC)."""
    from .params import SLICE_B
    mb_h, mb_w = p.mb_h, p.mb_w
    n_rows = mb_h - row0 if n_rows is None else n_rows
    hw = BitWriter()
    write_slice_header(hw, p, SLICE_B, frame_num, False, qp,
                       num_ref_idx_l0=num_ref0, num_ref_idx_l1=num_ref1,
                       poc_lsb=poc_lsb, ref_pic=ref_pic,
                       first_mb=row0 * mb_w)
    st = CB.MBState(mb_w, mb_h)
    st.first_mb = row0 * mb_w
    wtr = CB.CabacWriter(SLICE_B, qp, st)
    win = np.asarray(sym["win"])
    mvd0 = np.asarray(sym["mvd0"])
    mvd1 = np.asarray(sym["mvd1"])
    ri0 = np.asarray(sym["ri0"])
    ri1 = np.asarray(sym["ri1"])
    last = (row0 + n_rows) * mb_w - 1
    payload = None
    for i in range(row0 * mb_w, (row0 + n_rows) * mb_w):
        mby, mbx = i // mb_w, i % mb_w
        by0, bx0 = mby * 4, mbx * 4
        sl4 = (slice(by0, by0 + 4), slice(bx0, bx0 + 4))
        wc = int(win[i])
        intra = wc in (5, 6)
        c = CB._Common(st, mby, mbx, intra=intra)
        skip = wc == 0
        wtr.mb_skip_flag_b(c, skip)
        st.skip[mby, mbx] = skip
        st.btype0[mby, mbx] = wc in (0, 1)   # skip / B_Direct_16x16
        if skip:
            st.cat[mby, mbx] = CB.MBState.CAT_SKIP
            st.cbp[mby, mbx] = 0
            st.cipred[mby, mbx] = 0
            st.direct[sl4] = True
            st.last_dqp = 0
            payload = wtr.end_of_slice(i == last)
            continue
        cbp_luma = int(sym["cbp_luma"][i])
        cbp_chroma = int(sym["cbp_chroma"][i])
        cbp = cbp_luma | (cbp_chroma << 4)
        if intra:
            cmode = int(sym["cmode"][i])
            if wc == 6:
                code = mb_type_i16(int(sym["i16mode"][i]), cbp_chroma,
                                   cbp_luma != 0)
                wtr.mb_type_b_slice(c, 23 + code, i16_code=code)
                st.cat[mby, mbx] = CB.MBState.CAT_I16
            else:
                wtr.mb_type_b_slice(c, 23)
                flags = np.asarray(sym["i4flags"][i])
                for k in range(16):
                    wtr.intra_pred_mode(int(flags[k, 0]), int(flags[k, 1]))
                st.cat[mby, mbx] = CB.MBState.CAT_I4
            wtr.chroma_pred_mode(c, cmode)
            st.cipred[mby, mbx] = cmode
            if wc == 5:
                wtr.cbp(c, cbp)
            st.cbp[mby, mbx] = cbp
            st.direct[sl4] = False
            if cbp > 0 or wc == 6:
                wtr.mb_qp_delta(c, 0)
            else:
                st.last_dqp = 0
            zz = np.asarray(sym["zz"][i])
            if wc == 6:
                wtr.residual_block(c, CB.LUMA_16DC, np.asarray(sym["i16dc"][i]))
                if cbp_luma:
                    for k in range(16):
                        y4, x4 = int(_SCAN[k][0]), int(_SCAN[k][1])
                        wtr.residual_block(c, CB.LUMA_16AC, zz[k][:15],
                                           by=by0 + y4, bx=bx0 + x4)
            else:
                for k in range(16):
                    y4, x4 = int(_SCAN[k][0]), int(_SCAN[k][1])
                    b8 = (y4 // 2) * 2 + (x4 // 2)
                    if cbp_luma & (1 << b8):
                        wtr.residual_block(c, CB.LUMA_4x4, zz[k],
                                           by=by0 + y4, bx=bx0 + x4)
            _write_chroma_residual(wtr, c, sym, i, mby, mbx, cbp_chroma)
            payload = wtr.end_of_slice(i == last)
            continue

        # inter B: direct(1)->mb_type 0, l0(2)->1, l1(3)->2, bi(4)->3
        mb_type = wc - 1
        wtr.mb_type_b_slice(c, mb_type)
        st.cat[mby, mbx] = CB.MBState.CAT_INTER
        st.cipred[mby, mbx] = 0
        st.direct[sl4] = mb_type == 0
        if mb_type != 0:
            r0, r1 = int(ri0[i]), int(ri1[i])
            if mb_type in (1, 3):
                if num_ref0 > 1:
                    wtr.ref_idx(c, by0, bx0, r0, lst=0)
                st.ref[sl4] = r0
            else:
                st.ref[sl4] = 0
            if mb_type in (2, 3):
                if num_ref1 > 1:
                    wtr.ref_idx(c, by0, bx0, r1, lst=1)
                st.ref1[sl4] = r1
            else:
                st.ref1[sl4] = 0
            if mb_type in (1, 3):
                dx, dy = int(mvd0[i, 0]), int(mvd0[i, 1])
                wtr.mvd(c, by0, bx0, 0, dx, lst=0)
                wtr.mvd(c, by0, bx0, 1, dy, lst=0)
                st.mvd[sl4] = (dx, dy)
            else:
                st.mvd[sl4] = 0
            if mb_type in (2, 3):
                dx, dy = int(mvd1[i, 0]), int(mvd1[i, 1])
                wtr.mvd(c, by0, bx0, 0, dx, lst=1)
                wtr.mvd(c, by0, bx0, 1, dy, lst=1)
                st.mvd1[sl4] = (dx, dy)
            else:
                st.mvd1[sl4] = 0
        else:
            st.ref[sl4] = 0
            st.ref1[sl4] = 0
            st.mvd[sl4] = 0
            st.mvd1[sl4] = 0
        wtr.cbp(c, cbp)
        st.cbp[mby, mbx] = cbp
        if cbp > 0:
            wtr.mb_qp_delta(c, 0)
            zz = np.asarray(sym["zz"][i])
            for k in range(16):
                y4, x4 = int(_SCAN[k][0]), int(_SCAN[k][1])
                b8 = (y4 // 2) * 2 + (x4 // 2)
                if cbp_luma & (1 << b8):
                    wtr.residual_block(c, CB.LUMA_4x4, zz[k],
                                       by=by0 + y4, bx=bx0 + x4)
            _write_chroma_residual(wtr, c, sym, i, mby, mbx, cbp_chroma)
        else:
            st.last_dqp = 0
        payload = wtr.end_of_slice(i == last)
    return _assemble(hw, payload)
