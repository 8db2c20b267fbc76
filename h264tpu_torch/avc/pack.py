"""Host-side slice packer for the TPU encoder's symbol arrays.

The device graph (``avc/tpu_enc.py``) makes every decision and emits
per-MB symbol arrays; this module performs the only inherently serial
step — variable-length bit packing into the H.264 slice RBSP — exactly
mirroring the (ldecod-verified) syntax emitted by ``avc/slice_enc.py``:
macroblock_layer() per spec 7.3.5 with CAVLC residuals (9.2).

Because all decisions are already made, there is no sequential state
beyond the skip run: the nC contexts are computed from the *final* nnz
planes (neighbors precede the current MB in raster order, so their final
TotalCoeff equals their value at write time).

Reference: ``JM/lencod/src/macroblock.c`` write_one_macroblock,
``JM/ldecod/src/mb_read.c:1139`` (decode twin / oracle).

The port's own copy of ``h264tpu/avc/pack.py``; it imports nothing from ``h264tpu``.
"""

from __future__ import annotations

import numpy as np

from ..entropy.bitio import BitWriter
from . import cavlc as CV
from .tables import (BLOCK_SCAN, CBP_TO_CODENUM_INTRA, CBP_TO_CODENUM_INTER,
                     mb_type_i16, MB_I4x4)
from .params import AVCParams, write_slice_header, SLICE_I, SLICE_P, SLICE_B

# symbol win codes (tpu_enc)
WIN_SKIP, WIN_16x16, WIN_16x8, WIN_8x16, WIN_P8x8, WIN_I4, WIN_I16, \
    WIN_P8SUB = range(8)
_N_PARTS = {WIN_16x16: 1, WIN_16x8: 2, WIN_8x16: 2, WIN_P8x8: 4}
# parts per sub_mb_type (spec Table 7-14: 8x8, 8x4, 4x8, 4x4)
_SUB_N_PARTS = (1, 2, 2, 4)


def _nnz_planes(sym, mb_h: int, mb_w: int):
    """Decoder-visible TotalCoeff planes from the symbol arrays."""
    scan = np.asarray(BLOCK_SCAN)
    zz = np.asarray(sym["zz"]).reshape(mb_h, mb_w, 16, -1)
    counts = (zz != 0).sum(-1)                       # [mb_h, mb_w, 16] coding
    nnz_y = np.zeros((mb_h * 4, mb_w * 4), np.int64)
    for k in range(16):
        y4, x4 = int(scan[k][0]), int(scan[k][1])
        nnz_y[y4::4, x4::4] = counts[:, :, k]
    cac = np.asarray(sym["cac"]).reshape(mb_h, mb_w, 2, 2, 2, 15)
    ccnt = (cac != 0).sum(-1)                        # [mb_h, mb_w, 2, 2, 2]
    nnz_c = np.zeros((2, mb_h * 2, mb_w * 2), np.int64)
    for ci in range(2):
        for by in range(2):
            for bx in range(2):
                nnz_c[ci, by::2, bx::2] = ccnt[:, :, ci, by, bx]
    return nnz_y, nnz_c


def _nc_luma(nnz_y, by, bx, top_by=0):
    has_a, has_b = bx > 0, by > top_by
    na = int(nnz_y[by, bx - 1]) if has_a else 0
    nb = int(nnz_y[by - 1, bx]) if has_b else 0
    if has_a and has_b:
        return (na + nb + 1) >> 1
    return na if has_a else (nb if has_b else 0)


def _nc_chroma(nnz_c, ci, by, bx, top_by=0):
    has_a, has_b = bx > 0, by > top_by
    na = int(nnz_c[ci, by, bx - 1]) if has_a else 0
    nb = int(nnz_c[ci, by - 1, bx]) if has_b else 0
    if has_a and has_b:
        return (na + nb + 1) >> 1
    return na if has_a else (nb if has_b else 0)


def _write_luma_residual(w, sym_zz, cbp_luma, nnz_y, mby, mbx, i16: bool,
                         i16dc=None, top_by=0):
    scan = np.asarray(BLOCK_SCAN)
    if i16:
        nc = _nc_luma(nnz_y, mby * 4, mbx * 4, top_by)
        CV.write_block(w, i16dc, nc, 16)
    for k in range(16):
        y4, x4 = int(scan[k][0]), int(scan[k][1])
        by, bx = mby * 4 + y4, mbx * 4 + x4
        b8 = (y4 // 2) * 2 + (x4 // 2)
        if i16:
            if cbp_luma:
                nc = _nc_luma(nnz_y, by, bx, top_by)
                CV.write_block(w, sym_zz[k][:15], nc, 15)
        else:
            if cbp_luma & (1 << b8):
                nc = _nc_luma(nnz_y, by, bx, top_by)
                CV.write_block(w, sym_zz[k], nc, 16)


def _write_chroma_residual(w, cdc, cac, cbp_chroma, nnz_c, mby, mbx,
                           top_by=0):
    if cbp_chroma > 0:
        for ci in range(2):
            CV.write_block(w, cdc[ci], -1, 4)
    if cbp_chroma == 2:
        for ci in range(2):
            for by4 in range(2):
                for bx4 in range(2):
                    nc = _nc_chroma(nnz_c, ci, mby * 2 + by4, mbx * 2 + bx4,
                                    top_by)
                    CV.write_block(w, cac[ci, by4, bx4], nc, 15)


def _write_intra_payload(w, sym, nnz_y, nnz_c, mby, mbx, i, use_i16: bool,
                         in_p: bool, top_row=0, base=None,
                         transform_8x8: bool = False, w_res=None):
    """mb_type .. residual for one intra MB (shared I/P/B logic);
    ``base`` = intra mb_type offset (0 in I, 5 in P, 23 in B);
    ``w_res``: separate writer for the residual (data partitioning
    category-3 split, partition B) — defaults to ``w``."""
    cbp_luma = int(sym["cbp_luma"][i])
    cbp_chroma = int(sym["cbp_chroma"][i])
    if base is None:
        base = 5 if in_p else 0
    if use_i16:
        w.ue(base + mb_type_i16(int(sym["i16mode"][i]), cbp_chroma,
                                cbp_luma != 0))
    else:
        w.ue(base + MB_I4x4)
        if transform_8x8:
            w.u(0, 1)          # transform_size_8x8_flag: we emit I4x4
        flags = np.asarray(sym["i4flags"][i])
        for k in range(16):
            w.u(int(flags[k, 0]), 1)
            if not flags[k, 0]:
                w.u(int(flags[k, 1]), 3)
    w.ue(int(sym["cmode"][i]))
    if not use_i16:
        cbp = cbp_luma | (cbp_chroma << 4)
        w.ue(int(CBP_TO_CODENUM_INTRA[cbp]))
        if cbp > 0:
            w.se(0)
    else:
        w.se(0)
    zz = np.asarray(sym["zz"][i])
    wr = w if w_res is None else w_res
    _write_luma_residual(wr, zz, cbp_luma, nnz_y, mby, mbx, use_i16,
                         i16dc=np.asarray(sym["i16dc"][i]),
                         top_by=top_row * 4)
    _write_chroma_residual(wr, np.asarray(sym["cdc"][i]),
                           np.asarray(sym["cac"][i]), cbp_chroma,
                           nnz_c, mby, mbx, top_by=top_row * 2)


def pack_i_slice(sym, p: AVCParams, qp: int, frame_num: int = 0,
                 idr: bool = True, idr_pic_id: int = 0,
                 row0: int = 0, n_rows: int = None) -> bytes:
    """Pack an all-intra frame's symbols into one I/IDR slice RBSP
    covering MB rows [row0, row0 + n_rows) (a row-band slice)."""
    mb_h, mb_w = p.mb_h, p.mb_w
    n_rows = mb_h - row0 if n_rows is None else n_rows
    nnz_y, nnz_c = _nnz_planes(sym, mb_h, mb_w)
    w = BitWriter()
    write_slice_header(w, p, SLICE_I, frame_num, idr, qp,
                       idr_pic_id=idr_pic_id, first_mb=row0 * mb_w)
    win = np.asarray(sym["win"])
    for i in range(row0 * mb_w, (row0 + n_rows) * mb_w):
        mby, mbx = i // mb_w, i % mb_w
        _write_intra_payload(w, sym, nnz_y, nnz_c, mby, mbx, i,
                             use_i16=win[i] == WIN_I16, in_p=False,
                             top_row=row0, transform_8x8=p.transform_8x8)
    w.u(1, 1)
    return w.to_bytes()


def pack_p_slice(sym, p: AVCParams, qp: int, frame_num: int,
                 num_ref: int, row0: int = 0, n_rows: int = None,
                 poc_lsb: int = 0, mmco=None, reorder_l0=None,
                 wp=None, dp_slice_id=None):
    """Pack a P frame's symbols into one P slice RBSP covering MB rows
    [row0, row0 + n_rows).  ``poc_lsb``, ``mmco``, ``reorder_l0`` and the
    explicit-WP table ``wp`` go to the slice header.

    ``dp_slice_id``: when not None, emit with data partitioning (spec
    7.4.1): returns (rbsp_a, rbsp_b, rbsp_c) — A carries the slice
    header + slice_id + category-2 syntax, B the intra residual, C the
    inter residual, each of B/C prefixed by the same slice_id."""
    mb_h, mb_w = p.mb_h, p.mb_w
    n_rows = mb_h - row0 if n_rows is None else n_rows
    nnz_y, nnz_c = _nnz_planes(sym, mb_h, mb_w)
    win = np.asarray(sym["win"])
    mvd = np.asarray(sym["mvd"])
    ri = np.asarray(sym["ri"])
    w = BitWriter()
    write_slice_header(w, p, SLICE_P, frame_num, False, qp,
                       num_ref_idx_l0=num_ref, first_mb=row0 * mb_w,
                       poc_lsb=poc_lsb, mmco=mmco, reorder_l0=reorder_l0,
                       wp=wp)
    if dp_slice_id is None:
        w_b = w_c = w
    else:
        if p.cabac:
            raise ValueError("data partitioning requires CAVLC")
        w.ue(dp_slice_id)
        w_b, w_c = BitWriter(), BitWriter()
        w_b.ue(dp_slice_id)
        w_c.ue(dp_slice_id)
    skip_run = 0
    for i in range(row0 * mb_w, (row0 + n_rows) * mb_w):
        mby, mbx = i // mb_w, i % mb_w
        wc = int(win[i])
        if wc == WIN_SKIP:
            skip_run += 1
            continue
        w.ue(skip_run)
        skip_run = 0
        if wc in (WIN_I4, WIN_I16):
            _write_intra_payload(w, sym, nnz_y, nnz_c, mby, mbx, i,
                                 use_i16=wc == WIN_I16, in_p=True,
                                 top_row=row0, transform_8x8=p.transform_8x8,
                                 w_res=w_b)
            continue
        mb_type = {WIN_16x16: 0, WIN_16x8: 1, WIN_8x16: 2, WIN_P8x8: 3,
                   WIN_P8SUB: 3}[wc]
        w.ue(mb_type)
        if wc == WIN_P8SUB:
            # P_8x8 with per-cell sub_mb_type (spec 7.3.5.2): sub types,
            # then ref_idx per 8x8, then MVDs in sub-block order
            subs = [int(s) for s in sym["sub"][i]]
            for s in subs:
                w.ue(s)
            if num_ref > 1:
                r = int(ri[i])
                for _ in range(4):
                    if num_ref == 2:
                        w.u(1 - r, 1)
                    else:
                        w.ue(r)
            mvd_s = np.asarray(sym["mvd_s"][i])
            for c, s in enumerate(subs):
                for pi in range(_SUB_N_PARTS[s]):
                    w.se(int(mvd_s[c, pi, 0]))
                    w.se(int(mvd_s[c, pi, 1]))
        else:
            nparts = _N_PARTS[wc]
            if wc == WIN_P8x8:
                for _ in range(4):
                    w.ue(0)                       # sub_mb_type = P_L0_8x8
            if num_ref > 1:
                r = int(ri[i])
                for _ in range(nparts):
                    if num_ref == 2:
                        w.u(1 - r, 1)
                    else:
                        w.ue(r)
            for pi in range(nparts):
                w.se(int(mvd[i, pi, 0]))
                w.se(int(mvd[i, pi, 1]))
        cbp_luma = int(sym["cbp_luma"][i])
        cbp_chroma = int(sym["cbp_chroma"][i])
        cbp = cbp_luma | (cbp_chroma << 4)
        w.ue(int(CBP_TO_CODENUM_INTER[cbp]))
        if cbp > 0:
            no_small = wc != WIN_P8SUB or \
                all(int(s) == 0 for s in sym["sub"][i])
            if p.transform_8x8 and cbp_luma > 0 and no_small:
                # the flag is present when luma is coded and no
                # partition is below 8x8 (spec 7.3.5
                # NoSubMbPartSizeLessThan8x8Flag)
                w.u(int(sym["t8"][i]) if "t8" in sym else 0, 1)
            w.se(0)
            _write_luma_residual(w_c, np.asarray(sym["zz"][i]), cbp_luma,
                                 nnz_y, mby, mbx, False, top_by=row0 * 4)
            _write_chroma_residual(w_c, np.asarray(sym["cdc"][i]),
                                   np.asarray(sym["cac"][i]), cbp_chroma,
                                   nnz_c, mby, mbx, top_by=row0 * 2)
    if skip_run > 0:
        w.ue(skip_run)
    w.u(1, 1)
    if dp_slice_id is None:
        return w.to_bytes()
    w_b.u(1, 1)
    w_c.u(1, 1)
    return w.to_bytes(), w_b.to_bytes(), w_c.to_bytes()


# win codes for B slices (device_enc.decide_b)
WIN_B_SKIP, WIN_B_DIRECT, WIN_B_L0, WIN_B_L1, WIN_B_BI = range(5)


def pack_b_slice(sym, p: AVCParams, qp: int, frame_num: int,
                 num_ref0: int, num_ref1: int, poc_lsb: int = 0,
                 ref_pic: bool = False, row0: int = 0,
                 n_rows: int = None) -> bytes:
    """Pack a B frame's device symbols into one B slice RBSP covering MB
    rows [row0, row0 + n_rows): spatial direct, mb_types
    {B_Direct_16x16, B_L0_16x16, B_L1_16x16, B_Bi_16x16, intra 23+}."""
    mb_h, mb_w = p.mb_h, p.mb_w
    n_rows = mb_h - row0 if n_rows is None else n_rows
    nnz_y, nnz_c = _nnz_planes(sym, mb_h, mb_w)
    win = np.asarray(sym["win"])
    mvd0 = np.asarray(sym["mvd0"])
    mvd1 = np.asarray(sym["mvd1"])
    ri0 = np.asarray(sym["ri0"])
    ri1 = np.asarray(sym["ri1"])
    w = BitWriter()
    write_slice_header(w, p, SLICE_B, frame_num, False, qp,
                       num_ref_idx_l0=num_ref0, num_ref_idx_l1=num_ref1,
                       poc_lsb=poc_lsb, ref_pic=ref_pic,
                       first_mb=row0 * mb_w)
    skip_run = 0
    for i in range(row0 * mb_w, (row0 + n_rows) * mb_w):
        mby, mbx = i // mb_w, i % mb_w
        wc = int(win[i])
        if wc == WIN_B_SKIP:
            skip_run += 1
            continue
        w.ue(skip_run)
        skip_run = 0
        if wc in (WIN_I4, WIN_I16):
            _write_intra_payload(w, sym, nnz_y, nnz_c, mby, mbx, i,
                                 use_i16=wc == WIN_I16, in_p=True,
                                 top_row=row0, base=23,
                                 transform_8x8=p.transform_8x8)
            continue
        mb_type = {WIN_B_DIRECT: 0, WIN_B_L0: 1, WIN_B_L1: 2,
                   WIN_B_BI: 3}[wc]
        w.ue(mb_type)
        if wc in (WIN_B_L0, WIN_B_BI) and num_ref0 > 1:
            r = int(ri0[i])
            w.u(1 - r, 1) if num_ref0 == 2 else w.ue(r)
        if wc in (WIN_B_L1, WIN_B_BI) and num_ref1 > 1:
            r = int(ri1[i])
            w.u(1 - r, 1) if num_ref1 == 2 else w.ue(r)
        if wc in (WIN_B_L0, WIN_B_BI):
            w.se(int(mvd0[i, 0]))
            w.se(int(mvd0[i, 1]))
        if wc in (WIN_B_L1, WIN_B_BI):
            w.se(int(mvd1[i, 0]))
            w.se(int(mvd1[i, 1]))
        cbp_luma = int(sym["cbp_luma"][i])
        cbp_chroma = int(sym["cbp_chroma"][i])
        cbp = cbp_luma | (cbp_chroma << 4)
        w.ue(int(CBP_TO_CODENUM_INTER[cbp]))
        if cbp > 0:
            if p.transform_8x8 and cbp_luma > 0:
                # every inter shape emitted here is >= 8x8 (B direct/16x16
                # with direct_8x8_inference=1), so the flag is present
                # when luma is coded (spec 7.3.5)
                w.u(int(sym["t8"][i]) if "t8" in sym else 0, 1)
            w.se(0)
            _write_luma_residual(w, np.asarray(sym["zz"][i]), cbp_luma,
                                 nnz_y, mby, mbx, False, top_by=row0 * 4)
            _write_chroma_residual(w, np.asarray(sym["cdc"][i]),
                                   np.asarray(sym["cac"][i]), cbp_chroma,
                                   nnz_c, mby, mbx, top_by=row0 * 2)
    if skip_run > 0:
        w.ue(skip_run)
    w.u(1, 1)
    return w.to_bytes()
