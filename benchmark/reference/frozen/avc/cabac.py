"""CABAC bound to real H.264 macroblock syntax (spec 9.3, Main profile).

Binarizations, context-index derivations, and the per-slice context
initialization for every syntax element the framework emits in I/P
slices: mb_skip_flag, mb_type (I and P trees incl. the I_16x16 suffix),
sub_mb_type, ref_idx_l0, mvd_l0 (UEG3), intra pred modes, chroma pred
mode, coded_block_pattern, mb_qp_delta, coded_block_flag, significance
maps, coeff_abs_level_minus1 (UEG0) and end_of_slice_flag — wired to the
M-coder engine in :mod:`h264tpu_torch.entropy.cabac_eng` (spec 9.3.4 tables).

Semantics mirror the reference encoder/decoder pair
(``JM/lencod/src/cabac.c`` writeMB_*_CABAC / writeRunLevel_CABAC,
``JM/ldecod/src/cabac.c`` + ``read_comp_cabac.c``); context-init
constants are the standard's Tables 9-12..9-33 (``avc/cabac_tables.py``).
Frame coding, 4:2:0, 4x4 transform (block categories
LUMA_16DC/LUMA_16AC/LUMA_4x4/CHROMA_DC/CHROMA_AC).

The port's own copy of ``h264tpu/avc/cabac.py``; it imports nothing from
``h264tpu``.
"""

from __future__ import annotations

import numpy as np

from ..entropy.cabac_eng import Encoder, Decoder
from . import cabac_tables as CT

# ---------------------------------------------------------------------------
# context layout (flat engine indices)
# ---------------------------------------------------------------------------

OFF_MB_TYPE = 0                      # [3][11]
OFF_B8_TYPE = 33                     # [2][9]
OFF_MV_RES = 51                      # [2][10]
OFF_REF_NO = 71                      # [2][6]
OFF_DELTA_QP = 83                    # [4]
OFF_IPR = 87                         # [2]
OFF_CIPR = 89                        # [4]
OFF_CBP = 93                         # [3][4]
OFF_BCBP = 105                       # [22][4]
OFF_MAP = 193                        # [22][15]
OFF_LAST = 523                       # [22][15]
OFF_ONE = 853                        # [22][5]
OFF_ABS = 963                        # [22][5]
OFF_TS = 1073                        # [3] transform_size_8x8_flag
NUM_CTX = 1076

# block categories (JM block-type enum subset used for 4:2:0 coding)
LUMA_16DC, LUMA_16AC, LUMA_8x8, LUMA_4x4, CHROMA_DC, CHROMA_AC = \
    0, 1, 2, 5, 6, 7

MAXPOS = {LUMA_16DC: 15, LUMA_16AC: 14, LUMA_8x8: 63, LUMA_4x4: 15,
          CHROMA_DC: 3, CHROMA_AC: 14}
C1ISDC = {LUMA_16DC: 1, LUMA_16AC: 0, LUMA_8x8: 1, LUMA_4x4: 1,
          CHROMA_DC: 1, CHROMA_AC: 0}
TYPE2CTX_BCBP = {LUMA_16DC: 0, LUMA_16AC: 1, LUMA_8x8: 2, LUMA_4x4: 4,
                 CHROMA_DC: 5, CHROMA_AC: 6}
TYPE2CTX_MAP = {LUMA_16DC: 0, LUMA_16AC: 1, LUMA_8x8: 2, LUMA_4x4: 5,
                CHROMA_DC: 6, CHROMA_AC: 7}
TYPE2CTX_LAST = TYPE2CTX_MAP
TYPE2CTX_ONE = {LUMA_16DC: 0, LUMA_16AC: 1, LUMA_8x8: 2, LUMA_4x4: 4,
                CHROMA_DC: 5, CHROMA_AC: 6}
MAX_C2 = {LUMA_16DC: 4, LUMA_16AC: 4, LUMA_8x8: 4, LUMA_4x4: 4,
          CHROMA_DC: 3, CHROMA_AC: 4}

# 8x8 position -> ctx maps (JM lencod/src/cabac.c pos2ctx_map8x8 /
# pos2ctx_last8x8; Rec. H.264 Table 9-43 frame-scan assignment)
_P8x8_MAP = [
    0, 1, 2, 3, 4, 5, 5, 4, 4, 3, 3, 4, 4, 4, 5, 5,
    4, 4, 4, 4, 3, 3, 6, 7, 7, 7, 8, 9, 10, 9, 8, 7,
    7, 6, 11, 12, 13, 11, 6, 7, 8, 9, 14, 10, 9, 8, 6, 11,
    12, 13, 11, 6, 9, 14, 10, 9, 11, 12, 13, 11, 14, 10, 12, 14]
_P8x8_LAST = [
    0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    3, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4,
    5, 5, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7, 8, 8, 8, 8]

# position -> ctx tables (JM pos2ctx_map/pos2ctx_last): all our 4:2:0
# 4x4-transform categories use the identity 4x4 table (CHROMA_DC 4:2:0 has
# maxpos 3, so identity == the spec's min(levelListIdx, 2) on coded bins)
_P4x4 = list(range(15)) + [14]
POS2CTX_MAP = {LUMA_16DC: _P4x4, LUMA_16AC: _P4x4, LUMA_8x8: _P8x8_MAP,
               LUMA_4x4: _P4x4, CHROMA_DC: _P4x4, CHROMA_AC: _P4x4}
POS2CTX_LAST = {LUMA_16DC: _P4x4, LUMA_16AC: _P4x4, LUMA_8x8: _P8x8_LAST,
                LUMA_4x4: _P4x4, CHROMA_DC: _P4x4, CHROMA_AC: _P4x4}

# coded_block_flag bit positions in the per-MB cbp_bits bitset (JM layout)
BIT_LUMA_DC = 0
BIT_CHROMA_U_DC = 17
BIT_CHROMA_V_DC = 18


def init_context_arrays(slice_type: int, cabac_init_idc: int, qp: int):
    """(state [NUM_CTX], mps [NUM_CTX]) per spec 9.3.1.1 / JM
    biari_init_context: pstate = ((m*qp)>>4)+n, split at 64."""
    is_i = slice_type == 2
    idc = 0 if is_i else cabac_init_idc

    def grab(tab_i, tab_p):
        return tab_i[0] if is_i else tab_p[idc]

    groups = [
        grab(CT.INIT_MB_TYPE_I, CT.INIT_MB_TYPE_P).reshape(-1, 2),
        grab(CT.INIT_B8_TYPE_I, CT.INIT_B8_TYPE_P).reshape(-1, 2),
        grab(CT.INIT_MV_RES_I, CT.INIT_MV_RES_P).reshape(-1, 2),
        grab(CT.INIT_REF_NO_I, CT.INIT_REF_NO_P).reshape(-1, 2),
        grab(CT.INIT_DELTA_QP_I, CT.INIT_DELTA_QP_P).reshape(-1, 2),
        grab(CT.INIT_IPR_I, CT.INIT_IPR_P).reshape(-1, 2),
        grab(CT.INIT_CIPR_I, CT.INIT_CIPR_P).reshape(-1, 2),
        grab(CT.INIT_CBP_I, CT.INIT_CBP_P).reshape(-1, 2),
        grab(CT.INIT_BCBP_I, CT.INIT_BCBP_P).reshape(-1, 2),
        grab(CT.INIT_MAP_I, CT.INIT_MAP_P).reshape(-1, 2),
        grab(CT.INIT_LAST_I, CT.INIT_LAST_P).reshape(-1, 2),
        grab(CT.INIT_ONE_I, CT.INIT_ONE_P).reshape(-1, 2),
        grab(CT.INIT_ABS_I, CT.INIT_ABS_P).reshape(-1, 2),
        grab(CT.INIT_TRANSFORM_SIZE_I,
             CT.INIT_TRANSFORM_SIZE_P).reshape(-1, 2),
    ]
    mn = np.concatenate(groups, axis=0)
    assert mn.shape[0] == NUM_CTX, mn.shape
    pstate = ((mn[:, 0].astype(np.int64) * qp) >> 4) + mn[:, 1]
    mps = pstate >= 64
    state = np.where(mps, np.minimum(pstate, 126) - 64,
                     63 - np.maximum(pstate, 1))
    return state.astype(np.int64), mps.astype(np.int64)


class MBState:
    """Per-picture neighbor bookkeeping the context derivations read.

    Mirrors the JM Macroblock fields consulted by the CABAC writers:
    skip flags, mb-type categories, cbp, the coded_block_flag bitset,
    per-cell |mvd| and ref_idx, chroma pred modes.  ``first_mb`` bounds
    same-slice availability (spec 6.4.11)."""

    CAT_SKIP, CAT_INTER, CAT_I4, CAT_I16 = 0, 1, 2, 3

    def __init__(self, mb_w: int, mb_h: int):
        self.mb_w, self.mb_h = mb_w, mb_h
        self.cat = np.full((mb_h, mb_w), -1, np.int64)
        self.skip = np.zeros((mb_h, mb_w), bool)
        self.cbp = np.zeros((mb_h, mb_w), np.int64)
        self.cbp_bits = np.zeros((mb_h, mb_w), np.int64)  # 41-bit set
        self.mvd = np.zeros((mb_h * 4, mb_w * 4, 2), np.int64)
        self.ref = np.zeros((mb_h * 4, mb_w * 4), np.int64)
        # B slices: list-1 twins + per-cell direct flag (b8 mode 0 /
        # mb_type 0 cells count as ref 0 / |mvd| 0 in ctx derivations)
        self.mvd1 = np.zeros((mb_h * 4, mb_w * 4, 2), np.int64)
        self.ref1 = np.zeros((mb_h * 4, mb_w * 4), np.int64)
        self.direct = np.zeros((mb_h * 4, mb_w * 4), bool)
        self.btype0 = np.zeros((mb_h, mb_w), bool)   # B mb_type == 0
        self.t8 = np.zeros((mb_h, mb_w), bool)       # 8x8 transform flag
        self.cipred = np.zeros((mb_h, mb_w), np.int64)
        self.first_mb = 0
        self.last_dqp = 0

    def avail(self, mby, mbx):
        if mby < 0 or mbx < 0 or mbx >= self.mb_w:
            return False
        return mby * self.mb_w + mbx >= self.first_mb

    def is_intra(self, mby, mbx):
        return self.cat[mby, mbx] >= self.CAT_I4


class _Common:
    """Context-index derivations shared by writer and reader."""

    def __init__(self, st: MBState, mby: int, mbx: int, intra: bool):
        self.st = st
        self.mby, self.mbx = mby, mbx
        self.intra = intra          # current MB coded as intra
        self.up = st.avail(mby - 1, mbx)
        self.left = st.avail(mby, mbx - 1)

    # --- mb-level ctx increments ---
    def skip_ctx(self):
        st, mby, mbx = self.st, self.mby, self.mbx
        a = 1 if (self.left and not st.skip[mby, mbx - 1]) else 0
        b = 1 if (self.up and not st.skip[mby - 1, mbx]) else 0
        return a + b

    def ts8_ctx(self):
        """transform_size_8x8_flag ctx: neighbors' flags (JM
        writeMB_transform_size_flag_CABAC)."""
        st, mby, mbx = self.st, self.mby, self.mbx
        a = 1 if (self.left and st.t8[mby, mbx - 1]) else 0
        b = 1 if (self.up and st.t8[mby - 1, mbx]) else 0
        return a + b

    def itype_ctx(self):
        """I-slice mb_type bin0 ctx (neighbor not I4x4)."""
        st, mby, mbx = self.st, self.mby, self.mbx
        b = 1 if (self.up and st.cat[mby - 1, mbx] != MBState.CAT_I4) else 0
        a = 1 if (self.left and st.cat[mby, mbx - 1] != MBState.CAT_I4) else 0
        return a + b

    def cipred_ctx(self):
        st, mby, mbx = self.st, self.mby, self.mbx
        b = 1 if (self.up and st.cipred[mby - 1, mbx] != 0) else 0
        a = 1 if (self.left and st.cipred[mby, mbx - 1] != 0) else 0
        return a + b

    def cbp_luma_ctx(self, b8: int, cbp_so_far: int):
        """writeCBP_BIT_CABAC ctx for luma bin b8."""
        st, mby, mbx = self.st, self.mby, self.mbx
        mb_x = (b8 & 1) << 1
        mb_y = (b8 >> 1) << 1
        if mb_y == 0:
            b = 0
            if self.up:
                b = 1 if (st.cbp[mby - 1, mbx] & (1 << (2 + (mb_x >> 1)))) \
                    == 0 else 0
        else:
            b = 1 if (cbp_so_far & (1 << (mb_x >> 1))) == 0 else 0
        if mb_x == 0:
            a = 0
            if self.left:
                a = 1 if (st.cbp[mby, mbx - 1]
                          & (1 << (2 * (mb_y >> 1) + 1))) == 0 else 0
        else:
            a = 1 if (cbp_so_far & (1 << mb_y)) == 0 else 0
        return a + 2 * b

    def cbp_chroma_ctx(self, second: bool):
        st, mby, mbx = self.st, self.mby, self.mbx
        if not second:
            b0 = 2 if (self.up and st.cbp[mby - 1, mbx] > 15) else 0
            a0 = 1 if (self.left and st.cbp[mby, mbx - 1] > 15) else 0
            return a0 + b0
        b1 = 2 if (self.up and st.cbp[mby - 1, mbx] > 15
                   and (st.cbp[mby - 1, mbx] >> 4) == 2) else 0
        a1 = 1 if (self.left and st.cbp[mby, mbx - 1] > 15
                   and (st.cbp[mby, mbx - 1] >> 4) == 2) else 0
        return a1 + b1

    def dqp_ctx(self):
        return 1 if self.st.last_dqp != 0 else 0

    def b_mbtype_ctx(self):
        """B mb_type bin-0 ctx: neighbor MB-level mb_type != 0 (skip and
        B_Direct_16x16 count 0 even with coefficients, but a B_8x8 with
        direct sub-blocks counts 1; writeMB_B_typeInfo_CABAC)."""
        st, mby, mbx = self.st, self.mby, self.mbx
        b = 1 if (self.up and not st.btype0[mby - 1, mbx]) else 0
        a = 1 if (self.left and not st.btype0[mby, mbx - 1]) else 0
        return a + b

    # --- cell neighbors (luma 4x4 / chroma 2x2 grids) ---
    def _cell(self, by, bx, cells):
        """(mby, mbx, in_frame+same_slice avail) of the cell's MB."""
        if by < 0 or bx < 0 or bx >= self.st.mb_w * cells:
            return None
        mby, mbx = by // cells, bx // cells
        if not self.st.avail(mby, mbx):
            return None
        return mby, mbx

    def mvd_ctx(self, by, bx, comp, lst: int = 0):
        """|mvdA| + |mvdB| threshold ctx (writeMVD_CABAC)."""
        st = self.st
        mvd = st.mvd if lst == 0 else st.mvd1
        s = 0
        for (nby, nbx) in ((by, bx - 1), (by - 1, bx)):
            n = self._cell(nby, nbx, 4)
            if n is not None:
                s += abs(int(mvd[nby, nbx, comp]))
        if s < 3:
            return 5 * comp
        return 5 * comp + (3 if s > 32 else 2)

    def ref_ctx(self, by, bx, lst: int = 0):
        """ref_idx ctx; in B slices a skip/direct neighbor cell counts
        as 0 (writeRefPic_B_CABAC)."""
        st = self.st
        ref = st.ref if lst == 0 else st.ref1

        def nb(nby, nbx):
            n = self._cell(nby, nbx, 4)
            if n is None or st.direct[nby, nbx]:
                return 0
            return 1 if ref[nby, nbx] > 0 else 0

        return nb(by, bx - 1) + 2 * nb(by - 1, bx)

    def cbf_ctx(self, cat: int, by: int, bx: int, comp: int = 0):
        """coded_block_flag ctx (write_and_store_CBP_block_bit).

        by/bx: luma 4x4 cell coords (cat LUMA_16AC/LUMA_4x4), chroma 2x2
        cell coords (CHROMA_AC), or MB coords for the DC cats."""
        st = self.st
        default = 1 if self.intra else 0

        def nb_bit(nmby, nmbx, bit):
            if not st.avail(nmby, nmbx):
                return default
            return (int(st.cbp_bits[nmby, nmbx]) >> bit) & 1

        if cat == LUMA_16DC:
            up = nb_bit(self.mby - 1, self.mbx, BIT_LUMA_DC)
            left = nb_bit(self.mby, self.mbx - 1, BIT_LUMA_DC)
        elif cat in (LUMA_16AC, LUMA_4x4):
            # neighbor 4x4 cells; in-MB bits come from the current bitset
            def lum_bit(nby, nbx):
                if nby < 0 or nbx < 0 or nbx >= st.mb_w * 4:
                    return default
                nmby, nmbx = nby // 4, nbx // 4
                if (nmby, nmbx) == (self.mby, self.mbx):
                    bits = int(st.cbp_bits[self.mby, self.mbx])
                elif st.avail(nmby, nmbx):
                    bits = int(st.cbp_bits[nmby, nmbx])
                else:
                    return default
                return (bits >> (1 + 4 * (nby % 4) + (nbx % 4))) & 1
            up = lum_bit(by - 1, bx)
            left = lum_bit(by, bx - 1)
        elif cat == CHROMA_DC:
            bit = BIT_CHROMA_U_DC if comp == 0 else BIT_CHROMA_V_DC
            up = nb_bit(self.mby - 1, self.mbx, bit)
            left = nb_bit(self.mby, self.mbx - 1, bit)
        else:                                   # CHROMA_AC
            base = 19 if comp == 0 else 35

            def ch_bit(nby, nbx):
                if nby < 0 or nbx < 0 or nbx >= st.mb_w * 2:
                    return default
                nmby, nmbx = nby // 2, nbx // 2
                if (nmby, nmbx) == (self.mby, self.mbx):
                    bits = int(st.cbp_bits[self.mby, self.mbx])
                elif st.avail(nmby, nmbx):
                    bits = int(st.cbp_bits[nmby, nmbx])
                else:
                    return default
                return (bits >> (base + 4 * (nby % 2) + (nbx % 2))) & 1
            up = ch_bit(by - 1, bx)
            left = ch_bit(by, bx - 1)
        return (up << 1) + left

    def set_cbf(self, cat, by, bx, comp=0):
        """Record a nonzero coded_block_flag in the current MB's bitset."""
        st = self.st
        if cat == LUMA_16DC:
            bit = BIT_LUMA_DC
        elif cat in (LUMA_16AC, LUMA_4x4):
            bit = 1 + 4 * (by % 4) + (bx % 4)
        elif cat == CHROMA_DC:
            bit = BIT_CHROMA_U_DC if comp == 0 else BIT_CHROMA_V_DC
        else:
            bit = (19 if comp == 0 else 35) + 4 * (by % 2) + (bx % 2)
        st.cbp_bits[self.mby, self.mbx] |= 1 << bit


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

class CabacWriter:
    """Slice-scoped CABAC syntax writer."""

    def __init__(self, slice_type: int, qp: int, st: MBState,
                 cabac_init_idc: int = 0):
        self.enc = Encoder(num_ctx=NUM_CTX)
        self.enc.init_contexts(*init_context_arrays(slice_type,
                                                    cabac_init_idc, qp))
        self.st = st
        self.slice_type = slice_type
        st.last_dqp = 0

    # --- primitives (JM cabac.c helpers) ---
    def _unary(self, sym, ctx0, ctx_rest):
        if sym == 0:
            self.enc.bit(ctx0, 0)
            return
        self.enc.bit(ctx0, 1)
        for _ in range(sym - 1):
            self.enc.bit(ctx_rest, 1)
        self.enc.bit(ctx_rest, 0)

    def _unary_max(self, sym, ctx0, ctx_rest, max_sym):
        if sym == 0:
            self.enc.bit(ctx0, 0)
            return
        self.enc.bit(ctx0, 1)
        for _ in range(sym - 1):
            self.enc.bit(ctx_rest, 1)
        if sym < max_sym:
            self.enc.bit(ctx_rest, 0)

    def _eg_bypass(self, sym, k):
        while sym >= (1 << k):
            self.enc.bypass(1)
            sym -= 1 << k
            k += 1
        self.enc.bypass(0)
        for i in range(k - 1, -1, -1):
            self.enc.bypass((sym >> i) & 1)

    def _ueg_mv(self, sym, ctx_base):
        """unary_exp_golomb_mv_encode (ctx offsets +1 at bin2, +1 at bin4)."""
        if sym == 0:
            self.enc.bit(ctx_base, 0)
            return
        self.enc.bit(ctx_base, 1)
        ctx = ctx_base + 1
        bin_ = 1
        l, k = sym, 1
        while True:
            l -= 1
            if l <= 0 or k >= 8:
                break
            k += 1
            self.enc.bit(ctx, 1)
            bin_ += 1
            if bin_ == 2:
                ctx += 1
            if bin_ == 3:                       # max_bin for MV
                ctx += 1
        if sym < 8:
            self.enc.bit(ctx, 0)
        else:
            self._eg_bypass(sym - 8, 3)

    def _ueg_level(self, sym, ctx):
        if sym == 0:
            self.enc.bit(ctx, 0)
            return
        self.enc.bit(ctx, 1)
        l, k = sym, 1
        while True:
            l -= 1
            if l <= 0 or k >= 13:
                break
            k += 1
            self.enc.bit(ctx, 1)
        if sym < 13:
            self.enc.bit(ctx, 0)
        else:
            self._eg_bypass(sym - 13, 0)

    # --- syntax elements ---
    def mb_skip_flag(self, c: _Common, skip: bool):
        self.enc.bit(OFF_MB_TYPE + 11 + c.skip_ctx(), 1 if skip else 0)

    def mb_type_i_slice(self, c: _Common, i16_code):
        """i16_code: None for I_4x4, else mb_type (1..24)."""
        ctx = OFF_MB_TYPE + c.itype_ctx()
        if i16_code is None:
            self.enc.bit(ctx, 0)
            return
        self.enc.bit(ctx, 1)
        self.enc.terminate0()
        self._i16_suffix(i16_code - 1, OFF_MB_TYPE + 4, OFF_MB_TYPE + 5,
                         OFF_MB_TYPE + 6, OFF_MB_TYPE + 7, OFF_MB_TYPE + 8)

    def _i16_suffix(self, mode_sym, c_ac, c_cbp0, c_cbp1, c_pm0, c_pm1):
        self.enc.bit(c_ac, mode_sym // 12)
        mode_sym %= 12
        cs = mode_sym // 4
        if cs == 0:
            self.enc.bit(c_cbp0, 0)
        else:
            self.enc.bit(c_cbp0, 1)
            self.enc.bit(c_cbp1, 1 if cs != 1 else 0)
        pm = mode_sym & 3
        self.enc.bit(c_pm0, pm >> 1)
        self.enc.bit(c_pm1, pm & 1)

    def mb_type_p_slice(self, win: int, i16_code=None):
        """win: 1..4 inter modes (16x16/16x8/8x16/P8x8); 5 = I_4x4,
        6 = I_16x16 with ``i16_code`` (1..24).  (skip flag written
        separately.)"""
        M = OFF_MB_TYPE + 11
        if win == 1:
            for ctx in (4, 5, 6):
                self.enc.bit(M + ctx, 0)
        elif win == 2:
            self.enc.bit(M + 4, 0)
            self.enc.bit(M + 5, 1)
            self.enc.bit(M + 7, 1)
        elif win == 3:
            self.enc.bit(M + 4, 0)
            self.enc.bit(M + 5, 1)
            self.enc.bit(M + 7, 0)
        elif win == 4:
            self.enc.bit(M + 4, 0)
            self.enc.bit(M + 5, 0)
            self.enc.bit(M + 6, 1)
        elif win == 5:                          # I_4x4 in P
            self.enc.bit(M + 4, 1)
            self.enc.bit(M + 7, 0)
        else:                                   # I_16x16 in P
            self.enc.bit(M + 4, 1)
            self.enc.bit(M + 7, 1)
            self.enc.terminate0()
            self._i16_suffix(i16_code - 1, M + 8, M + 9, M + 9,
                             M + 10, M + 10)

    def sub_mb_type(self, sub: int):
        B = OFF_B8_TYPE
        if sub == 0:
            self.enc.bit(B + 1, 1)
        elif sub == 1:
            self.enc.bit(B + 1, 0)
            self.enc.bit(B + 3, 0)
        elif sub == 2:
            self.enc.bit(B + 1, 0)
            self.enc.bit(B + 3, 1)
            self.enc.bit(B + 4, 1)
        else:
            self.enc.bit(B + 1, 0)
            self.enc.bit(B + 3, 1)
            self.enc.bit(B + 4, 0)

    def ref_idx(self, c: _Common, by, bx, ref: int, lst: int = 0):
        ctx = OFF_REF_NO + c.ref_ctx(by, bx, lst)
        if ref == 0:
            self.enc.bit(ctx, 0)
        else:
            self.enc.bit(ctx, 1)
            self._unary(ref - 1, OFF_REF_NO + 4, OFF_REF_NO + 5)

    def mvd(self, c: _Common, by, bx, comp, val: int, lst: int = 0):
        ctx = OFF_MV_RES + c.mvd_ctx(by, bx, comp, lst)
        a = abs(val)
        if a == 0:
            self.enc.bit(ctx, 0)
        else:
            self.enc.bit(ctx, 1)
            self._ueg_mv(a - 1, OFF_MV_RES + 10 + 5 * comp)
            self.enc.bypass(1 if val < 0 else 0)

    # ---- B-slice syntax (JM cabac.c writeMB_Bskip_flagInfo_CABAC,
    # writeMB_B_typeInfo_CABAC) ----
    def mb_skip_flag_b(self, c: _Common, skip: bool):
        """B skip bin: mb_type_contexts[2][7 + ctx]; neighbor 'skip' =
        direct-with-no-coefficients."""
        ctx = OFF_MB_TYPE + 22 + 7 + c.skip_ctx()
        self.enc.bit(ctx, 1 if skip else 0)

    def mb_type_b_slice(self, c: _Common, mb_type: int, i16_code=None):
        """B mb_type (Table 9-37): 0 direct, 1 L0_16x16, 2 L1_16x16,
        3 Bi_16x16, ..., 23 I_4x4, 23+code I_16x16."""
        B = OFF_MB_TYPE + 22
        ctx0 = B + c.b_mbtype_ctx()      # a/b: neighbor mb_type != 0
        act = mb_type if i16_code is None else 24
        if act == 0:
            self.enc.bit(ctx0, 0)
        elif act <= 2:
            self.enc.bit(ctx0, 1)
            self.enc.bit(B + 4, 0)
            self.enc.bit(B + 6, 1 if act != 1 else 0)
        elif act <= 10:
            t = act - 3
            self.enc.bit(ctx0, 1)
            self.enc.bit(B + 4, 1)
            self.enc.bit(B + 5, 0)
            self.enc.bit(B + 6, (t >> 2) & 1)
            self.enc.bit(B + 6, (t >> 1) & 1)
            self.enc.bit(B + 6, t & 1)
        elif act in (11, 22):
            self.enc.bit(ctx0, 1)
            self.enc.bit(B + 4, 1)
            self.enc.bit(B + 5, 1)
            self.enc.bit(B + 6, 1)
            self.enc.bit(B + 6, 1)
            self.enc.bit(B + 6, 1 if act != 11 else 0)
        else:
            t = act - 13 if act > 22 else act - 12
            self.enc.bit(ctx0, 1)
            self.enc.bit(B + 4, 1)
            self.enc.bit(B + 5, 1)
            self.enc.bit(B + 6, (t >> 3) & 1)
            self.enc.bit(B + 6, (t >> 2) & 1)
            self.enc.bit(B + 6, (t >> 1) & 1)
            self.enc.bit(B + 6, t & 1)
        if i16_code is not None:         # I_16x16 suffix on the P row
            M = OFF_MB_TYPE + 11
            self.enc.terminate0()
            self._i16_suffix(i16_code - 1, M + 8, M + 9, M + 9,
                             M + 10, M + 10)

    def intra_pred_mode(self, flag: int, rem: int):
        if flag:
            self.enc.bit(OFF_IPR, 1)
        else:
            self.enc.bit(OFF_IPR, 0)
            self.enc.bit(OFF_IPR + 1, rem & 1)
            self.enc.bit(OFF_IPR + 1, (rem >> 1) & 1)
            self.enc.bit(OFF_IPR + 1, (rem >> 2) & 1)

    def chroma_pred_mode(self, c: _Common, mode: int):
        ctx = OFF_CIPR + c.cipred_ctx()
        if mode == 0:
            self.enc.bit(ctx, 0)
        else:
            self.enc.bit(ctx, 1)
            self._unary_max(mode - 1, OFF_CIPR + 3, OFF_CIPR + 3, 2)

    def cbp(self, c: _Common, cbp: int):
        sofar = 0
        for b8 in range(4):
            bit = (cbp >> b8) & 1
            ctx = OFF_CBP + c.cbp_luma_ctx(b8, cbp)
            self.enc.bit(ctx, bit)
            sofar |= bit << b8
        self.enc.bit(OFF_CBP + 4 + c.cbp_chroma_ctx(False),
                     1 if cbp > 15 else 0)
        if cbp > 15:
            self.enc.bit(OFF_CBP + 8 + c.cbp_chroma_ctx(True),
                         1 if (cbp >> 4) == 2 else 0)

    def mb_qp_delta(self, c: _Common, dqp: int):
        sign = 0 if dqp <= 0 else -1
        sym = (abs(dqp) << 1) + sign
        ctx = OFF_DELTA_QP + c.dqp_ctx()
        if sym == 0:
            self.enc.bit(ctx, 0)
        else:
            self.enc.bit(ctx, 1)
            self._unary(sym - 1, OFF_DELTA_QP + 2, OFF_DELTA_QP + 3)
        self.st.last_dqp = dqp

    def transform_size_flag(self, c: _Common, flag: bool):
        """transform_size_8x8_flag (spec 9.3.3.1.1.10)."""
        self.enc.bit(OFF_TS + c.ts8_ctx(), 1 if flag else 0)
        self.st.t8[c.mby, c.mbx] = bool(flag)

    def residual_block(self, c: _Common, cat: int, zz, by=0, bx=0, comp=0):
        """coded_block_flag + significance map + levels for one block.

        zz: scan-order levels, length MAXPOS[cat]+1 (AC cats exclude the
        DC position, as in the symbol arrays)."""
        zz = np.asarray(zz)
        nz = int((zz != 0).sum())
        if cat != LUMA_8x8:
            # coded_block_flag is absent for the 8x8 luma category
            # (spec 7.4.5.3.3; the cbp bit already covers it)
            ctx = OFF_BCBP + 4 * TYPE2CTX_BCBP[cat] \
                + c.cbf_ctx(cat, by, bx, comp)
            self.enc.bit(ctx, 1 if nz else 0)
            if not nz:
                return
            c.set_cbf(cat, by, bx, comp)
        elif not nz:
            return
        mp = MAXPOS[cat]
        map_base = OFF_MAP + 15 * TYPE2CTX_MAP[cat]
        last_base = OFF_LAST + 15 * TYPE2CTX_LAST[cat]
        p2m = POS2CTX_MAP[cat]
        p2l = POS2CTX_LAST[cat]
        koff = 0 if C1ISDC[cat] else 1         # AC cats: ctx by full-scan pos
        left = nz
        for k in range(mp):                    # last position implicit
            sig = 1 if zz[k] else 0
            self.enc.bit(map_base + p2m[k + koff], sig)
            if sig:
                left -= 1
                last = 1 if left == 0 else 0
                self.enc.bit(last_base + p2l[k + koff], last)
                if last:
                    break
        one_base = OFF_ONE + 5 * TYPE2CTX_ONE[cat]
        abs_base = OFF_ABS + 5 * TYPE2CTX_ONE[cat]
        c1, c2 = 1, 0
        cnt = nz
        for i in range(mp, -1, -1):
            if cnt == 0:
                break
            v = int(zz[i]) if i < len(zz) else 0
            if v == 0:
                continue
            cnt -= 1
            a = abs(v)
            gt1 = a > 1
            self.enc.bit(one_base + min(c1, 4), 1 if gt1 else 0)
            if gt1:
                self._ueg_level(a - 2, abs_base + min(c2, MAX_C2[cat]))
                c2 += 1
                c1 = 0
            elif c1:
                c1 += 1
            self.enc.bypass(1 if v < 0 else 0)

    def end_of_slice(self, last: bool):
        if last:
            return self.enc.flush()
        self.enc.terminate0()
        return None


# ---------------------------------------------------------------------------
# Reader (mirror)
# ---------------------------------------------------------------------------

class CabacReader:
    def __init__(self, data: bytes, slice_type: int, qp: int, st: MBState,
                 cabac_init_idc: int = 0):
        self.dec = Decoder(data, num_ctx=NUM_CTX)
        self.dec.init_contexts(*init_context_arrays(slice_type,
                                                    cabac_init_idc, qp))
        self.st = st
        st.last_dqp = 0

    def _unary(self, ctx0, ctx_rest, max_sym=None):
        if self.dec.bit(ctx0) == 0:
            return 0
        n = 1
        while max_sym is None or n < max_sym:
            if self.dec.bit(ctx_rest) == 0:
                break
            n += 1
        return n

    def _eg_bypass(self, k):
        sym = 0
        while self.dec.bypass():
            sym += 1 << k
            k += 1
        for i in range(k - 1, -1, -1):
            sym += self.dec.bypass() << i
        return sym

    def _ueg_mv(self, ctx_base):
        if self.dec.bit(ctx_base) == 0:
            return 0
        ctx = ctx_base + 1
        bin_ = 1
        sym = 1
        while sym < 8:
            if self.dec.bit(ctx) == 0:
                return sym
            sym += 1
            bin_ += 1
            if bin_ == 2:
                ctx += 1
            if bin_ == 3:
                ctx += 1
        return 8 + self._eg_bypass(3)

    def _ueg_level(self, ctx):
        if self.dec.bit(ctx) == 0:
            return 0
        sym = 1
        while sym < 13:
            if self.dec.bit(ctx) == 0:
                return sym
            sym += 1
        return 13 + self._eg_bypass(0)

    def mb_skip_flag(self, c: _Common) -> bool:
        return self.dec.bit(OFF_MB_TYPE + 11 + c.skip_ctx()) == 1

    def mb_type_i_slice(self, c: _Common):
        """-> mb_type (0 = I4x4, 1..24 = I16, 25 = PCM)."""
        if self.dec.bit(OFF_MB_TYPE + c.itype_ctx()) == 0:
            return 0
        if self.dec.terminate():
            return 25
        return 1 + self._i16_suffix(OFF_MB_TYPE + 4, OFF_MB_TYPE + 5,
                                    OFF_MB_TYPE + 6, OFF_MB_TYPE + 7,
                                    OFF_MB_TYPE + 8)

    def _i16_suffix(self, c_ac, c_cbp0, c_cbp1, c_pm0, c_pm1):
        mode = 12 * self.dec.bit(c_ac)
        if self.dec.bit(c_cbp0):
            mode += 8 if self.dec.bit(c_cbp1) else 4
        mode += self.dec.bit(c_pm0) << 1
        mode += self.dec.bit(c_pm1)
        return mode

    def mb_type_p_slice(self):
        """-> (win 1..4, None) inter, or (5, None) I4, (6, code) I16,
        (7, None) PCM."""
        M = OFF_MB_TYPE + 11
        if self.dec.bit(M + 4):
            if self.dec.bit(M + 7):
                if self.dec.terminate():
                    return 7, None
                return 6, 1 + self._i16_suffix(M + 8, M + 9, M + 9,
                                               M + 10, M + 10)
            return 5, None
        if self.dec.bit(M + 5):
            return (2, None) if self.dec.bit(M + 7) else (3, None)
        return (4, None) if self.dec.bit(M + 6) else (1, None)

    def sub_mb_type(self):
        B = OFF_B8_TYPE
        if self.dec.bit(B + 1):
            return 0
        if self.dec.bit(B + 3) == 0:
            return 1
        return 2 if self.dec.bit(B + 4) else 3

    def ref_idx(self, c: _Common, by, bx, lst: int = 0):
        if self.dec.bit(OFF_REF_NO + c.ref_ctx(by, bx, lst)) == 0:
            return 0
        return 1 + self._unary(OFF_REF_NO + 4, OFF_REF_NO + 5)

    def mvd(self, c: _Common, by, bx, comp, lst: int = 0):
        if self.dec.bit(OFF_MV_RES + c.mvd_ctx(by, bx, comp, lst)) == 0:
            return 0
        a = 1 + self._ueg_mv(OFF_MV_RES + 10 + 5 * comp)
        return -a if self.dec.bypass() else a

    # ---- B-slice syntax readers (decode twins of the writers above) ----
    def mb_skip_flag_b(self, c: _Common) -> bool:
        return self.dec.bit(OFF_MB_TYPE + 22 + 7 + c.skip_ctx()) == 1

    def mb_type_b_slice(self, c: _Common):
        """-> (mb_type 0..23, None) or (24+, i16_code) or (25x PCM...):
        returns (mb_type, i16_code) where mb_type 23 = I_4x4, 24 = I16
        marker (code 1..24), 25 = PCM."""
        B = OFF_MB_TYPE + 22
        if self.dec.bit(B + c.b_mbtype_ctx()) == 0:
            return 0, None
        if self.dec.bit(B + 4) == 0:
            return 1 + self.dec.bit(B + 6), None
        if self.dec.bit(B + 5) == 0:
            t = self.dec.bit(B + 6) << 2
            t |= self.dec.bit(B + 6) << 1
            t |= self.dec.bit(B + 6)
            return 3 + t, None
        b0 = self.dec.bit(B + 6)
        b1 = self.dec.bit(B + 6)
        if b0 == 1 and b1 == 1:              # act 11 / 22
            return (22 if self.dec.bit(B + 6) else 11), None
        t = (b0 << 3) | (b1 << 2)
        t |= self.dec.bit(B + 6) << 1
        t |= self.dec.bit(B + 6)
        if t <= 9:
            return 12 + t, None
        if t == 10:
            return 23, None                  # I_4x4
        # t == 11: 16x16-intra escape
        M = OFF_MB_TYPE + 11
        if self.dec.terminate():
            return 25, None                  # PCM
        return 24, 1 + self._i16_suffix(M + 8, M + 9, M + 9,
                                        M + 10, M + 10)

    def sub_mb_type_b(self):
        """B sub_mb_type 0..12 (writeB8_B_typeInfo_CABAC twin)."""
        B = OFF_B8_TYPE + 9                  # b8_type_contexts[1]
        if self.dec.bit(B + 0) == 0:
            return 0
        if self.dec.bit(B + 1) == 0:
            return 1 + self.dec.bit(B + 3)
        if self.dec.bit(B + 2) == 0:
            t = self.dec.bit(B + 3) << 1
            t |= self.dec.bit(B + 3)
            return 3 + t
        if self.dec.bit(B + 3):
            return 7 + 4 + self.dec.bit(B + 3)      # act-1-6 has bit2 set
        t = self.dec.bit(B + 3) << 1
        t |= self.dec.bit(B + 3)
        return 7 + t

    def intra_pred_mode(self):
        """-> (prev_flag, rem)."""
        if self.dec.bit(OFF_IPR):
            return 1, 0
        rem = self.dec.bit(OFF_IPR + 1)
        rem |= self.dec.bit(OFF_IPR + 1) << 1
        rem |= self.dec.bit(OFF_IPR + 1) << 2
        return 0, rem

    def chroma_pred_mode(self, c: _Common):
        if self.dec.bit(OFF_CIPR + c.cipred_ctx()) == 0:
            return 0
        return 1 + self._unary(OFF_CIPR + 3, OFF_CIPR + 3, max_sym=2)

    def cbp(self, c: _Common):
        cbp = 0
        for b8 in range(4):
            if self.dec.bit(OFF_CBP + c.cbp_luma_ctx(b8, cbp)):
                cbp |= 1 << b8
        if self.dec.bit(OFF_CBP + 4 + c.cbp_chroma_ctx(False)):
            cbp |= (2 if self.dec.bit(OFF_CBP + 8 + c.cbp_chroma_ctx(True))
                    else 1) << 4
        return cbp

    def mb_qp_delta(self, c: _Common):
        if self.dec.bit(OFF_DELTA_QP + c.dqp_ctx()) == 0:
            self.st.last_dqp = 0
            return 0
        sym = 1 + self._unary(OFF_DELTA_QP + 2, OFF_DELTA_QP + 3)
        dqp = (sym + 1) // 2
        if sym & 1 == 0:
            dqp = -dqp
        self.st.last_dqp = dqp
        return dqp

    def transform_size_flag(self, c: _Common) -> bool:
        flag = bool(self.dec.bit(OFF_TS + c.ts8_ctx()))
        self.st.t8[c.mby, c.mbx] = flag
        return flag

    def residual_block(self, c: _Common, cat: int, by=0, bx=0, comp=0):
        """-> scan-order levels [MAXPOS[cat]+1] (AC cats exclude DC)."""
        mp = MAXPOS[cat]
        out = np.zeros(mp + 1, np.int64)
        if cat != LUMA_8x8:
            ctx = OFF_BCBP + 4 * TYPE2CTX_BCBP[cat] \
                + c.cbf_ctx(cat, by, bx, comp)
            if self.dec.bit(ctx) == 0:
                return out
            c.set_cbf(cat, by, bx, comp)
        map_base = OFF_MAP + 15 * TYPE2CTX_MAP[cat]
        last_base = OFF_LAST + 15 * TYPE2CTX_LAST[cat]
        p2m = POS2CTX_MAP[cat]
        p2l = POS2CTX_LAST[cat]
        koff = 0 if C1ISDC[cat] else 1         # AC cats: ctx by full-scan pos
        sig = np.zeros(mp + 1, bool)
        for k in range(mp):
            if self.dec.bit(map_base + p2m[k + koff]):
                sig[k] = True
                if self.dec.bit(last_base + p2l[k + koff]):
                    break
        else:
            sig[mp] = True
        one_base = OFF_ONE + 5 * TYPE2CTX_ONE[cat]
        abs_base = OFF_ABS + 5 * TYPE2CTX_ONE[cat]
        c1, c2 = 1, 0
        positions = np.flatnonzero(sig)[::-1]
        for i in positions:
            gt1 = self.dec.bit(one_base + min(c1, 4))
            if gt1:
                a = 2 + self._ueg_level(abs_base + min(c2, MAX_C2[cat]))
                c2 += 1
                c1 = 0
            else:
                a = 1
                if c1:
                    c1 += 1
            out[i] = -a if self.dec.bypass() else a
        return out

    def end_of_slice(self) -> bool:
        return self.dec.terminate() == 1
