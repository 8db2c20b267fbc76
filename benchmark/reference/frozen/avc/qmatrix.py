"""Scaling lists (q-matrix) for High-profile dequantization.

Spec 7.3.2.1.1.1 scaling_list() parse (zig-zag transmitted, raster
stored), Table 7-2 fall-back rules A (SPS) / B (PPS over SPS), and the
spec default matrices (Tables 7-3/7-4; identical constants in
``JM/ldecod/src/quant.c:26``).  The resolved output is the 8-entry
qmatrix of 4:2:0 decoding: lists 0-5 are 4x4 (IntraY, IntraCb, IntraCr,
InterY, InterCb, InterCr), 6/7 are 8x8 (IntraY, InterY).  Weighted
dequantization uses JM's InvLevelScale = dequant_coef * qmatrix with
``rshift_rnd_sf`` rounding (ldecod read_comp_cavlc.c / transform8x8.c).

The port's own copy of ``h264tpu/avc/qmatrix.py``: the encoder tables are
numpy int32 arrays, which the device encoder uploads once per device.  It
imports nothing from ``h264tpu``.
"""

from __future__ import annotations

import numpy as np

from ..ops.transform import ZIGZAG_FLAT
from .quant8 import ZIGZAG8_FLAT

FLAT16_4 = np.full((4, 4), 16, np.int64)
FLAT16_8 = np.full((8, 8), 16, np.int64)

DEFAULT_4x4_INTRA = np.array(
    [6, 13, 20, 28, 13, 20, 28, 32, 20, 28, 32, 37, 28, 32, 37, 42],
    np.int64).reshape(4, 4)
DEFAULT_4x4_INTER = np.array(
    [10, 14, 20, 24, 14, 20, 24, 27, 20, 24, 27, 30, 24, 27, 30, 34],
    np.int64).reshape(4, 4)
DEFAULT_8x8_INTRA = np.array(
    [6, 10, 13, 16, 18, 23, 25, 27,
     10, 11, 16, 18, 23, 25, 27, 29,
     13, 16, 18, 23, 25, 27, 29, 31,
     16, 18, 23, 25, 27, 29, 31, 33,
     18, 23, 25, 27, 29, 31, 33, 36,
     23, 25, 27, 29, 31, 33, 36, 38,
     25, 27, 29, 31, 33, 36, 38, 40,
     27, 29, 31, 33, 36, 38, 40, 42], np.int64).reshape(8, 8)
DEFAULT_8x8_INTER = np.array(
    [9, 13, 15, 17, 19, 21, 22, 24,
     13, 13, 17, 19, 21, 22, 24, 25,
     15, 17, 19, 21, 22, 24, 25, 27,
     17, 19, 21, 22, 24, 25, 27, 28,
     19, 21, 22, 24, 25, 27, 28, 30,
     21, 22, 24, 25, 27, 28, 30, 32,
     22, 24, 25, 27, 28, 30, 32, 33,
     24, 25, 27, 28, 30, 32, 33, 35], np.int64).reshape(8, 8)


def read_scaling_list(r, size: int):
    """scaling_list() (spec 7.3.2.1.1.1) -> (raster values, use_default).
    ``r``: BitReader positioned at the first delta_scale."""
    scan = ZIGZAG_FLAT if size == 16 else ZIGZAG8_FLAT
    vals = np.zeros(size, np.int64)
    last, nxt = 8, 8
    use_default = False
    for j in range(size):
        scanj = int(scan[j])
        if nxt != 0:
            delta = r.se()
            nxt = (last + delta + 256) % 256
            if scanj == 0 and nxt == 0:
                use_default = True
        vals[scanj] = last if nxt == 0 else nxt
        last = int(vals[scanj])
    n = 4 if size == 16 else 8
    return vals.reshape(n, n), use_default


def parse_scaling_block(r, n_lists: int):
    """The seq/pic scaling-matrix block: per-list present flag +
    scaling_list().  Returns (present [n], lists [n or None],
    use_default [n])."""
    present, lists, usedef = [], [], []
    for i in range(n_lists):
        pres = bool(r.u(1))
        present.append(pres)
        if pres:
            vals, ud = read_scaling_list(r, 16 if i < 6 else 64)
            lists.append(vals)
            usedef.append(ud)
        else:
            lists.append(None)
            usedef.append(False)
    return present, lists, usedef


def _resolve_sps(present, lists, usedef):
    """Table 7-2 fall-back rule A (SPS level)."""
    out = [None] * len(present)
    for i in range(len(present)):
        d_intra = DEFAULT_4x4_INTRA if i < 6 else DEFAULT_8x8_INTRA
        d_inter = DEFAULT_4x4_INTER if i < 6 else DEFAULT_8x8_INTER
        if not present[i]:
            if i == 0:
                out[i] = DEFAULT_4x4_INTRA
            elif i == 3:
                out[i] = DEFAULT_4x4_INTER
            elif i == 6:
                out[i] = DEFAULT_8x8_INTRA
            elif i == 7:
                out[i] = DEFAULT_8x8_INTER
            else:
                out[i] = out[i - 1]
        elif usedef[i]:
            out[i] = d_intra if (i < 3 or i == 6) else d_inter
        else:
            out[i] = lists[i]
    return out


def resolve_qmatrix(seq, pic):
    """seq/pic: None or (present, lists, usedef) tuples (8 lists for
    4:2:0).  Returns the resolved 8-entry qmatrix, or None when both are
    absent (flat — the fast unweighted dequant paths apply)."""
    if seq is None and pic is None:
        return None
    if seq is not None:
        base = _resolve_sps(seq[0], seq[1], seq[2])
    else:
        base = [FLAT16_4] * 6 + [FLAT16_8] * 2
    if pic is not None:
        # rule B: PPS lists fall back to the SPS-resolved ones, except
        # i==0/3/6/7 when the SPS matrix is absent entirely
        pres, lists, usedef = pic
        out = list(base)
        for i in range(len(pres)):
            d_intra = DEFAULT_4x4_INTRA if i < 6 else DEFAULT_8x8_INTRA
            d_inter = DEFAULT_4x4_INTER if i < 6 else DEFAULT_8x8_INTER
            if not pres[i]:
                if seq is None:
                    if i == 0:
                        out[i] = DEFAULT_4x4_INTRA
                    elif i == 3:
                        out[i] = DEFAULT_4x4_INTER
                    elif i == 6:
                        out[i] = DEFAULT_8x8_INTRA
                    elif i == 7:
                        out[i] = DEFAULT_8x8_INTER
                    elif i not in (0, 3, 6, 7):
                        out[i] = out[i - 1]
                # else: SPS-resolved entry stands
            elif usedef[i]:
                intra = (i < 3) or i == 6
                out[i] = d_intra if intra else d_inter
            else:
                out[i] = lists[i]
        return out
    return base


def enc_tables_default():
    """Device-encoder tables for the spec DEFAULT matrices: per list,
    MF = (quant_coef << 4) // qmatrix (JM lencod q_matrix.c LevelScale)
    and ILS = dequant_coef * qmatrix (ldecod InvLevelScale), as int32 numpy
    arrays [6, n, n].  The default Cb/Cr lists equal the luma ones (Table
    7-2), so only the intra/inter split matters."""
    from .quant import QUANT_COEF, DEQUANT_COEF
    from .tables8 import QUANT_COEF8, DEQUANT_COEF8

    def tab(quant, dequant, qm):
        q = np.asarray(quant, np.int64)
        return dict(mf=((q << 4) // qm).astype(np.int32),
                    ils=(np.asarray(dequant, np.int64) * qm).astype(np.int32))

    return dict(i4=tab(QUANT_COEF, DEQUANT_COEF, DEFAULT_4x4_INTRA),
                p4=tab(QUANT_COEF, DEQUANT_COEF, DEFAULT_4x4_INTER),
                i8=tab(QUANT_COEF8, DEQUANT_COEF8, DEFAULT_8x8_INTRA),
                p8=tab(QUANT_COEF8, DEQUANT_COEF8, DEFAULT_8x8_INTER))


# ---------------------------------------------------------------------------
# Weighted dequantization (JM InvLevelScale semantics)
# ---------------------------------------------------------------------------

def dequant4x4_w(lev, qp: int, weight):
    """rshift_rnd_sf((lev * dequant_coef * weight) << per, 4)."""
    from .quant import DEQUANT_COEF
    per, rem = qp // 6, qp % 6
    ils = DEQUANT_COEF[rem].astype(np.int64) * weight
    return ((np.asarray(lev, np.int64) * ils << per) + 8) >> 4


def dequant_dc16_w(lev, qp: int, weight):
    """Intra-16x16 DC with a weighted [0][0] scale (ldecod itrans_2)."""
    from .quant import DEQUANT_COEF, H4
    per, rem = qp // 6, qp % 6
    m6 = np.einsum("ij,...jk,lk->...il", H4, np.asarray(lev, np.int64), H4)
    v = int(DEQUANT_COEF[rem][0][0]) * int(weight[0, 0])
    return ((m6 * v << per) + 32) >> 6


def dequant_dc_chroma_w(lev, qpc: int, weight):
    from .quant import DEQUANT_COEF
    per, rem = qpc // 6, qpc % 6
    lev = np.asarray(lev, np.int64)
    l0, l1, l2, l3 = (lev[..., i] for i in range(4))
    t = np.stack([l0 + l1 + l2 + l3, l0 - l1 + l2 - l3,
                  l0 + l1 - l2 - l3, l0 - l1 - l2 + l3], axis=-1)
    v = int(DEQUANT_COEF[rem][0][0]) * int(weight[0, 0])
    out = ((t * v) << per) >> 5
    return out.reshape(*lev.shape[:-1], 2, 2)


def dequant8x8_w(lev, qp: int, weight):
    from .tables8 import DEQUANT_COEF8
    per, rem = qp // 6, qp % 6
    ils = np.asarray(DEQUANT_COEF8, np.int64)[rem] * weight
    v = (np.asarray(lev, np.int64) * ils) << per
    return (v + 32) >> 6
