"""JM-18.5-exact forward/inverse transform + quantization (numpy host model).

These are the integer recipes that make our encoder's reconstruction
BIT-EXACT with what ``ldecod`` produces from our stream:

* 4x4 AC/luma residual: JM ``forward4x4`` + ``quant_4x4_normal``
  (``JM/lencod/src/quant4x4_normal.c:31``: level = (|w|*MF + off<<(4+per))
  >> (15+per)), inverse = dequant ``lev*V<<per`` + spec idct + (x+32)>>6
  (identical to ``ops/transform.py``; re-expressed here in numpy since the
  conformance model runs per-MB on host).
* Intra-16x16 luma DC: forward 4x4 Hadamard with >>1
  (``JM/lcommon/src/transform.c`` hadamard4x4), quant with q_bits+1 and
  doubled offset (``quant_dc4x4_normal``, quant4x4_normal.c:200), inverse
  Hadamard (no shift) then ``rshift_rnd_sf((m*V*16)<<per, 6)``
  (``JM/ldecod/src/block.c:353`` itrans_2).
* Chroma DC (4:2:0): 2x2 Hadamard sums, quant like luma DC
  (``quant_dc2x2_normal``, quantChroma_normal.c), inverse 2x2 Hadamard then
  ``((t*V*16)<<per)>>5`` (``JM/ldecod/src/read_comp_cavlc.c:1580`` area).

All arrays are int64 numpy; block shape [..., 4, 4].

The port's own copy of ``h264tpu/avc/quant.py``; it imports nothing from ``h264tpu``.
"""

from __future__ import annotations

import numpy as np

from ..ops.transform import (CF, QUANT_COEF, DEQUANT_COEF, ZIGZAG_FLAT,
                             ZIGZAG_INV, _QP_SCALE_CR_TAIL)

Q_BITS = 15
OFFSET_INTRA = 682        # JM Offset_intra_default_* (q_offsets.c:60), /3 in Q11
OFFSET_INTER = 342
CAVLC_LEVEL_LIMIT = 2063  # JM defines.h:99

H4 = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]],
              np.int64)
CF64 = CF.astype(np.int64)


def chroma_qp(qp: int, offset: int = 0) -> int:
    q = min(max(qp + offset, 0), 51)
    return int(q if q < 30 else _QP_SCALE_CR_TAIL[q - 30])


def fdct4x4(x: np.ndarray) -> np.ndarray:
    return np.einsum("ij,...jk,lk->...il", CF64, x.astype(np.int64), CF64)


def quant4x4(w: np.ndarray, qp: int, intra: bool) -> np.ndarray:
    per, rem = qp // 6, qp % 6
    off = (OFFSET_INTRA if intra else OFFSET_INTER) << (4 + per)
    mf = QUANT_COEF[rem].astype(np.int64)
    lev = (np.abs(w) * mf + off) >> (Q_BITS + per)
    lev = np.minimum(lev, CAVLC_LEVEL_LIMIT)
    return np.sign(w) * lev


def dequant4x4(lev: np.ndarray, qp: int) -> np.ndarray:
    per, rem = qp // 6, qp % 6
    return (lev * DEQUANT_COEF[rem].astype(np.int64)) << per


def idct4x4(w: np.ndarray) -> np.ndarray:
    """Spec inverse 4x4 butterflies (>>1 stages), no final normalization."""
    w = w.astype(np.int64)

    def stage(m):
        m0, m1, m2, m3 = m[..., 0], m[..., 1], m[..., 2], m[..., 3]
        a, b = m0 + m2, m0 - m2
        c = (m1 >> 1) - m3
        d = m1 + (m3 >> 1)
        return np.stack([a + d, b + c, b - c, a - d], axis=-1)

    # spec 8.5.12.2 order: rows first, then columns.  With truncating
    # >>1 stages the order is observable whenever cof values are odd
    # (weighted dequant / qp<6); JM (ldecod transform.c inverse4x4)
    # matches only rows-first.
    t = stage(w)
    return np.swapaxes(stage(np.swapaxes(t, -1, -2)), -1, -2)


def reconstruct(pred: np.ndarray, idct_out: np.ndarray) -> np.ndarray:
    return np.clip(pred.astype(np.int64) + ((idct_out + 32) >> 6), 0, 255)


def zigzag(levels: np.ndarray) -> np.ndarray:
    """[..., 4, 4] raster -> [..., 16] zig-zag scan."""
    return levels.reshape(*levels.shape[:-2], 16)[..., ZIGZAG_FLAT]


def unzigzag(zz: np.ndarray) -> np.ndarray:
    return zz[..., ZIGZAG_INV].reshape(*zz.shape[:-1], 4, 4)


# ---------------------------------------------------------------------------
# Intra-16x16 luma DC path
# ---------------------------------------------------------------------------

def hadamard4x4_fwd(dc: np.ndarray) -> np.ndarray:
    """JM 18.5 forward Hadamard: 2-D butterflies then arithmetic >>1."""
    t = np.einsum("ij,...jk,lk->...il", H4, dc.astype(np.int64), H4)
    return t >> 1


def quant_dc16(h: np.ndarray, qp: int) -> np.ndarray:
    """Quantize the Hadamard-domain 16 luma DC coefficients (intra)."""
    per, rem = qp // 6, qp % 6
    mf = int(QUANT_COEF[rem][0][0])
    off = OFFSET_INTRA << (4 + per)
    lev = (np.abs(h) * mf + (off << 1)) >> (Q_BITS + per + 1)
    lev = np.minimum(lev, CAVLC_LEVEL_LIMIT)
    return np.sign(h) * lev


def dequant_dc16(lev: np.ndarray, qp: int) -> np.ndarray:
    """Decoder-side inverse: ihadamard (no shift) then rounded scaling."""
    per, rem = qp // 6, qp % 6
    m6 = np.einsum("ij,...jk,lk->...il", H4, lev.astype(np.int64), H4)
    v16 = int(DEQUANT_COEF[rem][0][0]) * 16
    return ((m6 * v16 << per) + 32) >> 6


# ---------------------------------------------------------------------------
# Chroma DC (4:2:0) path
# ---------------------------------------------------------------------------

def hadamard2x2_fwd(dc: np.ndarray) -> np.ndarray:
    """dc [..., 2, 2] -> [..., 4] in the coding scan order (raster):
    [s00+s01+s10+s11, s00-s01+s10-s11, s00+s01-s10-s11, s00-s01-s10+s11]."""
    d = dc.astype(np.int64)
    a, b, c, e = d[..., 0, 0], d[..., 0, 1], d[..., 1, 0], d[..., 1, 1]
    return np.stack([a + b + c + e, a - b + c - e, a + b - c - e,
                     a - b - c + e], axis=-1)


def quant_dc_chroma(h: np.ndarray, qpc: int, intra: bool) -> np.ndarray:
    per, rem = qpc // 6, qpc % 6
    mf = int(QUANT_COEF[rem][0][0])
    off = (OFFSET_INTRA if intra else OFFSET_INTER) << (4 + per)
    lev = (np.abs(h) * mf + (off << 1)) >> (Q_BITS + per + 1)
    lev = np.minimum(lev, CAVLC_LEVEL_LIMIT)
    return np.sign(h) * lev


def dequant_dc_chroma(lev: np.ndarray, qpc: int) -> np.ndarray:
    """[..., 4] levels -> [..., 2, 2] dequantized DC per 4x4 sub-block."""
    per, rem = qpc // 6, qpc % 6
    l0, l1, l2, l3 = (lev[..., i].astype(np.int64) for i in range(4))
    t = np.stack([l0 + l1 + l2 + l3, l0 - l1 + l2 - l3,
                  l0 + l1 - l2 - l3, l0 - l1 - l2 + l3], axis=-1)
    v16 = int(DEQUANT_COEF[rem][0][0]) * 16
    out = ((t * v16) << per) >> 5
    return out.reshape(*lev.shape[:-1], 2, 2)
