"""8x8 transform constants and the decoder's numpy 8x8 inverse path.

The 8x8 zig-zag scan and quantizer constants shared with ``quant8_dev.py``,
and the host side the decoder runs: dequantization, the inverse8x8
butterflies of ``JM/lcommon/src/transform.c:451`` and the rounding of
``JM/ldecod/src/transform8x8.c:81`` itrans8x8, on ``[..., 8, 8]`` numpy
arrays (the same math as ``quant8_dev.py``).

The port's own copy of the decoder's part of ``h264tpu/avc/quant8.py``; the
constants it took from ``quant8_jax.py`` live here.  It imports nothing from
``h264tpu``.
"""

from __future__ import annotations

import numpy as np

from .tables8 import DEQUANT_COEF8

Q_BITS_8 = 16
OFFSET8_INTRA = 682          # Q11, same defaults as the 4x4 lists
OFFSET8_INTER = 342


def _zigzag8():
    """8x8 zig-zag scan (spec Table 8-8 / JM SNGL_SCAN8x8), raster indices."""
    order = sorted(((y, x) for y in range(8) for x in range(8)),
                   key=lambda p: (p[0] + p[1],
                                  p[1] if (p[0] + p[1]) % 2 == 0 else p[0]))
    return np.array([y * 8 + x for (y, x) in order], np.int64)


ZIGZAG8_FLAT = _zigzag8()

_V8 = np.asarray(DEQUANT_COEF8, np.int64)
_ZZ8_INV = np.argsort(ZIGZAG8_FLAT)


def _inv_1d(p):
    p = np.moveaxis(p, -1, 0)
    a0, a1 = p[0] + p[4], p[0] - p[4]
    a2, a3 = p[6] - (p[2] >> 1), p[2] + (p[6] >> 1)
    b0, b2, b4, b6 = a0 + a3, a1 - a2, a1 + a2, a0 - a3
    a0 = -p[3] + p[5] - p[7] - (p[7] >> 1)
    a1 = p[1] + p[7] - p[3] - (p[3] >> 1)
    a2 = -p[1] + p[7] + p[5] + (p[5] >> 1)
    a3 = p[3] + p[5] + p[1] + (p[1] >> 1)
    b1, b3 = a0 + (a3 >> 2), a1 + (a2 >> 2)
    b5, b7 = a2 - (a1 >> 2), a3 - (a0 >> 2)
    out = np.stack([b0 + b7, b2 - b5, b4 + b3, b6 + b1,
                    b6 - b1, b4 - b3, b2 + b5, b0 - b7])
    return np.moveaxis(out, 0, -1)


def idct8x8(w):
    w = np.asarray(w, np.int64)
    t = _inv_1d(w)
    return np.swapaxes(_inv_1d(np.swapaxes(t, -1, -2)), -1, -2)


def dequant8x8(lev, qp: int):
    per, rem = qp // 6, qp % 6
    v = (np.asarray(lev, np.int64) * (_V8[rem] << 4)) << per
    return (v + 32) >> 6


def reconstruct8(pred, iwt):
    return np.clip(pred + ((iwt + 32) >> 6), 0, 255)


def unzigzag8(zz):
    return np.asarray(zz)[..., _ZZ8_INV].reshape(*zz.shape[:-1], 8, 8)
