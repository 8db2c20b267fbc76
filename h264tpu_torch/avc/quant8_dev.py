"""8x8 integer transform and quantization on tensors (High-profile core).

Port of ``h264tpu/avc/quant8_jax.py``: JM-18.5-exact math batched over
``[..., 8, 8]`` int32 blocks — the forward/inverse butterflies of
``JM/lcommon/src/transform.c:353`` forward8x8 / ``:451`` inverse8x8, the
Q_BITS_8 = 16 quantizer of ``JM/lencod/src/quant8x8_normal.c`` with the
LevelScale8x8 tables (``avc/tables8.py``), and the decoder's ``(x + 32) >> 6``
reconstruction rounding.  Every product and shift stays in int32, as in the
JAX package (``>>`` of a negative int32 is arithmetic in both).  ``mf``/``ils``
are weighted [6, 8, 8] int32 tables of a scaling matrix on the blocks'
device; None means the flat tables.  ``qp`` is a Python int or a lane
tensor [L], as in ``quant_dev``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device_const
from .quant_dev import _per_rem
from .quant8 import Q_BITS_8, OFFSET8_INTRA, OFFSET8_INTER, ZIGZAG8_FLAT
from .tables8 import QUANT_COEF8, DEQUANT_COEF8

_MF8 = np.asarray(QUANT_COEF8, np.int32)
_V16 = np.asarray(DEQUANT_COEF8, np.int32) << 4


def _fwd_1d(p: torch.Tensor) -> torch.Tensor:
    """One forward8x8 butterfly along the last axis."""
    p0, p1, p2, p3, p4, p5, p6, p7 = p.unbind(-1)
    a0, a1, a2, a3 = p0 + p7, p1 + p6, p2 + p5, p3 + p4
    b0, b1, b2, b3 = a0 + a3, a1 + a2, a0 - a3, a1 - a2
    a0, a1, a2, a3 = p0 - p7, p1 - p6, p2 - p5, p3 - p4
    b4 = a1 + a2 + ((a0 >> 1) + a0)
    b5 = a0 - a3 - ((a2 >> 1) + a2)
    b6 = a0 + a3 - ((a1 >> 1) + a1)
    b7 = a1 - a2 + ((a3 >> 1) + a3)
    return torch.stack([b0 + b1, b4 + (b7 >> 2), b2 + (b3 >> 1),
                        b5 + (b6 >> 2), b0 - b1, b6 - (b5 >> 2),
                        (b2 >> 1) - b3, (b4 >> 2) - b7], dim=-1)


def _inv_1d(p: torch.Tensor) -> torch.Tensor:
    """One inverse8x8 butterfly along the last axis."""
    p0, p1, p2, p3, p4, p5, p6, p7 = p.unbind(-1)
    a0, a1 = p0 + p4, p0 - p4
    a2, a3 = p6 - (p2 >> 1), p2 + (p6 >> 1)
    b0, b2, b4, b6 = a0 + a3, a1 - a2, a1 + a2, a0 - a3
    a0 = -p3 + p5 - p7 - (p7 >> 1)
    a1 = p1 + p7 - p3 - (p3 >> 1)
    a2 = -p1 + p7 + p5 + (p5 >> 1)
    a3 = p3 + p5 + p1 + (p1 >> 1)
    b1, b3 = a0 + (a3 >> 2), a1 + (a2 >> 2)
    b5, b7 = a2 - (a1 >> 2), a3 - (a0 >> 2)
    return torch.stack([b0 + b7, b2 - b5, b4 + b3, b6 + b1,
                        b6 - b1, b4 - b3, b2 + b5, b0 - b7], dim=-1)


def fdct8x8(x: torch.Tensor) -> torch.Tensor:
    """forward8x8 of [..., 8, 8] residual blocks (rows, then columns)."""
    t = _fwd_1d(x.to(torch.int32))
    return _fwd_1d(t.transpose(-1, -2)).transpose(-1, -2)


def idct8x8(w: torch.Tensor) -> torch.Tensor:
    """inverse8x8 of [..., 8, 8] dequantized coefficients (no final
    rounding — see :func:`reconstruct8`)."""
    t = _inv_1d(w.to(torch.int32))
    return _inv_1d(t.transpose(-1, -2)).transpose(-1, -2)


def quant8x8(w: torch.Tensor, qp: int, intra: bool,
             offsets: torch.Tensor = None,
             mf: torch.Tensor = None) -> torch.Tensor:
    """quant_8x8_normal: level = (|w|*MF8 + off<<(qbits-11)) >> qbits with
    qbits = 16 + qp//6.  ``offsets``: Q11 rounding offsets broadcastable to
    ``w``; None = 682/342."""
    per, rem = _per_rem(qp, w, 2)
    if offsets is None:
        off = (OFFSET8_INTRA if intra else OFFSET8_INTER) << (5 + per)
    else:
        off = offsets.to(torch.int32) << (5 + per)
    m = (device_const("mf8", _MF8, w.device) if mf is None else mf)[rem]
    lev = (torch.abs(w) * m + off) >> (Q_BITS_8 + per)
    return torch.sign(w) * lev


def dequant8x8(lev: torch.Tensor, qp: int,
               ils: torch.Tensor = None) -> torch.Tensor:
    """rshift_rnd_sf((level * (V8 << 4)) << per, 6); weighted ``ils`` =
    dequant_coef8 * qmatrix (== V8 << 4 at qmatrix 16)."""
    per, rem = _per_rem(qp, lev, 2)
    v8 = (device_const("v8", _V16, lev.device) if ils is None else ils)[rem]
    return (((lev * v8) << per) + 32) >> 6


def reconstruct8(pred: torch.Tensor, iwt: torch.Tensor) -> torch.Tensor:
    """Decoder rounding: clip(pred + (inverse + 32) >> 6)."""
    return torch.clamp(pred + ((iwt + 32) >> 6), 0, 255)


def zigzag8(levels: torch.Tensor) -> torch.Tensor:
    zz = device_const("zz8", ZIGZAG8_FLAT, levels.device)
    return levels.reshape(*levels.shape[:-2], 64)[..., zz]
