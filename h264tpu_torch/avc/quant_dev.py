"""JM-18.5-exact forward/inverse transform and quantization on tensors.

Port of ``h264tpu/avc/quant_jax.py`` (the device twin of the host model
``avc/quant.py``), batched over ``[..., 4, 4]`` int32 blocks.  ``qp`` is a
Python int, or an int32 tensor [L] of one QP per lane over the leading axis of
the blocks (rate control's per-slice QP): the shifts broadcast and the
tables are gathered per lane (:func:`_lanes`).  The conformant path uses the JM 18.5
rounding offsets 682/342 in Q11 and the CAVLC level clamp; ``offsets`` carries
the JVT-N011 adaptive-rounding state instead, broadcast against the blocks.
``mf``/``ils`` carry the High-profile weighted LevelScale / InvLevelScale
tables [6, 4, 4] of a scaling matrix (``qmatrix.enc_tables_default``) as
int32 tensors on the blocks' device; None means the flat tables.
The 4x4 Hadamards are butterflies: CUDA has no int32 matrix product.
"""

from __future__ import annotations

import torch

from .. import device_const
from ..ops.transform import (QUANT_COEF, DEQUANT_COEF, ZIGZAG_FLAT,
                             ZIGZAG_INV, chroma_qp, fdct4x4, idct4x4,
                             reconstruct)  # noqa: F401  (re-exported)

Q_BITS = 15
OFFSET_INTRA = 682
OFFSET_INTER = 342
CAVLC_LEVEL_LIMIT = 2063
AR_WEIGHT = 8          # JM AdaptRndWeight default
AR_RANGE = 1024        # 1 << (OffsetBits - 1)


def _lanes(qp, nd: int):
    """``qp`` shaped to broadcast over ``nd`` dims: an int stays an int, a
    lane tensor [L] gains ``nd - 1`` trailing unit dims."""
    if isinstance(qp, torch.Tensor):
        return qp.reshape(qp.shape + (1,) * (nd - qp.dim()))
    return qp


def _per_rem(qp, x: torch.Tensor, block: int):
    """(qp // 6 broadcasting against ``x``, qp % 6 broadcasting against the
    leading dims of ``x`` without its ``block`` trailing block dims) — the
    remainder indexes a [6, ...] table so that its rows line up with
    ``x``."""
    return _lanes(qp, x.dim()) // 6, _lanes(qp, x.dim() - block) % 6


def _quant_coef(device) -> torch.Tensor:
    return device_const("quant_coef", QUANT_COEF, device)


def _dequant_coef(device) -> torch.Tensor:
    return device_const("dequant_coef", DEQUANT_COEF, device)


def quant4x4(w: torch.Tensor, qp: int, intra: bool,
             offsets: torch.Tensor = None,
             mf: torch.Tensor = None) -> torch.Tensor:
    """Signed levels of [..., 4, 4] coefficients.  ``offsets``: Q11 rounding
    offsets broadcastable to ``w`` (adaptive rounding); None = 682/342."""
    per, rem = _per_rem(qp, w, 2)
    if offsets is None:
        off = (OFFSET_INTRA if intra else OFFSET_INTER) << (4 + per)
    else:
        off = offsets.to(torch.int32) << (4 + per)
    m = (_quant_coef(w.device) if mf is None else mf)[rem]
    lev = (torch.abs(w) * m + off) >> (Q_BITS + per)
    lev = torch.clamp(lev, max=CAVLC_LEVEL_LIMIT)
    return torch.sign(w) * lev


def ar_fadjust(w: torch.Tensor, lev: torch.Tensor, qp: int,
               mf: torch.Tensor = None) -> torch.Tensor:
    """JVT-N011 per-position rounding adjustment (quant4x4_around.c:96):
    ``(W * (scaled - (|level| << q_bits)) + (1 << q_bits)) >> (q_bits + 1)``
    where the coefficient quantized to a nonzero level, else 0."""
    per, rem = _per_rem(qp, w, 2)
    qbits = Q_BITS + per
    la = torch.abs(lev)
    scaled = torch.abs(w) * (_quant_coef(w.device) if mf is None else mf)[rem]
    adj = (AR_WEIGHT * (scaled - (la << qbits)) + (1 << qbits)) >> (qbits + 1)
    return torch.where((w != 0) & (la != 0), adj, 0)


def dequant4x4(lev: torch.Tensor, qp: int,
               ils: torch.Tensor = None) -> torch.Tensor:
    """Flat: (lev * V) << per.  Weighted (``ils`` = dequant_coef *
    qmatrix): ((lev * ILS) << per + 8) >> 4, the same at qmatrix 16."""
    per, rem = _per_rem(qp, lev, 2)
    if ils is None:
        return (lev * _dequant_coef(lev.device)[rem]) << per
    return (((lev * ils[rem]) << per) + 8) >> 4


def zigzag(levels: torch.Tensor) -> torch.Tensor:
    zz = device_const("zz", ZIGZAG_FLAT, levels.device)
    return levels.reshape(*levels.shape[:-2], 16)[..., zz]


def unzigzag(zz: torch.Tensor) -> torch.Tensor:
    inv = device_const("zzinv", ZIGZAG_INV, zz.device)
    return zz[..., inv].reshape(*zz.shape[:-1], 4, 4)


def _h4_stage(m: torch.Tensor) -> torch.Tensor:
    """Rows of H4 = [[1,1,1,1],[1,1,-1,-1],[1,-1,-1,1],[1,-1,1,-1]] applied
    along the last axis."""
    m0, m1, m2, m3 = m.unbind(-1)
    s01, s23, d01, d23 = m0 + m1, m2 + m3, m0 - m1, m2 - m3
    return torch.stack([s01 + s23, s01 - s23, d01 - d23, d01 + d23], dim=-1)


def _h4(x: torch.Tensor) -> torch.Tensor:
    """H4 @ X @ H4^T over [..., 4, 4]."""
    t = _h4_stage(x.to(torch.int32))
    return _h4_stage(t.transpose(-1, -2)).transpose(-1, -2)


def hadamard4x4_fwd(dc: torch.Tensor) -> torch.Tensor:
    return _h4(dc) >> 1


def quant_dc16(h: torch.Tensor, qp: int,
               mf4: torch.Tensor = None) -> torch.Tensor:
    per, rem = _per_rem(qp, h, 0)
    mf = (_quant_coef(h.device) if mf4 is None else mf4)[rem, 0, 0]
    off = OFFSET_INTRA << (4 + per)
    lev = (torch.abs(h) * mf + (off << 1)) >> (Q_BITS + per + 1)
    return torch.sign(h) * torch.clamp(lev, max=CAVLC_LEVEL_LIMIT)


def dequant_dc16(lev: torch.Tensor, qp: int,
                 ils: torch.Tensor = None) -> torch.Tensor:
    per, rem = _per_rem(qp, lev, 0)
    v16 = _dequant_coef(lev.device)[rem, 0, 0] * 16 if ils is None \
        else ils[rem, 0, 0]
    return (((_h4(lev) * v16) << per) + 32) >> 6


def hadamard2x2_fwd(dc: torch.Tensor) -> torch.Tensor:
    """dc [..., 2, 2] -> [..., 4] in coding order."""
    d = dc.to(torch.int32)
    a, b, c, e = d[..., 0, 0], d[..., 0, 1], d[..., 1, 0], d[..., 1, 1]
    return torch.stack([a + b + c + e, a - b + c - e, a + b - c - e,
                        a - b - c + e], dim=-1)


def quant_dc_chroma(h: torch.Tensor, qpc: int, intra: bool,
                    mf4: torch.Tensor = None) -> torch.Tensor:
    per, rem = _per_rem(qpc, h, 0)
    mf = (_quant_coef(h.device) if mf4 is None else mf4)[rem, 0, 0]
    off = (OFFSET_INTRA if intra else OFFSET_INTER) << (4 + per)
    lev = (torch.abs(h) * mf + (off << 1)) >> (Q_BITS + per + 1)
    return torch.sign(h) * torch.clamp(lev, max=CAVLC_LEVEL_LIMIT)


def dequant_dc_chroma(lev: torch.Tensor, qpc: int,
                      ils: torch.Tensor = None) -> torch.Tensor:
    """[..., 4] levels -> [..., 2, 2] dequantized DC."""
    per, rem = _per_rem(qpc, lev, 0)
    l0, l1, l2, l3 = lev.to(torch.int32).unbind(-1)
    t = torch.stack([l0 + l1 + l2 + l3, l0 - l1 + l2 - l3,
                     l0 + l1 - l2 - l3, l0 - l1 - l2 + l3], dim=-1)
    v16 = _dequant_coef(lev.device)[rem, 0, 0] * 16 if ils is None \
        else ils[rem, 0, 0]
    return (((t * v16) << per) >> 5).reshape(*lev.shape[:-1], 2, 2)

