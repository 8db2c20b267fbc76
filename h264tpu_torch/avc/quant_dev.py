"""JM-18.5-exact forward/inverse transform and quantization on tensors.

Port of ``h264tpu/avc/quant_jax.py`` (the device twin of the host model
``avc/quant.py``), batched over ``[..., 4, 4]`` int32 blocks.  QP is a Python
int (the port has no rate control).  The conformant path uses the JM 18.5
rounding offsets 682/342 in Q11 and the CAVLC level clamp; ``offsets`` carries
the JVT-N011 adaptive-rounding state instead, broadcast against the blocks.
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


def _mf(rem: int, device) -> torch.Tensor:
    return device_const(f"mf{rem}", QUANT_COEF[rem], device)


def quant4x4(w: torch.Tensor, qp: int, intra: bool,
             offsets: torch.Tensor = None) -> torch.Tensor:
    """Signed levels of [..., 4, 4] coefficients.  ``offsets``: Q11 rounding
    offsets broadcastable to ``w`` (adaptive rounding); None = 682/342."""
    per, rem = qp // 6, qp % 6
    if offsets is None:
        off = (OFFSET_INTRA if intra else OFFSET_INTER) << (4 + per)
    else:
        off = offsets.to(torch.int32) << (4 + per)
    lev = (torch.abs(w) * _mf(rem, w.device) + off) >> (Q_BITS + per)
    lev = torch.clamp(lev, max=CAVLC_LEVEL_LIMIT)
    return torch.sign(w) * lev


def ar_fadjust(w: torch.Tensor, lev: torch.Tensor, qp: int) -> torch.Tensor:
    """JVT-N011 per-position rounding adjustment (quant4x4_around.c:96):
    ``(W * (scaled - (|level| << q_bits)) + (1 << q_bits)) >> (q_bits + 1)``
    where the coefficient quantized to a nonzero level, else 0."""
    per, rem = qp // 6, qp % 6
    qbits = Q_BITS + per
    la = torch.abs(lev)
    scaled = torch.abs(w) * _mf(rem, w.device)
    adj = (AR_WEIGHT * (scaled - (la << qbits)) + (1 << qbits)) >> (qbits + 1)
    return torch.where((w != 0) & (la != 0), adj, 0)


def dequant4x4(lev: torch.Tensor, qp: int) -> torch.Tensor:
    v = device_const(f"v{qp % 6}", DEQUANT_COEF[qp % 6], lev.device)
    return (lev * v) << (qp // 6)


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


def quant_dc16(h: torch.Tensor, qp: int) -> torch.Tensor:
    per, rem = qp // 6, qp % 6
    mf = int(QUANT_COEF[rem, 0, 0])
    off = OFFSET_INTRA << (4 + per)
    lev = (torch.abs(h) * mf + (off << 1)) >> (Q_BITS + per + 1)
    return torch.sign(h) * torch.clamp(lev, max=CAVLC_LEVEL_LIMIT)


def dequant_dc16(lev: torch.Tensor, qp: int) -> torch.Tensor:
    per, rem = qp // 6, qp % 6
    v16 = int(DEQUANT_COEF[rem, 0, 0]) * 16
    return (((_h4(lev) * v16) << per) + 32) >> 6


def hadamard2x2_fwd(dc: torch.Tensor) -> torch.Tensor:
    """dc [..., 2, 2] -> [..., 4] in coding order."""
    d = dc.to(torch.int32)
    a, b, c, e = d[..., 0, 0], d[..., 0, 1], d[..., 1, 0], d[..., 1, 1]
    return torch.stack([a + b + c + e, a - b + c - e, a + b - c - e,
                        a - b - c + e], dim=-1)


def quant_dc_chroma(h: torch.Tensor, qpc: int, intra: bool) -> torch.Tensor:
    per, rem = qpc // 6, qpc % 6
    mf = int(QUANT_COEF[rem, 0, 0])
    off = (OFFSET_INTRA if intra else OFFSET_INTER) << (4 + per)
    lev = (torch.abs(h) * mf + (off << 1)) >> (Q_BITS + per + 1)
    return torch.sign(h) * torch.clamp(lev, max=CAVLC_LEVEL_LIMIT)


def dequant_dc_chroma(lev: torch.Tensor, qpc: int) -> torch.Tensor:
    """[..., 4] levels -> [..., 2, 2] dequantized DC."""
    per, rem = qpc // 6, qpc % 6
    l0, l1, l2, l3 = lev.to(torch.int32).unbind(-1)
    t = torch.stack([l0 + l1 + l2 + l3, l0 - l1 + l2 - l3,
                     l0 + l1 - l2 - l3, l0 - l1 - l2 + l3], dim=-1)
    v16 = int(DEQUANT_COEF[rem, 0, 0]) * 16
    return (((t * v16) << per) >> 5).reshape(*lev.shape[:-1], 2, 2)

