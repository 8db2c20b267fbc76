"""H.264 4x4 integer transform + quantization on int32 tensors.

Port of ``h264tpu/ops/transform.py``: the same bit-exact JM 8.6 kernels
(``FR/src/block.c:836`` dct_luma, quant tables ``FR/src/block.c:60-76``) as
batched ``[..., 4, 4]`` int32 tensor ops.  The forward core is written as
butterflies rather than a matrix product because CUDA has no int32 matmul.
``qp`` is a Python int throughout (the port has no rate control yet).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device_const

# Forward core matrix Cf (H.264 spec 8.6.2); ``_fwd_stage`` is its butterfly.
CF = np.array(
    [[1, 1, 1, 1],
     [2, 1, -1, -2],
     [1, -1, -1, 1],
     [1, -2, 2, -1]], dtype=np.int32)

# Quantization multiplier table MF[qp%6][i][j] (FR/src/block.c:60).
QUANT_COEF = np.array([
    [[13107, 8066, 13107, 8066], [8066, 5243, 8066, 5243],
     [13107, 8066, 13107, 8066], [8066, 5243, 8066, 5243]],
    [[11916, 7490, 11916, 7490], [7490, 4660, 7490, 4660],
     [11916, 7490, 11916, 7490], [7490, 4660, 7490, 4660]],
    [[10082, 6554, 10082, 6554], [6554, 4194, 6554, 4194],
     [10082, 6554, 10082, 6554], [6554, 4194, 6554, 4194]],
    [[9362, 5825, 9362, 5825], [5825, 3647, 5825, 3647],
     [9362, 5825, 9362, 5825], [5825, 3647, 5825, 3647]],
    [[8192, 5243, 8192, 5243], [5243, 3355, 5243, 3355],
     [8192, 5243, 8192, 5243], [5243, 3355, 5243, 3355]],
    [[7282, 4559, 7282, 4559], [4559, 2893, 4559, 2893],
     [7282, 4559, 7282, 4559], [4559, 2893, 4559, 2893]],
], dtype=np.int32)

# Dequantization table V[qp%6][i][j] (FR/src/block.c:69).
DEQUANT_COEF = np.array([
    [[10, 13, 10, 13], [13, 16, 13, 16], [10, 13, 10, 13], [13, 16, 13, 16]],
    [[11, 14, 11, 14], [14, 18, 14, 18], [11, 14, 11, 14], [14, 18, 14, 18]],
    [[13, 16, 13, 16], [16, 20, 16, 20], [13, 16, 13, 16], [16, 20, 16, 20]],
    [[14, 18, 14, 18], [18, 23, 18, 23], [14, 18, 14, 18], [18, 23, 18, 23]],
    [[16, 20, 16, 20], [20, 25, 20, 25], [16, 20, 16, 20], [20, 25, 20, 25]],
    [[18, 23, 18, 23], [23, 29, 23, 29], [18, 23, 18, 23], [23, 29, 23, 29]],
], dtype=np.int32)

Q_BITS = 15
DQ_BITS = 6
DQ_ROUND = 1 << (DQ_BITS - 1)

# Zig-zag scan (row, col) order for frame coding (JM SNGL_SCAN).
ZIGZAG_4x4 = np.array(
    [(0, 0), (0, 1), (1, 0), (2, 0), (1, 1), (0, 2), (0, 3), (1, 2),
     (2, 1), (3, 0), (3, 1), (2, 2), (1, 3), (2, 3), (3, 2), (3, 3)],
    dtype=np.int32)
ZIGZAG_FLAT = (ZIGZAG_4x4[:, 0] * 4 + ZIGZAG_4x4[:, 1]).astype(np.int64)
ZIGZAG_INV = np.argsort(ZIGZAG_FLAT).astype(np.int64)


def _fwd_stage(m: torch.Tensor) -> torch.Tensor:
    """Rows of Cf applied along the last axis (Cf = [[1,1,1,1],[2,1,-1,-2],
    [1,-1,-1,1],[1,-2,2,-1]])."""
    m0, m1, m2, m3 = m.unbind(-1)
    s03, d03 = m0 + m3, m0 - m3
    s12, d12 = m1 + m2, m1 - m2
    return torch.stack([s03 + s12, 2 * d03 + d12, s03 - s12, d03 - 2 * d12],
                       dim=-1)


def fdct4x4(x: torch.Tensor) -> torch.Tensor:
    """Forward 4x4 integer transform W = Cf @ X @ Cf^T over [..., 4, 4]."""
    t = _fwd_stage(x.to(torch.int32))                         # X @ Cf^T
    return _fwd_stage(t.transpose(-1, -2)).transpose(-1, -2)  # Cf @ (.)


def quant4x4(w: torch.Tensor, qp: int) -> torch.Tensor:
    """``level = sign(w) * ((|w| * MF[qp%6] + (1<<q_bits)/3) >> q_bits)``
    (the reference uses the /3 constant for intra and inter alike)."""
    qp_per, qp_rem = qp // 6, qp % 6
    q_bits = Q_BITS + qp_per
    qp_const = (1 << q_bits) // 3
    mf = device_const(f"mf{qp_rem}", QUANT_COEF[qp_rem], w.device)
    lev = (torch.abs(w) * mf + qp_const) >> q_bits
    return torch.sign(w) * lev


def dequant4x4(level: torch.Tensor, qp: int) -> torch.Tensor:
    """``ilev = level * V[qp%6] << (qp//6)`` (FR/src/block.c:959)."""
    v = device_const(f"v{qp % 6}", DEQUANT_COEF[qp % 6], level.device)
    return (level * v) << (qp // 6)


def _inv_stage(m: torch.Tensor) -> torch.Tensor:
    m0, m1, m2, m3 = m.unbind(-1)
    a = m0 + m2
    b = m0 - m2
    c = (m1 >> 1) - m3
    d = m1 + (m3 >> 1)
    return torch.stack([a + d, b + c, b - c, a - d], dim=-1)


def idct4x4(w: torch.Tensor) -> torch.Tensor:
    """Inverse 4x4 transform (JM butterflies with >>1), rows first, then
    columns, WITHOUT the final (x+32)>>6 normalization."""
    t = _inv_stage(w.to(torch.int32))
    return _inv_stage(t.transpose(-1, -2)).transpose(-1, -2)


def reconstruct(pred: torch.Tensor, idct_out: torch.Tensor) -> torch.Tensor:
    """clip(pred + (idct_out + 32) >> 6, 0, 255)."""
    r = pred.to(torch.int32) + ((idct_out + DQ_ROUND) >> DQ_BITS)
    return torch.clamp(r, 0, 255)


def transform_quant_reconstruct(residual: torch.Tensor, pred: torch.Tensor,
                                qp: int):
    """Residual coding of a batch of 4x4 blocks -> (levels, recon)."""
    lev = quant4x4(fdct4x4(residual), qp)
    rec = reconstruct(pred, idct4x4(dequant4x4(lev, qp)))
    return lev, rec


# ---------------------------------------------------------------------------
# Frame <-> block reshaping helpers
# ---------------------------------------------------------------------------

def frame_to_blocks(plane: torch.Tensor, bs: int = 4) -> torch.Tensor:
    """[H, W] -> [H//bs * W//bs, bs, bs] in raster block order."""
    h, w = plane.shape
    x = plane.reshape(h // bs, bs, w // bs, bs)
    return x.permute(0, 2, 1, 3).reshape(-1, bs, bs)


def blocks_to_frame(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Inverse of :func:`frame_to_blocks`."""
    bs = blocks.shape[-1]
    x = blocks.reshape(h // bs, w // bs, bs, bs)
    return x.permute(0, 2, 1, 3).reshape(h, w)


def zigzag_scan(levels: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] raster levels -> [..., 16] in zig-zag scan order."""
    flat = levels.reshape(*levels.shape[:-2], 16)
    return flat[..., device_const("zz", ZIGZAG_FLAT, levels.device)]


def zigzag_unscan(scanned: torch.Tensor) -> torch.Tensor:
    """[..., 16] zig-zag order -> [..., 4, 4] raster."""
    flat = scanned[..., device_const("zzinv", ZIGZAG_INV, scanned.device)]
    return flat.reshape(*scanned.shape[:-1], 4, 4)


# ---------------------------------------------------------------------------
# Coefficient-cost thresholding (JM 8.6 LumaResidualCoding8x8 semantics,
# FR/src/macroblock.c:995-1166)
# ---------------------------------------------------------------------------

COEFF_COST = np.array([3, 2, 2, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                      dtype=np.int32)
_LUMA_COEFF_COST_ = 4
_LUMA_MB_COEFF_COST_ = 5
_BIG_COST = 999999


def coeff_cost_4x4(zz: torch.Tensor) -> torch.Tensor:
    """Cost of each 4x4 block from its zig-zag levels [..., 16] -> [...]."""
    nz = zz != 0
    idx = device_const("arange16", np.arange(16, dtype=np.int32), zz.device)
    marked = torch.where(nz, idx, torch.full_like(idx, -1))
    prev_incl = torch.cummax(marked, dim=-1).values
    prev_excl = torch.cat(
        [torch.full_like(prev_incl[..., :1], -1), prev_incl[..., :-1]], dim=-1)
    run = idx - prev_excl - 1
    table = device_const("coeff_cost", COEFF_COST, zz.device)
    per = torch.where(torch.abs(zz) > 1, _BIG_COST,
                      table[torch.clamp(run, 0, 15).long()])
    return torch.where(nz, per, 0).sum(dim=-1, dtype=torch.int32)


_QP_SCALE_CR_TAIL = np.array(
    [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37,
     37, 38, 38, 38, 39, 39, 39, 39], dtype=np.int32)


def chroma_qp(qp: int, offset: int = 0) -> int:
    """Chroma QP mapping (H.264 Table 8-15 / JM QP_SCALE_CR)."""
    q = min(max(int(qp) + offset, 0), 51)
    return int(q if q < 30 else _QP_SCALE_CR_TAIL[q - 30])


def _repeat2d(x: torch.Tensor, f: int) -> torch.Tensor:
    return x.repeat_interleave(f, dim=0).repeat_interleave(f, dim=1)


def residual_code_plane(org: torch.Tensor, pred: torch.Tensor, qp: int,
                        luma_mb_grid: bool = True):
    """Residual-code a whole plane against a prediction.

    4x4 transform+quant of org-pred, 8x8-level and MB-level coefficient-cost
    thresholding, reconstruction.  Returns (levels_zz [H/4*W/4, 16] int32 in
    raster 4x4-block order, recon [H, W] int32).  ``luma_mb_grid`` adds the
    16x16 MB-level drop; chroma planes group 8x8 only.
    """
    H, W = org.shape
    rb = frame_to_blocks(org.to(torch.int32) - pred.to(torch.int32), 4)
    lev = quant4x4(fdct4x4(rb), qp)
    zz = zigzag_scan(lev)

    cost = coeff_cost_4x4(zz).reshape(H // 4, W // 4)
    c8 = cost.reshape(H // 8, 2, W // 8, 2).sum(dim=(1, 3), dtype=torch.int32)
    drop8 = c8 <= _LUMA_COEFF_COST_
    if luma_mb_grid:
        kept8 = torch.where(drop8, 0, c8)
        mb_cost = kept8.reshape(H // 16, 2, W // 16, 2).sum(dim=(1, 3))
        drop8 = drop8 | _repeat2d(mb_cost <= _LUMA_MB_COEFF_COST_, 2)
    drop4 = _repeat2d(drop8, 2).reshape(-1)

    lev = torch.where(drop4[:, None, None], 0, lev)
    zz = torch.where(drop4[:, None], 0, zz)
    pb = frame_to_blocks(pred.to(torch.int32), 4)
    rec = reconstruct(pb, idct4x4(dequant4x4(lev, qp)))
    return zz, blocks_to_frame(rec, H, W)
