"""H.264-style in-loop deblocking filter on int32 tensors.

Port of ``h264tpu/ops/deblock.py``: the standard H.264 edge filter (normal
bS<4 + strong bS=4) with the spec's ALPHA/BETA/CLIP tables
(``FR/src/loopFilter.c:329`` EdgeLoop), in the FVC edge order — all vertical
edges left to right, each across every row at once, then all horizontal edges
top to bottom on the transposed plane.  The JAX ``lax.scan`` over edges is a
Python loop that updates the plane in place.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device_const

ALPHA_TABLE = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 4, 4, 5, 6,
     7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28, 32, 36, 40, 45,
     50, 56, 63, 71, 80, 90, 101, 113, 127, 144, 162, 182, 203, 226, 255, 255],
    dtype=np.int32)
BETA_TABLE = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 2, 2, 3,
     3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10,
     11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18],
    dtype=np.int32)
CLIP_TAB = np.array([
    [0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0], [0, 0, 0, 1, 1], [0, 0, 0, 1, 1], [0, 0, 0, 1, 1],
    [0, 0, 0, 1, 1], [0, 0, 1, 1, 1], [0, 0, 1, 1, 1], [0, 1, 1, 1, 1],
    [0, 1, 1, 1, 1], [0, 1, 1, 1, 1], [0, 1, 1, 1, 1], [0, 1, 1, 2, 2],
    [0, 1, 1, 2, 2], [0, 1, 1, 2, 2], [0, 1, 1, 2, 2], [0, 1, 2, 3, 3],
    [0, 1, 2, 3, 3], [0, 2, 2, 3, 3], [0, 2, 2, 4, 4], [0, 2, 3, 4, 4],
    [0, 2, 3, 4, 4], [0, 3, 3, 5, 5], [0, 3, 4, 6, 6], [0, 3, 4, 6, 6],
    [0, 4, 5, 7, 7], [0, 4, 5, 8, 8], [0, 4, 6, 9, 9], [0, 5, 7, 10, 10],
    [0, 6, 8, 11, 11], [0, 6, 8, 13, 13], [0, 7, 10, 14, 14], [0, 8, 11, 16, 16],
    [0, 9, 12, 18, 18], [0, 10, 13, 20, 20], [0, 11, 15, 23, 23], [0, 13, 17, 25, 25],
], dtype=np.int32)


def _filter_edge_lines(p3, p2, p1, p0, q0, q1, q2, q3, bs, qp: int,
                       luma: bool):
    """Filter one edge for a batch of pixel lines.

    p3..q3: int32 pixels across the edge (p before, q after); bs: per-line
    boundary strength 0..4.  Returns (p2', p1', p0', q0', q1', q2').
    """
    alpha = int(ALPHA_TABLE[qp])
    beta = int(BETA_TABLE[qp])
    tc0 = device_const(f"clip{qp}", CLIP_TAB[qp], bs.device)[
        torch.clamp(bs, 0, 4).long()]

    d0 = torch.abs(p0 - q0)
    filt = ((bs > 0) & (d0 < alpha) & (torch.abs(p1 - p0) < beta)
            & (torch.abs(q1 - q0) < beta))
    ap = torch.abs(p2 - p0) < beta
    aq = torch.abs(q2 - q0) < beta

    # ---- normal filter (bS < 4) ----
    tc = tc0 + ap.to(torch.int32) + aq.to(torch.int32) if luma else tc0 + 1
    delta = torch.clamp((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    p0_n = torch.clamp(p0 + delta, 0, 255)
    q0_n = torch.clamp(q0 - delta, 0, 255)
    if luma:
        avg = (p0 + q0 + 1) >> 1
        dp1 = torch.clamp((p2 + avg - (p1 << 1)) >> 1, -tc0, tc0)
        dq1 = torch.clamp((q2 + avg - (q1 << 1)) >> 1, -tc0, tc0)
        p1_n = torch.where(ap, p1 + dp1, p1)
        q1_n = torch.where(aq, q1 + dq1, q1)
    else:
        p1_n, q1_n = p1, q1

    # ---- strong filter (bS == 4) ----
    small = d0 < ((alpha >> 2) + 2)
    if luma:
        sp = small & ap
        sq = small & aq
        p0_s = torch.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                           (2 * p1 + p0 + q1 + 2) >> 2)
        p1_s = torch.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
        p2_s = torch.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
        q0_s = torch.where(sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                           (2 * q1 + q0 + p1 + 2) >> 2)
        q1_s = torch.where(sq, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
        q2_s = torch.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)
    else:
        p0_s = (2 * p1 + p0 + q1 + 2) >> 2
        q0_s = (2 * q1 + q0 + p1 + 2) >> 2
        p1_s, p2_s, q1_s, q2_s = p1, p2, q1, q2

    strong = bs == 4
    fs = filt & strong
    p0_o = torch.where(filt, torch.where(strong, p0_s, p0_n), p0)
    q0_o = torch.where(filt, torch.where(strong, q0_s, q0_n), q0)
    p1_o = torch.where(filt, torch.where(strong, p1_s, p1_n), p1)
    q1_o = torch.where(filt, torch.where(strong, q1_s, q1_n), q1)
    p2_o = torch.where(fs, p2_s, p2)
    q2_o = torch.where(fs, q2_s, q2)
    return p2_o, p1_o, p0_o, q0_o, q1_o, q2_o


def _vertical_pass(plane: torch.Tensor, bs_v: torch.Tensor, qp: int,
                   luma: bool) -> torch.Tensor:
    """Filter every vertical 4-px edge, scanning left -> right.

    plane [..., H, W]; bs_v [..., H/4, W/4] — strength of the edge to the
    LEFT of each 4-px cell column (column 0 is the frame edge, not filtered).
    """
    W = plane.shape[-1]
    bs_rows = bs_v.repeat_interleave(4, dim=-2)           # [..., H, W/4]
    buf = plane.to(torch.int32).clone()
    for j in range(W // 4 - 1):
        x = (j + 1) * 4
        cols = buf[..., x - 4:x + 4].unbind(-1)
        new = _filter_edge_lines(*cols, bs_rows[..., j + 1], qp, luma)
        buf[..., x - 3:x + 3] = torch.stack(new, dim=-1)
    return buf


def deblock_plane(plane: torch.Tensor, bs_v: torch.Tensor, bs_h: torch.Tensor,
                  qp: int, luma: bool = True) -> torch.Tensor:
    """Deblock one plane (or a batch of planes): all vertical edges, then all
    horizontal edges."""
    out = _vertical_pass(plane, bs_v, qp, luma)
    out = _vertical_pass(out.transpose(-1, -2).contiguous(),
                         bs_h.transpose(-1, -2), qp, luma)
    return out.transpose(-1, -2).contiguous()


def deblock_plane_grouped(plane: torch.Tensor, bs_v: torch.Tensor,
                          bs_h: torch.Tensor, qp: int, luma: bool = True,
                          groups: int = 1) -> torch.Tensor:
    """Deblock in ``groups`` independent horizontal row bands (band-boundary
    horizontal edges unfiltered; the band grid is fixed by cfg.tile_rows)."""
    if groups <= 1:
        return deblock_plane(plane, bs_v, bs_h, qp, luma)
    H, W = plane.shape
    cy = bs_v.shape[0]
    out = deblock_plane(plane.reshape(groups, H // groups, W),
                        bs_v.reshape(groups, cy // groups, -1),
                        bs_h.reshape(groups, cy // groups, -1), qp, luma)
    return out.reshape(H, W)


def strengths_intra(h: int, w: int, device):
    """bS maps for an intra frame: 4 at MB edges, 3 at internal 4x4 edges."""
    cy, cx = h // 4, w // 4
    xs = np.arange(cx)
    ys = np.arange(cy)
    bs_v = np.where(xs[None, :] % 4 == 0, 4, 3) * np.ones((cy, 1), np.int32)
    bs_h = np.where(ys[:, None] % 4 == 0, 4, 3) * np.ones((1, cx), np.int32)
    return (device_const(f"bs_intra_v{h}x{w}", bs_v.astype(np.int32), device),
            device_const(f"bs_intra_h{h}x{w}", bs_h.astype(np.int32), device))


def strengths_fractal(maps: dict, nz_cells: torch.Tensor):
    """bS maps for a fractal P frame from leaf maps + nonzero-coeff cells
    (P-frame rules of ``GetStrength``, FR/src/loopFilter.c:192): 2 if either
    side has coded coefficients, else 1 if the sides' domain offset or
    reference differ, else 0."""
    dx, dy, ref = maps["dx"], maps["dy"], maps["ref"]
    nz = nz_cells.to(torch.bool)

    def edge(axis):
        def sh(x):
            return torch.roll(x, 1, dims=axis)

        coeff = nz | sh(nz)
        moved = (dx != sh(dx)) | (dy != sh(dy)) | (ref != sh(ref))
        return torch.where(coeff, 2, torch.where(moved, 1, 0)).to(torch.int32)

    return edge(1), edge(0)   # vertical edges (left neighbour), horizontal
