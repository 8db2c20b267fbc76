"""Quarter-pel interpolation (spec 8.4.2.2.1), motion estimation and
motion compensation on int32 tensors.

Port of ``h264tpu/ops/me.py``: 6-tap (1, -5, 20, 20, -5, 1)/32 half-pels,
clipped, and quarter-pels as the rounded average of their two nearest
integer/half-pel neighbours; the classic inter path's integer full search,
sub-pel refinement and block MC.  Edge padding is an index clamp, so any
integer dtype works on either device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import device_const
from .fractal import first_min, spiral_offsets


def edge_pad(x: torch.Tensor, top: int, bottom: int, left: int,
             right: int) -> torch.Tensor:
    """Replicate the border samples of the last two axes (``np.pad`` edge)."""
    H, W = x.shape[-2:]
    rows = torch.arange(-top, H + bottom, device=x.device).clamp(0, H - 1)
    cols = torch.arange(-left, W + right, device=x.device).clamp(0, W - 1)
    return x[..., rows, :][..., cols]


def _tap6(x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim] - 5
    s = [x.narrow(dim, i, n) for i in range(6)]
    return s[0] - 5 * s[1] + 20 * s[2] + 20 * s[3] - 5 * s[4] + s[5]


def _avg(x, y):
    return (x + y + 1) >> 1


def _shift_r(x):
    return torch.cat([x[:, 1:], x[:, -1:]], dim=1)


def _shift_d(x):
    return torch.cat([x[1:, :], x[-1:, :]], dim=0)


def _half_pels(plane: torch.Tensor):
    """(G, b, h, j) integer and half-pel planes [H, W] int32."""
    p = plane.to(torch.int32)
    H, W = p.shape
    pad = edge_pad(p, 2, 3, 2, 3)
    b = torch.clamp((_tap6(pad, 1)[2:2 + H, 0:W] + 16) >> 5, 0, 255)
    h_raw = _tap6(pad, 0)[0:H, 2:2 + W]
    h = torch.clamp((h_raw + 16) >> 5, 0, 255)
    j_raw = _tap6(edge_pad(h_raw, 0, 0, 2, 3), 1)[:, 0:W]
    j = torch.clamp((j_raw + 512) >> 10, 0, 255)
    return p, b, h, j


def sixtap_phases(plane: torch.Tensor) -> torch.Tensor:
    """Phase-split quarter-pel planes ``[4, 4, H, W] uint8``: ``[fy, fx, y,
    x]`` is the (fy, fx) quarter-pel sample at integer position (y, x)."""
    G, b, h, j = _half_pels(plane)
    rows = [
        [G, _avg(G, b), b, _avg(b, _shift_r(G))],
        [_avg(G, h), _avg(b, h), _avg(b, j), _avg(b, _shift_r(h))],
        [h, _avg(h, j), j, _avg(j, _shift_r(h))],
        [_avg(h, _shift_d(G)), _avg(_shift_d(b), h), _avg(j, _shift_d(b)),
         _avg(_shift_d(b), _shift_r(h))],
    ]
    return torch.stack([torch.stack(r) for r in rows]).to(torch.uint8)


def sixtap_halfpel(plane: torch.Tensor) -> torch.Tensor:
    """The same samples as one 4x-upsampled grid ``[4H, 4W] int32``: sample
    (4y + fy, 4x + fx) is the (fy, fx) quarter-pel value at (y, x)."""
    ph = sixtap_phases(plane).to(torch.int32)            # [4, 4, H, W]
    H, W = ph.shape[-2:]
    return ph.permute(2, 0, 3, 1).reshape(4 * H, 4 * W)


# ---------------------------------------------------------------------------
# Classic H.264-style motion estimation and compensation (``ops/me.py``:140-)
# ---------------------------------------------------------------------------

class MEResult(NamedTuple):
    mv_x: torch.Tensor   # quarter-pel units, [nby, nbx] int32
    mv_y: torch.Tensor
    sad: torch.Tensor    # SAD + MV cost of the chosen vector


def _bitlen(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) + 1 for x >= 1 and 0 for x <= 0, int32, by a binary
    search over right shifts (the port's twin of ``lax.clz``)."""
    x = torch.clamp(x.to(torch.int32), min=0)
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        hi = (x >> s) > 0
        x = torch.where(hi, x >> s, x)
        n = n + torch.where(hi, s, 0)
    return n + (x > 0).to(torch.int32)


def _ue_len(v: torch.Tensor) -> torch.Tensor:
    """Bit length of the se(v) code: ue of the signed mapping of v."""
    k = torch.where(v > 0, 2 * v - 1, -2 * v)
    return 2 * (_bitlen(k + 1) - 1) + 1


def mv_cost(dx_q, dy_q, px_q, py_q, lam: int):
    """lambda * (se-code length of the MVD), MVs in quarter pels."""
    return lam * (_ue_len(dx_q - px_q) + _ue_len(dy_q - py_q))


def full_search_int(org: torch.Tensor, ref: torch.Tensor, bs: int,
                    search_range: int, lam: int = 0,
                    chunk: int = 64) -> MEResult:
    """Integer-pel full search of every bs x bs block at once.

    The SAD of every (block, offset) of the edge-padded reference, plus the
    MV cost against the zero predictor, in spiral order over chunks of
    offsets with a running best: strict improvement across chunks, the
    lowest spiral index among equal costs — the first minimum in spiral
    order.  Returns integer MVs in quarter pels."""
    H, W = org.shape
    nby, nbx = H // bs, W // bs
    sr = search_range
    offsets = spiral_offsets(sr)
    offs = device_const(f"me_spiral{sr}", offsets, org.device)
    o = org.to(torch.int32)
    padded = edge_pad(ref.to(torch.int32), sr, sr, sr, sr)
    best = dx = dy = None
    for s in range(0, offsets.shape[0], chunk):
        oc = offsets[s:s + chunk]
        sh = torch.stack([padded[sr + int(y):sr + int(y) + H,
                                 sr + int(x):sr + int(x) + W] for x, y in oc])
        sads = (o[None] - sh).abs().reshape(len(oc), nby, bs, nbx, bs).sum(
            dim=(2, 4), dtype=torch.int32)
        oxy = offs[s:s + chunk]
        cost = sads + mv_cost(4 * oxy[:, 0], 4 * oxy[:, 1], 0, 0,
                              lam)[:, None, None]
        c_best, sel = first_min(cost)
        c_dx, c_dy = oxy[:, 0][sel], oxy[:, 1][sel]
        if best is None:
            best, dx, dy = c_best, c_dx, c_dy
            continue
        win = c_best < best
        best = torch.where(win, c_best, best)
        dx = torch.where(win, c_dx, dx)
        dy = torch.where(win, c_dy, dy)
    return MEResult(mv_x=4 * dx, mv_y=4 * dy, sad=best)


def _block_gather(up: torch.Tensor, mv_x: torch.Tensor, mv_y: torch.Tensor,
                  bs: int) -> torch.Tensor:
    """[nby, nbx, bs, bs] prediction of every block at its quarter-pel MV
    from the 4x-upsampled plane; sample indices clamp to [0, 4H-4] and
    [0, 4W-4] as the reference's do."""
    H4, W4 = up.shape
    nby, nbx = mv_x.shape
    dev = up.device
    by = torch.arange(nby, device=dev)[:, None, None, None] * bs
    bx = torch.arange(nbx, device=dev)[None, :, None, None] * bs
    k = torch.arange(bs, device=dev)
    yy = torch.clamp((by + k[None, None, :, None]) * 4
                     + mv_y[:, :, None, None], 0, H4 - 4)
    xx = torch.clamp((bx + k[None, None, None, :]) * 4
                     + mv_x[:, :, None, None], 0, W4 - 4)
    return up.reshape(-1)[yy * W4 + xx]


def subpel_refine(org: torch.Tensor, up: torch.Tensor, me: MEResult, bs: int,
                  lam: int = 0) -> MEResult:
    """Half- then quarter-pel refinement around the integer best, all blocks
    in parallel; the eight neighbours of each step in JM's order, each kept
    on strict improvement."""
    H, W = org.shape
    nby, nbx = H // bs, W // bs
    ob = org.to(torch.int32).reshape(nby, bs, nbx, bs).transpose(1, 2)

    def cost(mvx, mvy):
        pred = _block_gather(up, mvx, mvy, bs)
        return ((ob - pred).abs().sum(dim=(2, 3), dtype=torch.int32)
                + mv_cost(mvx, mvy, 0, 0, lam))

    mvx, mvy = me.mv_x, me.mv_y
    best = cost(mvx, mvy)
    for step in (2, 1):
        for ddy in (-step, 0, step):
            for ddx in (-step, 0, step):
                if ddx == 0 and ddy == 0:
                    continue
                cx, cy = mvx + ddx, mvy + ddy
                c = cost(cx, cy)
                better = c < best
                mvx = torch.where(better, cx, mvx)
                mvy = torch.where(better, cy, mvy)
                best = torch.where(better, c, best)
    return MEResult(mv_x=mvx, mv_y=mvy, sad=best)


def motion_compensate(up: torch.Tensor, mv_x: torch.Tensor, mv_y: torch.Tensor,
                      bs: int, H: int, W: int) -> torch.Tensor:
    """The prediction plane [H, W] from per-block quarter-pel MVs."""
    pred = _block_gather(up, mv_x, mv_y, bs)
    return pred.transpose(1, 2).reshape(H, W)


def me_lambda(qp: int) -> int:
    """JM motion-estimation lambda (sqrt of the mode lambda), rounded half
    to even as Python's ``round`` does."""
    lam = 0.85 * 2.0 ** ((qp - 12) / 3.0)
    return max(1, int(round(np.sqrt(lam))))
