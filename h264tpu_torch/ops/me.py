"""Quarter-pel luma interpolation (spec 8.4.2.2.1) on int32 tensors.

Port of ``sixtap_halfpel`` and ``sixtap_phases`` from ``h264tpu/ops/me.py``:
6-tap (1, -5, 20, 20, -5, 1)/32 half-pels, clipped, and quarter-pels as the
rounded average of their two nearest integer/half-pel neighbours.  Edge
padding is an index clamp, so any integer dtype works on either device.
"""

from __future__ import annotations

import torch


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
