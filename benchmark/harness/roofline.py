"""Published peaks of the card and the work of the layers that report a
roofline share, counted from shapes.

The peaks and :func:`cross_cells_bound_ms` are frozen copies of
``chip_smoke.py`` (commit e045584): NVIDIA's H100 SXM data sheet, the HBM
rate and the float32 rate outside the tensor cores, which bounds the CUDA
cores' int32 work.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12

# operations of one candidate's closed-form fit in ops/fractal.fit_and_rms,
# counted from its expressions: num and det (6), alpha and its scaling,
# truncation and clamp (4), the quantiser (6), the bound tests (4),
# aq and the mean term (4), the inner sum (6), the squared error (6), the
# validity select and the running minimum (2)
FIT_OPS = 38
SHAPES = ((16, 16), (8, 8), (4, 8), (8, 4), (4, 4))
PARAM_BYTES_PER_CELL = 6 * 4     # a, beta, dx, dy, ref, shape as int32


def cross_cells_bound_ms(H: int, W: int, R: int, sr: int, n_off: int):
    """(bound ms, "bytes" or "operations") of the cross_cells kernel: each
    input read once (org, refs_pad, the slot table) and cross4 written once
    at the HBM rate, against 2*R*n_off*H*W operations at the CUDA cores'
    rate."""
    nbytes = 4 * (H * W + R * (H + 2 * sr) * (W + 2 * sr) + (2 * sr + 1) ** 2
                  + R * n_off * (H // 4) * (W // 4))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * R * n_off * H * W / CUDA_CORE_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _pad16(n: int) -> int:
    return n + (-n) % 16


def search_plane_work(H: int, W: int, sr: int, use_halfpel: bool):
    """(operations, bytes) of the fractal search of one plane, whatever
    implements it: the original and the reference plane read once as
    bytes, the leaf parameters written once, 2 operations per pixel of
    every 4x4 cell's Sigma r.d at every offset and plane, the cell sums
    pooled into every larger shape, and the fit of every block of every
    shape at every candidate."""
    Hp, Wp = _pad16(H), _pad16(W)
    R = 4 if use_halfpel else 1
    cand = R * (2 * sr + 1) ** 2
    ops = 2 * Hp * Wp * cand
    for bh, bw in SHAPES:
        blocks = (Hp // bh) * (Wp // bw)
        cells = (bh // 4) * (bw // 4)
        ops += blocks * cand * (FIT_OPS + cells - 1)
    nbytes = 2 * H * W + (Hp // 4) * (Wp // 4) * PARAM_BYTES_PER_CELL
    return ops, nbytes


def fractal_search_bound_ms(settings: dict):
    """(least ms, "bytes" or "operations") of one P frame's search over
    its three planes at the card's peaks."""
    fr = settings["fractal"]
    H, W = settings["height"], settings["width"]
    ops = nbytes = 0
    for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2)):
        o, b = search_plane_work(h, w, fr["search_range"],
                                 fr["use_halfpel_refs"])
        ops += o
        nbytes += b
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops else "operations")
