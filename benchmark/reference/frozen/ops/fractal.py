"""Fractal (PIFS) P-frame engine — search, fit and reconstruction in PyTorch.

Port of ``h264tpu/ops/fractal.py``.  The search evaluates every
``[reference x offset x block]`` candidate of every block shape at once:

* the cross term Σr·d of every aligned 4x4 cell at every offset (``cross4``)
  comes from :func:`cross_cell_sums`, the hand-written CUDA kernel
  ``csrc/cross_cells.cu`` (the port of the TPU kernel ``pallas_cross_rows``);
  every block shape's Σr·d is a cell pool of it;
* domain sums at every offset come from integral images;
* the closed-form α/β fit and RMS run over the whole lattice, and one
  lexicographic (rms, reference, spiral) minimum per block picks the winner —
  the same associative minimum the JAX package carries over offset chunks.

Floating point follows the JAX package as XLA's CPU backend compiles it: the
multiply-adds of the RMS are fused (single rounding) and ``x / 100`` is
``x * (1/100)``.  The port writes both out explicitly (:func:`_fma` rounds an
exact float64 product-sum once to float32), so that CPU and CUDA give the same
bits and the same winners as the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device_const

INF_RMS = 1e30

# α lattice: a = α·100 ∈ [-235, 400] quantized by QUAN_A; β ∈ [-60,255] step 5
A_MIN, A_MAX = -235, 400
BETA_MIN, BETA_MAX = -60, 255

# shape codes used in leaf maps / the bitstream: (bh, bw) per code 0..4
SHAPES = ((16, 16), (8, 8), (4, 8), (8, 4), (4, 4))
_F32_INV100 = float(np.float32(1.0) / np.float32(100.0))


# ---------------------------------------------------------------------------
# Quantizers (FR/inc/defines_enc.h:591 QUAN_A)
# ---------------------------------------------------------------------------

def quan_a(x: torch.Tensor) -> torch.Tensor:
    """Exact replica of the reference's QUAN_A macro on int32 input (C ``%``
    and ``/`` truncate toward zero; negatives truncate to a multiple of ten)."""
    x = x.to(torch.int32)
    c = torch.sign(x) * (torch.abs(x) // 10)
    b = x - c * 10
    mid = (b > 2) & (b < 8)
    c_new = torch.where(b > 7, c + 1, c)
    return c_new * 10 + torch.where(mid, 5, 0).to(torch.int32)


# ---------------------------------------------------------------------------
# Reference planes
# ---------------------------------------------------------------------------

def halfpel_planes(ref: torch.Tensor):
    """Bilinear half-pel planes (H, M, N): truncating integer averages with
    edge replication."""
    ref = ref.to(torch.int32)
    right = torch.cat([ref[:, 1:], ref[:, -1:]], dim=1)
    down = torch.cat([ref[1:, :], ref[-1:, :]], dim=0)
    downright = torch.cat([right[1:, :], right[-1:, :]], dim=0)
    h = (ref + right) // 2
    m = (ref + down) // 2
    n = (ref + down + right + downright) // 4
    return h, m, n


def build_reference_stack(ref: torch.Tensor, use_halfpel: bool) -> torch.Tensor:
    """[R, H, W] int32 stack of reference planes: C (+H, M, N)."""
    ref = ref.to(torch.int32)
    if not use_halfpel:
        return ref[None]
    return torch.stack([ref, *halfpel_planes(ref)])


def _reference_planes(ref: torch.Tensor, use_halfpel: bool,
                      extra_ref_ctx: torch.Tensor = None) -> torch.Tensor:
    """The stack of ``ref``, then that of ``extra_ref_ctx`` when given."""
    refs = build_reference_stack(ref, use_halfpel)
    if extra_ref_ctx is None:
        return refs
    return torch.cat([refs, build_reference_stack(extra_ref_ctx, use_halfpel)])


# ---------------------------------------------------------------------------
# Sum tables
# ---------------------------------------------------------------------------

def integral_image(x: torch.Tensor) -> torch.Tensor:
    """[..., H, W] -> [..., H+1, W+1] int64 inclusive prefix sums with a zero
    border.  int64 instead of the JAX package's wrapping int32: window sums
    narrowed to int32 are identical."""
    ii = torch.cumsum(torch.cumsum(x.to(torch.int64), dim=-2), dim=-1)
    return torch.nn.functional.pad(ii, (1, 0, 1, 0))


def window_sums(ii: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """int32 sums over [y:y+h, x:x+w] for every top-left (y, x), zero-padded
    at the bottom/right where the window would cross the frame edge."""
    s = (ii[..., h:, w:] - ii[..., :-h, w:] - ii[..., h:, :-w]
         + ii[..., :-h, :-w]).to(torch.int32)
    return torch.nn.functional.pad(s, (0, w - 1, 0, h - 1))




# ---------------------------------------------------------------------------
# Reconstruction (decode_one_macroblock, FR/src/block_dec.c:20)
# ---------------------------------------------------------------------------

def _upsample(x: torch.Tensor, fy: int, fx: int) -> torch.Tensor:
    return x.repeat_interleave(fy, dim=0).repeat_interleave(fx, dim=1)


_SHAPE_BH = np.asarray([s[0] for s in SHAPES], np.int32)
_SHAPE_BW = np.asarray([s[1] for s in SHAPES], np.int32)
_SHAPE_LOG2N = np.asarray([8, 6, 5, 5, 4], np.int32)


def reconstruct_from_maps(maps: dict, ref: torch.Tensor, H: int, W: int,
                          use_halfpel: bool = True,
                          extra_ref_ctx: torch.Tensor = None,
                          halo: int = 0) -> torch.Tensor:
    """Non-iterative fractal reconstruction of a whole plane from leaf maps.

    Exact integer form of ``rec = bound(0.5 + α·d + β − α·mean(d))``
    (FR/src/block_dec.c:113): with a = α·100, N the leaf pixel count and
    S = Σd over the leaf's domain block,
    ``rec = clip(floor((50N + a(dN − S) + 100Nβ) / (100N)), 0, 255)``;
    S is recomputed from the reference planes as the decoder does;
    ``ref`` is [H + 2*halo, W] and ``extra_ref_ctx`` as in
    :func:`search_plane`.
    """
    dev = ref.device
    refs = _reference_planes(ref, use_halfpel, extra_ref_ctx)
    He = H + 2 * halo
    a, beta, dx, dy, refi, shape = (
        _upsample(maps[k].to(torch.int64), 4, 4)
        for k in ("a", "beta", "dx", "dy", "ref", "shape"))

    yy_pix = torch.arange(H, device=dev)[:, None]
    xx_pix = torch.arange(W, device=dev)[None, :]
    bh = device_const("shape_bh", _SHAPE_BH, dev).to(torch.int64)[shape]
    bw = device_const("shape_bw", _SHAPE_BW, dev).to(torch.int64)[shape]
    log2n = device_const("shape_log2n", _SHAPE_LOG2N, dev).to(torch.int64)[shape]
    oy = yy_pix - yy_pix % bh          # leaf origin
    ox = xx_pix - xx_pix % bw

    # domain pixel for this output pixel (rows of the halo'd stack)
    yy = torch.clamp(yy_pix + dy + halo, 0, He - 1)
    xx = torch.clamp(xx_pix + dx, 0, W - 1)
    d = refs.reshape(-1)[refi * (He * W) + yy * W + xx].to(torch.int64)

    # Σd over the leaf's domain block, per shape, gathered at the leaf origin
    dom_y = torch.clamp(oy + dy + halo, 0, He - 1)
    dom_x = torch.clamp(ox + dx, 0, W - 1)
    ii = integral_image(refs)                              # [R, He+1, W+1]
    wsums = torch.stack([window_sums(ii, sh, sw) for sh, sw in SHAPES], dim=1)
    flat = refi * (5 * He * W) + shape * (He * W) + dom_y * W + dom_x
    s_d = wsums.reshape(-1)[flat].to(torch.int64)

    n = torch.ones_like(log2n) << log2n
    numer = 50 * n + a * (d * n - s_d) + 100 * n * beta
    rec = torch.div(numer, 100 * n, rounding_mode="floor")
    return torch.clamp(rec, 0, 255).to(torch.int32)
