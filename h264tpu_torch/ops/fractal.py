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

from typing import NamedTuple

import numpy as np
import torch

from .. import device_const
from .. import kernels

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


def range_cell_sums(org: torch.Tensor):
    """Per aligned 4x4 cell Σr and Σr² -> two [H/4, W/4] int32 tensors."""
    o = org.to(torch.int32)
    h, w = o.shape
    c = o.reshape(h // 4, 4, w // 4, 4)
    return (c.sum(dim=(1, 3), dtype=torch.int32),
            (c * c).sum(dim=(1, 3), dtype=torch.int32))


def spiral_offsets(search_range: int) -> np.ndarray:
    """All (dx, dy) integer offsets in the visit order of the reference's
    spiral scan (``full_search``, FR/src/block_enc.c:1944-1977): center first,
    then ring l = 1..SR from (-l,-l), running right, down, left, up.  Index in
    the returned [nOff, 2] int32 array IS the tie-break priority."""
    out = [(0, 0)]
    for l in range(1, search_range + 1):
        i = j = -l
        for k in range(8 * l):
            out.append((i, j))
            if k < 2 * l:
                i += 1
            elif k < 4 * l:
                j += 1
            elif k < 6 * l:
                i -= 1
            else:
                j -= 1
    return np.asarray(out, dtype=np.int32)


def candidate_offsets(search_range: int, mode: int = 0) -> np.ndarray:
    """Candidate (dx, dy) set for the reference's four search modes
    (0=full, 1=new-hex, 2=UMHex, 3=hex), each a static subsampled lattice in
    spiral priority order (see ``h264tpu/ops/fractal.py`` candidate_offsets)."""
    spiral = spiral_offsets(search_range)
    if mode == 0:
        return spiral
    sel = []
    for idx, (x, y) in enumerate(spiral):
        x, y = int(x), int(y)
        keep = max(abs(x), abs(y)) <= 1                       # dense core
        if mode == 3 or mode == 1:
            keep |= (y % 2 == 0) and ((x + y // 2) % 2 == 0)  # hex lattice
            if mode == 1:
                keep |= (x == 0) or (y == 0)                  # cross arms
        elif mode == 2:
            keep |= max(abs(x), abs(y)) <= 2                  # dense square
            keep |= (x == 0 or y == 0) and (x % 2 == 0 and y % 2 == 0)
            for k in range(1, search_range // 4 + 1):
                hexpts = {(4 * k, 0), (-4 * k, 0), (0, 4 * k), (0, -4 * k),
                          (2 * k, 3 * k), (2 * k, -3 * k),
                          (-2 * k, 3 * k), (-2 * k, -3 * k),
                          (4 * k, 2 * k), (4 * k, -2 * k),
                          (-4 * k, 2 * k), (-4 * k, -2 * k),
                          (4 * k, k), (-4 * k, k), (4 * k, -k), (-4 * k, -k)}
                keep |= (x, y) in hexpts
        if keep:
            sel.append(idx)
    return spiral[np.asarray(sel, dtype=np.int64)]


# ---------------------------------------------------------------------------
# The cross-correlation core: Σ r·d per 4x4 cell for every (ref, offset)
# ---------------------------------------------------------------------------

def cross_cell_sums_reference(org: torch.Tensor, refs_pad: torch.Tensor,
                              offsets: torch.Tensor, sr: int) -> torch.Tensor:
    """Plain PyTorch version of the ``cross_cells`` kernel.

    org [H, W] int32; refs_pad [R, H+2sr, W+2sr] int32 (zero-padded stack);
    offsets [n_off, 2] int32 (dx, dy).  Returns cross4 [R, n_off, H/4, W/4]
    int32 with ``cross4[r, k, cy, cx] = Σ_{i,j<4} org[4cy+i, 4cx+j] ·
    refs_pad[r, sr+4cy+i+dy, sr+4cx+j+dx]``.
    """
    H, W = org.shape
    R = refs_pad.shape[0]
    out = []
    for dx, dy in offsets.tolist():
        sh = refs_pad[:, sr + dy:sr + dy + H, sr + dx:sr + dx + W]
        out.append((org[None] * sh).reshape(R, H // 4, 4, W // 4, 4)
                   .sum(dim=(2, 4), dtype=torch.int32))
    return torch.stack(out, dim=1)


def cross_cell_sums(org: torch.Tensor, refs_pad: torch.Tensor,
                    offsets: torch.Tensor, sr: int) -> torch.Tensor:
    """cross4 [R, n_off, H/4, W/4] int32 — see :func:`cross_cell_sums_reference`.

    On a CUDA tensor this launches the hand-written kernel
    (``csrc/cross_cells.cu``) or raises; on a CPU tensor it runs the plain
    version.  ``cross_cell_sums.launches`` counts kernel launches.
    """
    if org.device.type == "cpu":
        return cross_cell_sums_reference(org, refs_pad, offsets, sr)
    if org.device.type != "cuda":
        raise ValueError(f"cross_cell_sums: unsupported device {org.device}")
    H, W = org.shape
    R = refs_pad.shape[0]
    n_off = offsets.shape[0]
    for name, t in (("org", org), ("refs_pad", refs_pad), ("offsets", offsets)):
        if t.device != org.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"cross_cell_sums: {name} must be a contiguous "
                             f"int32 tensor on {org.device}")
    if H % 4 or W % 4 or refs_pad.dim() != 3 \
            or tuple(refs_pad.shape[1:]) != (H + 2 * sr, W + 2 * sr) \
            or tuple(offsets.shape) != (n_off, 2):
        raise ValueError("cross_cell_sums: shape mismatch "
                         f"org {tuple(org.shape)} refs_pad "
                         f"{tuple(refs_pad.shape)} offsets "
                         f"{tuple(offsets.shape)} sr {sr}")
    out = torch.empty((R, n_off, H // 4, W // 4), dtype=torch.int32,
                      device=org.device)
    kernels.launch_cross_cells(org, refs_pad, offsets, out, sr)
    cross_cell_sums.launches += 1
    return out


cross_cell_sums.launches = 0


# ---------------------------------------------------------------------------
# α/β fit + RMS (compute_rms, FR/src/compute.c:6)
# ---------------------------------------------------------------------------

def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c rounded once: the float32 product is exact in float64,
    so one float64 add and one narrowing give the fused result."""
    return (a.to(torch.float64) * b.to(torch.float64)
            + c.to(torch.float64)).to(torch.float32)


def fit_and_rms(n: int, s_r, s_r2, s_d, s_d2, s_rd,
                a_min: int = A_MIN, a_max: int = A_MAX,
                beta_min: int = BETA_MIN, beta_max: int = BETA_MAX):
    """Closed-form least-squares fit with exact quantization + RMS.

    Inputs are exact int32 sums over an N-pixel block (N a power of two);
    shapes broadcast.  Returns (a, beta, rms): ``a`` = quantized α·100 int32,
    ``beta`` int32 multiple of 5, ``rms`` float32 (1e30 where the fit is out
    of bounds).
    """
    assert n & (n - 1) == 0, "block pixel count must be a power of two"
    s_r = s_r.to(torch.int32)
    s_d = s_d.to(torch.int32)
    if n == 256:
        # N·Σrd and Σr·Σd reach 2^32: num/256 and det/256 from exact int32
        # pieces (products of 16/8-bit halves stay < 2^25)
        dh, dl = s_d >> 8, s_d & 255
        num = _f32(s_rd - s_r * dh) - _f32(s_r * dl) / 256.0
        det = _f32(s_d2 - s_d * dh) - _f32(s_d * dl) / 256.0
    else:
        num = _f32(n * s_rd - s_r * s_d)
        det = _f32(n * s_d2 - s_d * s_d)
    det_zero = det == 0.0
    alpha = torch.where(det_zero, 0.0, num / torch.where(det_zero, 1.0, det))

    a_raw = torch.clamp(torch.trunc(alpha * 100.0), -1e6, 1e6).to(torch.int32)
    a = torch.where(det_zero, 0, quan_a(a_raw))
    beta = quan_a(s_r // n)                  # Σr >= 0 so // == C truncation
    ok = (a >= a_min) & (a <= a_max) & (beta >= beta_min) & (beta <= beta_max)

    aq = _f32(a) * _F32_INV100
    bq = _f32(beta)
    sdf, sd2f, srdf = _f32(s_d), _f32(s_d2), _f32(s_rd)
    mean_term = bq - aq * sdf / float(n)
    inner = _fma(2.0 * mean_term, sdf, _fma(aq, sd2f, -2.0 * srdf))
    rms = _fma(mean_term, mean_term * float(n) - 2.0 * _f32(s_r),
               _fma(aq, inner, _f32(s_r2)))
    rms = torch.where(ok, rms, INF_RMS)
    shape = torch.broadcast_shapes(rms.shape, a.shape, beta.shape)
    return a.expand(shape), beta.expand(shape), rms.expand(shape)


class ShapeBest(NamedTuple):
    """Best candidate per block of one shape grid."""
    rms: torch.Tensor     # [nby, nbx] f32
    a: torch.Tensor       # quantized α·100, int32
    beta: torch.Tensor    # int32
    dx: torch.Tensor      # chosen offset, int32
    dy: torch.Tensor
    ref: torch.Tensor     # reference plane index, int32
    s_d: torch.Tensor     # Σd of the chosen domain block, int32


def _pool_cells(x: torch.Tensor, ch: int, cw: int) -> torch.Tensor:
    """Sum trailing [Cy, Cx] cells into non-overlapping (ch x cw) groups."""
    *lead, cy, cx = x.shape
    r = x.reshape(*lead, cy // ch, ch, cx // cw, cw)
    return r.sum(dim=(-3, -1), dtype=x.dtype)


def _search_all_shapes(org: torch.Tensor, refs: torch.Tensor,
                       offsets: np.ndarray, bounds=None):
    """Best (rms, ref, spiral)-lexicographic candidate of every block of every
    shape over all offsets and reference planes at once."""
    dev = org.device
    R, H, W = refs.shape
    n_off = offsets.shape[0]
    sr = int(np.abs(offsets).max())
    org = org.to(torch.int32).contiguous()
    offs = device_const(f"offsets{hash(offsets.tobytes())}",
                        offsets.astype(np.int32), dev)
    dx_all = offs[:, 0].to(torch.int64)
    dy_all = offs[:, 1].to(torch.int64)

    refs_pad = torch.nn.functional.pad(refs, (sr, sr, sr, sr)).contiguous()
    cross = cross_cell_sums(org, refs_pad, offs, sr)      # [R, n_off, cy, cx]

    oc1, oc2 = range_cell_sums(org)
    ii1 = integral_image(refs)                            # [R, H+1, W+1]
    ii2 = integral_image(refs * refs)
    cand_ref = torch.arange(R, device=dev)[:, None].expand(R, n_off).reshape(-1)
    cand_off = torch.arange(n_off, device=dev)[None, :].expand(R, n_off).reshape(-1)
    out = []
    for bh, bw in SHAPES:
        n = bh * bw
        ch, cw = bh // 4, bw // 4
        nby, nbx = H // bh, W // bw
        s_r, s_r2 = _pool_cells(oc1, ch, cw), _pool_cells(oc2, ch, cw)
        s_rd = _pool_cells(cross, ch, cw)                 # [R, n_off, nby, nbx]

        # domain sums at block origins + (dy, dx), from maps padded by sr
        pad = (sr, sr, sr, sr)
        d1_map = torch.nn.functional.pad(window_sums(ii1, bh, bw), pad)
        d2_map = torch.nn.functional.pad(window_sums(ii2, bh, bw), pad)
        by_pix = torch.arange(nby, device=dev) * bh
        bx_pix = torch.arange(nbx, device=dev) * bw
        yi = (sr + dy_all[:, None] + by_pix[None, :])[:, :, None]   # [n_off, nby, 1]
        xi = (sr + dx_all[:, None] + bx_pix[None, :])[:, None, :]   # [n_off, 1, nbx]
        d1s = d1_map[:, yi, xi]                           # [R, n_off, nby, nbx]
        d2s = d2_map[:, yi, xi]

        a, beta, rms = fit_and_rms(
            n, s_r[None, None], s_r2[None, None], d1s, d2s, s_rd,
            *(bounds or (A_MIN, A_MAX, BETA_MIN, BETA_MAX)))

        # validity: the domain block lies inside the frame
        vy = ((by_pix[None, :] + dy_all[:, None] >= 0)
              & (by_pix[None, :] + dy_all[:, None] + bh <= H))   # [n_off, nby]
        vx = ((bx_pix[None, :] + dx_all[:, None] >= 0)
              & (bx_pix[None, :] + dx_all[:, None] <= W - bw))   # [n_off, nbx]
        valid = vy[:, :, None] & vx[:, None, :]
        rms = torch.where(valid[None], rms, INF_RMS)

        # lexicographic minimum over (rms, ref, spiral): the first candidate
        # in (ref, offset) order that reaches the minimum rms
        rms_f = rms.reshape(R * n_off, nby, nbx)
        best_rms = rms_f.amin(dim=0)
        order = torch.arange(R * n_off, device=dev, dtype=torch.int32)
        sel = torch.where(rms_f == best_rms[None], order[:, None, None],
                          R * n_off).amin(dim=0).to(torch.int64)

        def take(arr):
            return torch.gather(arr.reshape(R * n_off, nby, nbx), 0,
                                sel[None])[0]

        out.append(ShapeBest(
            rms=best_rms, a=take(a), beta=take(beta),
            dx=offs[:, 0][cand_off[sel]], dy=offs[:, 1][cand_off[sel]],
            ref=cand_ref[sel].to(torch.int32), s_d=take(d1s)))
    return out


class TransTree(NamedTuple):
    """Quadtree forest of one plane (cf. FR/inc/defines_enc.h:45).

    mb_split: [nMBy, nMBx] bool — True = 8x8 quadtree, False = 16x16 leaf.
    b8_mode:  [2nMBy, 2nMBx] int32 — 0: 8x8 leaf, 1: 8x4 halves, 2: 4x8
              halves, 3: 4x4 split (meaningful only under split MBs).
    """
    mb_split: torch.Tensor
    b8_mode: torch.Tensor
    s16: ShapeBest
    s8: ShapeBest
    s84: ShapeBest
    s48: ShapeBest
    s44: ShapeBest


def chun_correlation(org: torch.Tensor, ref_c: torch.Tensor) -> torch.Tensor:
    """Squared normalized correlation of each 16x16 block with its co-located
    block in the C reference (``FR/src/block_enc.c:800-847``), [nMBy, nMBx]
    float32; NaN where either side has zero variance.

    The centred sums are exact in float64 (17-bit centred values, 256 terms)
    and rounded once to float32, so CPU and CUDA agree whatever their
    reduction order; the JAX package sums in float32, so the two can differ
    only in the last bit, which moves the split gate only at a value exactly
    on its 0.9 / 1.0 bounds.
    """
    H, W = org.shape
    o = org.to(torch.float64).reshape(H // 16, 16, W // 16, 16)
    d = ref_c.to(torch.float64).reshape(H // 16, 16, W // 16, 16)
    oc = o - o.mean(dim=(1, 3), keepdim=True)
    dc = d - d.mean(dim=(1, 3), keepdim=True)
    cov = _f32((oc * dc).sum(dim=(1, 3)))
    var_o = _f32((oc * oc).sum(dim=(1, 3)))
    var_d = _f32((dc * dc).sum(dim=(1, 3)))
    return cov * cov / (var_o * var_d)


def search_plane(org: torch.Tensor, ref: torch.Tensor, *, search_range: int,
                 tol16: float, tol8: float, use_halfpel: bool = True,
                 search_mode: int = 0, chun_lo: float = 0.9,
                 chun_hi: float = 1.0, bounds=None) -> TransTree:
    """Full fractal search of one plane against the previous reconstruction
    (``encode_one_macroblock``, FR/src/block_enc.c:508, over every MB at
    once).  ``org`` and ``ref`` are [H, W] with H, W multiples of 16."""
    H, W = org.shape
    assert H % 16 == 0 and W % 16 == 0
    org = org.to(torch.int32)
    refs = build_reference_stack(ref, use_halfpel)
    offsets = candidate_offsets(search_range, search_mode)
    s16, s8, s84, s48, s44 = _search_all_shapes(org, refs, offsets, bounds)

    # split only when the correlation gate AND the 16x16 tolerance both fail
    # (block_enc.c:847: if(chun<=1 && chun>=0.9 && rms > tol^2*no) -> split)
    chun = chun_correlation(org, refs[0])
    f32 = np.float32
    mb_split = ((chun <= float(f32(chun_hi))) & (chun >= float(f32(chun_lo)))
                & (s16.rms > float(f32(tol16 * tol16 * 256))))

    t8 = float(f32(tol8 * tol8 * 64))
    t_rect = float(f32(tol8 * tol8 * 32))
    accept8 = s8.rms <= t8
    # "both halves pass" per 8x8 block; 8x4 tried first, then 4x8
    both84 = (s84.rms.reshape(H // 8, 2, W // 8) <= t_rect).all(dim=1)
    both48 = (s48.rms.reshape(H // 8, W // 8, 2) <= t_rect).all(dim=2)
    b8_mode = torch.where(accept8, 0,
                          torch.where(both84, 1,
                                      torch.where(both48, 2, 3))).to(torch.int32)
    return TransTree(mb_split=mb_split, b8_mode=b8_mode,
                     s16=s16, s8=s8, s84=s84, s48=s48, s44=s44)


# ---------------------------------------------------------------------------
# Reconstruction (decode_one_macroblock, FR/src/block_dec.c:20)
# ---------------------------------------------------------------------------

def _upsample(x: torch.Tensor, fy: int, fx: int) -> torch.Tensor:
    return x.repeat_interleave(fy, dim=0).repeat_interleave(fx, dim=1)


def leaf_maps(tree: TransTree, H: int, W: int) -> dict:
    """Resolve the quadtree into per-4x4-cell leaf parameter maps: dict of
    [H/4, W/4] int32 maps a, beta, dx, dy, ref, shape (index into SHAPES)."""
    m8 = _upsample(tree.b8_mode, 2, 2)
    split = _upsample(tree.mb_split, 4, 4)

    def sel(name):
        v16 = _upsample(getattr(tree.s16, name), 4, 4)
        v8 = _upsample(getattr(tree.s8, name), 2, 2)
        v84 = _upsample(getattr(tree.s84, name), 1, 2)
        v48 = _upsample(getattr(tree.s48, name), 2, 1)
        v44 = getattr(tree.s44, name)
        under8 = torch.where(m8 == 0, v8,
                             torch.where(m8 == 1, v84,
                                         torch.where(m8 == 2, v48, v44)))
        return torch.where(split, under8, v16).to(torch.int32)

    shape = torch.where(split, m8 + 1, 0).to(torch.int32)
    return dict(a=sel("a"), beta=sel("beta"), dx=sel("dx"), dy=sel("dy"),
                ref=sel("ref"), shape=shape)


_SHAPE_BH = np.asarray([s[0] for s in SHAPES], np.int32)
_SHAPE_BW = np.asarray([s[1] for s in SHAPES], np.int32)
_SHAPE_LOG2N = np.asarray([8, 6, 5, 5, 4], np.int32)


def reconstruct_from_maps(maps: dict, ref: torch.Tensor, H: int, W: int,
                          use_halfpel: bool = True) -> torch.Tensor:
    """Non-iterative fractal reconstruction of a whole plane from leaf maps.

    Exact integer form of ``rec = bound(0.5 + α·d + β − α·mean(d))``
    (FR/src/block_dec.c:113): with a = α·100, N the leaf pixel count and
    S = Σd over the leaf's domain block,
    ``rec = clip(floor((50N + a(dN − S) + 100Nβ) / (100N)), 0, 255)``;
    S is recomputed from the reference planes as the decoder does.
    """
    dev = ref.device
    refs = build_reference_stack(ref, use_halfpel)
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

    # domain pixel for this output pixel
    yy = torch.clamp(yy_pix + dy, 0, H - 1)
    xx = torch.clamp(xx_pix + dx, 0, W - 1)
    d = refs.reshape(-1)[refi * (H * W) + yy * W + xx].to(torch.int64)

    # Σd over the leaf's domain block, per shape, gathered at the leaf origin
    dom_y = torch.clamp(oy + dy, 0, H - 1)
    dom_x = torch.clamp(ox + dx, 0, W - 1)
    ii = integral_image(refs)                              # [R, H+1, W+1]
    wsums = torch.stack([window_sums(ii, sh, sw) for sh, sw in SHAPES], dim=1)
    flat = refi * (5 * H * W) + shape * (H * W) + dom_y * W + dom_x
    s_d = wsums.reshape(-1)[flat].to(torch.int64)

    n = torch.ones_like(log2n) << log2n
    numer = 50 * n + a * (d * n - s_d) + 100 * n * beta
    rec = torch.div(numer, 100 * n, rounding_mode="floor")
    return torch.clamp(rec, 0, 255).to(torch.int32)


def reconstruct_plane(tree: TransTree, ref: torch.Tensor, H: int, W: int,
                      use_halfpel: bool = True) -> torch.Tensor:
    """Encoder-side reconstruction: resolve the tree then reconstruct."""
    return reconstruct_from_maps(leaf_maps(tree, H, W), ref, H, W, use_halfpel)
