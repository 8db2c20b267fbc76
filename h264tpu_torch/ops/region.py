"""Object/region-based fractal coding on tensors.

Port of ``h264tpu/ops/region.py``: with two regions each 16x16 range block
is fitted per object against the alpha-plane masks (``classify``,
FR/src/compute.c:218).  Only range pixels whose current-frame mask matches
the object enter the fit; domain pixels whose reference-frame mask does not
match are replaced by the average of the matching ones (compute.c:246-273).
Blocks that straddle both objects are coded once per object and merged pixel
by pixel by the mask (block_dec.c:32-151).

The per-candidate masked sums are five products of the masks, the range and
the shifted domain planes pooled to 16x16 cells, for every spiral offset and
reference plane at once (in chunks of offsets).  The fit is float32 as in the
JAX package, with XLA's CPU fusions written out: ``x / 100`` is
``x * (1/100)`` and the five multiply-adds of the rms are single-rounding
FMAs (:func:`_fma`), so the rms that decides each block's parameters is the
reference's bit for bit.
"""

from __future__ import annotations

import torch

from .. import device_const
from .fractal import (A_MAX, A_MIN, BETA_MAX, BETA_MIN, INF_RMS, _F32_INV100,
                      _f32, _fma, build_reference_stack, first_min,
                      quan_a, spiral_offsets)
from .segment import GREY_LEVELS

MB = 16


def _pool16(x: torch.Tensor) -> torch.Tensor:
    """Sum the trailing [H, W] into 16x16 cells, int32."""
    *lead, H, W = x.shape
    return x.reshape(*lead, H // MB, MB, W // MB, MB).sum(dim=(-3, -1),
                                                          dtype=torch.int32)


def _split_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact float32 value of the int32 product a*b (a, b >= 0, a*b < 2^40)
    as a*(b>>8)*256 + a*(b&255), each piece below 2^24; the sum rounds."""
    return _f32(a * (b >> 8)) * 256.0 + _f32(a * (b & 255))


def _masked_fit(n, s_r, s_r2, s_d, s_d2, s_rd):
    """compute_rms (FR/src/compute.c:6) over n masked range pixels; int32
    sums in, (a = α·100, beta, rms float32) out."""
    num = _split_mul(n, s_rd) - _split_mul(s_r, s_d)
    det = _split_mul(n, s_d2) - _split_mul(s_d, s_d)
    det_zero = det == 0.0
    alpha = torch.where(det_zero, 0.0, num / torch.where(det_zero, 1.0, det))
    a = torch.where(det_zero, 0, quan_a(
        torch.clamp(torch.trunc(alpha * 100.0), -1e6, 1e6).to(torch.int32)))
    n1 = torch.clamp(n, min=1)
    beta = quan_a(torch.div(s_r, n1, rounding_mode="floor"))
    ok = ((n > 0) & (a >= A_MIN) & (a <= A_MAX)
          & (beta >= BETA_MIN) & (beta <= BETA_MAX))

    aq = _f32(a) * _F32_INV100
    nf = _f32(n1)
    sdf, sd2f, srdf, srf = _f32(s_d), _f32(s_d2), _f32(s_rd), _f32(s_r)
    mean_term = _f32(beta) - aq * sdf / nf
    inner = _fma(2.0 * mean_term, sdf, _fma(aq, sd2f, -2.0 * srdf))
    rms = _fma(mean_term, _fma(mean_term, nf, -2.0 * srf),
               _fma(aq, inner, _f32(s_r2)))
    return (torch.where(ok, a, 0), torch.where(ok, beta, 0),
            torch.where(ok, rms, INF_RMS))


def _effective_sums(n_r, s_r, n_m, s_dm, s_d2m, s_rdm, s_rm):
    """Average-replacement of mismatched domain pixels (compute.c:258-273):
    avg = Σ_match d // n_match, which every non-matching pixel contributes."""
    avg = torch.where(n_m > 0, torch.div(s_dm, torch.clamp(n_m, min=1),
                                         rounding_mode="floor"), 0)
    miss = n_r - n_m
    return (s_dm + miss * avg, s_d2m + miss * avg * avg,
            s_rdm + (s_r - s_rm) * avg)


def region_search_plane(org: torch.Tensor, ref: torch.Tensor,
                        mask_cur: torch.Tensor, mask_ref: torch.Tensor, *,
                        search_range: int, use_halfpel: bool = True,
                        chunk: int = 32) -> dict:
    """Masked 16x16 fractal search of both objects of a 2-region alpha plane.

    Returns a dict of [2, H/16, W/16] tensors a, beta, dx, dy, ref, rms and n
    (masked pixel count), object axis first (0 = background, 1 = object).
    Among equal rms the first candidate in (reference, spiral) order wins,
    as in the reference's full search (block_enc.c:1933)."""
    dev = org.device
    org = org.to(torch.int32)
    H, W = org.shape
    sr = search_range
    offsets = spiral_offsets(sr)
    n_off = offsets.shape[0]
    offs = device_const(f"region_spiral{sr}", offsets, dev)
    refs = build_reference_stack(ref, use_halfpel)
    R = refs.shape[0]
    m_cur = mask_cur.to(device=dev, dtype=torch.int32) // GREY_LEVELS
    m_ref = mask_ref.to(device=dev, dtype=torch.int32) // GREY_LEVELS
    oy = torch.arange(H // MB, device=dev)[:, None] * MB
    ox = torch.arange(W // MB, device=dev)[None, :] * MB

    def pad(x):
        return torch.nn.functional.pad(x, (sr, sr, sr, sr))

    def per_obj(obj):
        mr = (m_cur == obj).to(torch.int32)
        md = (m_ref == obj).to(torch.int32)
        mr_r = mr * org
        n_r, s_r, s_r2 = _pool16(mr), _pool16(mr_r), _pool16(mr_r * org)
        p_md, p_mdd, p_mdd2 = pad(md), pad(md * refs), pad(md * refs * refs)
        a_l, b_l, rms_l = [], [], []
        for s in range(0, n_off, chunk):
            oc = [(int(x), int(y)) for x, y in offsets[s:s + chunk]]

            def shifted(p):
                return torch.stack([p[..., sr + y:sr + y + H,
                                      sr + x:sr + x + W] for x, y in oc],
                                   dim=-3)

            smd, smdd, smdd2 = shifted(p_md), shifted(p_mdd), shifted(p_mdd2)
            n_m, s_rm = _pool16(mr * smd), _pool16(mr_r * smd)
            s_d, s_d2, s_rd = _effective_sums(
                n_r, s_r, n_m, _pool16(mr * smdd), _pool16(mr * smdd2),
                _pool16(mr_r * smdd), s_rm)
            a, beta, rms = _masked_fit(n_r, s_r, s_r2, s_d, s_d2, s_rd)
            dx = offs[s:s + chunk, 0][:, None, None]
            dy = offs[s:s + chunk, 1][:, None, None]
            valid = ((oy + dy >= 0) & (oy + dy + MB <= H)
                     & (ox + dx >= 0) & (ox + dx + MB <= W))
            a_l.append(a)
            b_l.append(beta)
            rms_l.append(torch.where(valid, rms, INF_RMS))
        best, sel = first_min(torch.cat(rms_l, dim=1).reshape(
            R * n_off, H // MB, W // MB))

        def take(parts):
            x = torch.cat(parts, dim=1).reshape(R * n_off, H // MB, W // MB)
            return torch.gather(x, 0, sel[None])[0]

        off_idx = sel % n_off
        return dict(a=take(a_l), beta=take(b_l), rms=best,
                    dx=offs[:, 0][off_idx], dy=offs[:, 1][off_idx],
                    ref=(sel // n_off).to(torch.int32), n=n_r)

    out0, out1 = per_obj(0), per_obj(1)
    return {k: torch.stack([out0[k], out1[k]]) for k in out0}


def region_reconstruct(params: dict, ref: torch.Tensor, mask_cur: torch.Tensor,
                       mask_ref: torch.Tensor,
                       use_halfpel: bool = True) -> torch.Tensor:
    """Merged reconstruction from per-object 16x16 params and the masks:
    per object rec = clip(floor((50N + a(d_eff·N − S_eff) + 100Nβ) / (100N)))
    with d_eff = d where the domain mask matches, else the matching-domain
    average (block_dec.c:32-151); pixels merge by the current-frame mask.
    Encoder and decoder run it alike (the masks are side information)."""
    dev = ref.device
    m_cur = mask_cur.to(device=dev, dtype=torch.int32) // GREY_LEVELS
    m_ref = mask_ref.to(device=dev, dtype=torch.int32) // GREY_LEVELS
    H, W = m_cur.shape
    refs = build_reference_stack(ref, use_halfpel).to(torch.int64)
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]

    def up(m):
        return m.repeat_interleave(MB, dim=0).repeat_interleave(MB, dim=1)

    def per_obj(obj):
        a, beta, dx, dy, ridx = (up(params[k][obj].to(device=dev,
                                                      dtype=torch.int64))
                                 for k in ("a", "beta", "dx", "dy", "ref"))
        sy = torch.clamp(yy + dy, 0, H - 1)
        sx = torch.clamp(xx + dx, 0, W - 1)
        d = refs.reshape(-1)[ridx * (H * W) + sy * W + sx]
        md = m_ref.reshape(-1)[sy * W + sx] == obj
        mr = (m_cur == obj).to(torch.int64)
        match = mr * md
        n_m = up(_pool16(match))
        avg = torch.where(n_m > 0, torch.div(
            up(_pool16(match * d)), torch.clamp(n_m, min=1),
            rounding_mode="floor"), 0)
        d_eff = torch.where(md, d, avg)
        n1 = torch.clamp(up(_pool16(mr)), min=1).to(torch.int64)
        s_eff = up(_pool16(mr * d_eff))
        numer = 50 * n1 + a * (d_eff * n1 - s_eff) + 100 * n1 * beta
        return torch.clamp(torch.div(numer, 100 * n1, rounding_mode="floor"),
                           0, 255)

    return torch.where(m_cur == 0, per_obj(0), per_obj(1)).to(torch.int32)
