"""Distortion metrics: PSNR, SSIM, MS-SSIM on tensors, on the caller's
device.  A tensor stays on its own device unless ``device`` is given; numpy
input goes to ``device``, which defaults to the card as every entry point of
the package does (with no card and no device given they raise).

Port of ``h264tpu/utils/metrics.py`` (JM 18.5's metric layer):

* PSNR    — mean squared error over the plane (FR/src/code.c:514 `PSNR`);
* SSIM    — img_dist_ssim.c:22 `compute_ssim`: uniform win x win windows
            stepped by `overlap`, biased variance, K1 = 0.01, K2 = 0.03;
* MS-SSIM — img_dist_ms_ssim.c:279: five levels with exponents BETA0..4,
            the structural term per level and the luminance term once at
            the coarsest, dyadic downsampling by the separable
            [1 3 28 28 3 1]/64 filter with symmetric edge extension.

Window statistics come from integral images, as in the JAX package, but in
float64: for integer pixels every prefix sum is an exact integer, so the
window sums are exact whatever order the device sums in, and the CPU and the
card agree.  The JAX package sums in float32, whose prefix sums of squared
pixels round once they pass 2^24; the two packages differ by that rounding
(the tests state the tolerance).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device

_K1, _K2 = 0.01, 0.03
_MS_SSIM_BETA = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
_DS_TAPS = (1.0, 3.0, 28.0, 28.0, 3.0, 1.0)


def _f64(x, device) -> torch.Tensor:
    """``x`` as float64: a tensor on its own device unless ``device`` is
    given, anything else on ``resolve_device(device)``."""
    if torch.is_tensor(x) and device is None:
        return x.to(torch.float64)
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x
                           ).to(device=resolve_device(device),
                                dtype=torch.float64)


def psnr(ref, enc, max_pel: int = 255, device=None) -> torch.Tensor:
    """PSNR in dB over the plane; 99.99 where the planes are equal."""
    mse = ((_f64(ref, device) - _f64(enc, device)) ** 2).mean()
    return torch.where(mse == 0, 99.99, 10.0 * torch.log10(
        max_pel * max_pel / torch.clamp(mse, min=1e-12)))


def _window_sums(x: torch.Tensor, win_h: int, win_w: int, step: int):
    """Sum over every win_h x win_w window at stride ``step``."""
    ii = torch.nn.functional.pad(x.cumsum(0).cumsum(1), (1, 0, 1, 0))
    H, W = x.shape
    ys = torch.arange(0, H - win_h + 1, step, device=x.device)[:, None]
    xs = torch.arange(0, W - win_w + 1, step, device=x.device)[None, :]
    return (ii[ys + win_h, xs + win_w] - ii[ys, xs + win_w]
            - ii[ys + win_h, xs] + ii[ys, xs])


def _window_moments(ref, enc, win: int, step: int):
    n = float(win * win)
    s_o, s_e = _window_sums(ref, win, win, step), _window_sums(enc, win, win, step)
    s_oo = _window_sums(ref * ref, win, win, step)
    s_ee = _window_sums(enc * enc, win, win, step)
    s_oe = _window_sums(ref * enc, win, win, step)
    mu_o, mu_e = s_o / n, s_e / n
    # biased variance: the window's pixel count as denominator
    return (mu_o, mu_e, (s_oo - s_o * mu_o) / n, (s_ee - s_e * mu_e) / n,
            (s_oe - s_o * mu_e) / n)


def ssim(ref, enc, max_pel: int = 255, win: int = 8,
         overlap: int = 8, device=None) -> torch.Tensor:
    """Mean SSIM over the window lattice (img_dist_ssim.c:22)."""
    c1 = _K1 * _K1 * max_pel * max_pel
    c2 = _K2 * _K2 * max_pel * max_pel
    mu_o, mu_e, var_o, var_e, cov = _window_moments(
        _f64(ref, device), _f64(enc, device), win, overlap)
    num = (2.0 * mu_o * mu_e + c1) * (2.0 * cov + c2)
    den = (mu_o * mu_o + mu_e * mu_e + c1) * (var_o + var_e + c2)
    return (num / den).mean()


def _downsample(x: torch.Tensor) -> torch.Tensor:
    """Dyadic 2x downsample by the separable [1 3 28 28 3 1]/64 filter with
    symmetric edge extension (img_dist_ms_ssim.c:225); rounded half to
    even and clipped to 0..255.  Exact in float64 for integer input."""
    taps = torch.tensor(_DS_TAPS, dtype=torch.float64, device=x.device) / 64.0

    def one_axis(v):                     # filter and decimate the last axis
        W = v.shape[1]
        idx = torch.arange(-2, W + 3, device=v.device)
        idx = torch.where(idx < 0, -idx - 1, torch.where(idx >= W,
                                                         2 * W - 1 - idx, idx))
        p = v[:, idx]
        pos = 2 * torch.arange(W // 2, device=v.device)[:, None] \
            + torch.arange(6, device=v.device)[None, :]
        return (p[:, pos] * taps).sum(dim=-1)

    x = one_axis(x)
    x = one_axis(x.T).T
    return torch.clamp(torch.round(x), 0, 255)


def ms_ssim(ref, enc, max_pel: int = 255, win: int = 8, overlap: int = 8,
            levels: int = 5, device=None) -> torch.Tensor:
    """Multi-scale SSIM, JM semantics (img_dist_ms_ssim.c:279): product of
    the per-level structural terms ** BETA[m], times the coarsest level's
    luminance term ** BETA[last]."""
    ref, enc = _f64(ref, device), _f64(enc, device)
    c1 = _K1 * _K1 * max_pel * max_pel
    c2 = _K2 * _K2 * max_pel * max_pel
    out = torch.ones((), dtype=torch.float64, device=ref.device)
    for m in range(levels):
        w = min(win, ref.shape[0], ref.shape[1])
        mu_o, mu_e, var_o, var_e, cov = _window_moments(ref, enc, w,
                                                        min(overlap, w))
        s = ((2.0 * cov + c2) / (var_o + var_e + c2)).mean()
        out = out * s.abs() ** _MS_SSIM_BETA[m]
        if m == levels - 1:
            lum = ((2.0 * mu_o * mu_e + c1)
                   / (mu_o * mu_o + mu_e * mu_e + c1)).mean()
            out = out * lum.abs() ** _MS_SSIM_BETA[m]
        else:
            ref, enc = _downsample(ref), _downsample(enc)
    return out


def frame_metrics(ref_yuv, enc_yuv, max_pel: int = 255, device=None) -> dict:
    """Per-plane PSNR and SSIM of one (Y, U, V) frame pair — the row of JM's
    `find_distortion` report (img_distortion.c:95)."""
    out = {}
    for name, r, e in zip(("y", "u", "v"), ref_yuv, enc_yuv):
        out[f"psnr_{name}"] = float(psnr(r, e, max_pel, device=device))
        out[f"ssim_{name}"] = float(ssim(r, e, max_pel, device=device))
    return out
