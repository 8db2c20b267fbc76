"""Explicit weighted-prediction estimators (host, numpy).

Copies of ``estimate_wp`` and ``estimate_wp_lms`` from
``h264tpu/avc/codec.py``, which ``AVCCodec`` and ``TPUAVCCodec`` call
once per P frame; the port imports nothing from ``h264tpu``.  Both round
with Python's ``round`` (half to even), as the reference does: the weights
are written into the slice header, so the stream's bytes depend on it.
The LMS estimator reads the list-0 references as reference planes or as
plain (y, u, v) planes.
"""

from __future__ import annotations

import numpy as np

from .inter import PAD


def estimate_wp(org_yuv, ref_means, d_l: int = 5, d_c: int = 5):
    """Explicit WP weights by DC ratio (JM wp_lms.c method-0 shape):
    w = round(dc_org * 2^d / dc_ref) clipped to [-128, 127], offset 0.
    ``ref_means``: list of (dc_y, dc_u, dc_v) per list-0 reference."""
    dcs = tuple(float(np.asarray(p, np.float64).mean()) for p in org_yuv)

    def w_of(dc_o, dc_r, d):
        if dc_r <= 0.1:
            return 1 << d
        return int(np.clip(round(dc_o * (1 << d) / dc_r), -128, 127))

    l0 = []
    for (ry, ru, rv) in ref_means:
        l0.append((w_of(dcs[0], ry, d_l), 0, w_of(dcs[1], ru, d_c), 0,
                   w_of(dcs[2], rv, d_c), 0))
    return dict(d_l=d_l, d_c=d_c, l0=l0)


def estimate_wp_lms(org_yuv, refs, d_l: int = 5, d_c: int = 5):
    """Explicit WP weights by least squares (JM wp_lms.c
    ComputeExplicitWPParamsLMS shape): per plane and reference, (w, o)
    minimize ||org - (w*ref/2^d + o)|| in closed form —
    w = 2^d * cov(org, ref) / var(ref), o = mean(org) - w*mean(ref)/2^d,
    both clipped to the se(v) range [-128, 127].  Unlike the DC-ratio
    method this fits a gain and an offset, so additive fades (org = ref +
    c) get w = 2^d, o = c.  ``refs``: list-0 references, most recent
    first — :class:`~.inter.RefPlanes` objects (the host ``AVCCodec``'s
    DPB) or plain (y, u, v) plane tuples (the device codec's host
    copies)."""
    org = [np.asarray(pl, np.float64) for pl in org_yuv]
    l0 = []
    for rp in refs:
        if hasattr(rp, "G"):
            h, w, P = rp.h, rp.w, PAD
            rp = (rp.G[P:P + h, P:P + w], rp.u[P:P + h // 2, P:P + w // 2],
                  rp.v[P:P + h // 2, P:P + w // 2])
        e = []
        for o_pl, r_pl, d in zip(org, rp, (d_l, d_c, d_c)):
            r_pl = np.asarray(r_pl).astype(np.float64)
            mo, mr = o_pl.mean(), r_pl.mean()
            den = ((r_pl - mr) ** 2).sum()
            if den < 1e-6:
                wgt = 1 << d
            else:
                g = ((o_pl - mo) * (r_pl - mr)).sum() / den
                wgt = int(np.clip(round(g * (1 << d)), -128, 127))
            off = int(np.clip(round(mo - wgt * mr / (1 << d)), -128, 127))
            e += [wgt, off]
        l0.append(tuple(e))
    return dict(d_l=d_l, d_c=d_c, l0=l0)
