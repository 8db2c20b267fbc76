"""H.264 4x4 intra prediction over anti-diagonal wavefronts.

Port of ``h264tpu/ops/intra.py``: the 9 standard 4x4 prediction modes (spec
8.3.1.2; the reference's ``intrapred_luma`` FR/src/block.c:127) with blocks
coded in wavefronts ``w = 2*by + bx``, every block of a wavefront at once.
The JAX ``lax.scan`` over wavefronts is a Python loop here; each wavefront
handles exactly its own blocks, so no lane is masked.

Each predicted pixel of every mode except DC is ``(Σ w_k·n[i_k] + rnd) >> s``
over the 13 neighbours [corner, top 0..7, left 0..3]; the static tap table
built from the spec's per-pixel rules turns the 8 directional modes into one
gather-multiply-sum.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device_const
from . import transform as T

# mode numbering per spec 8.3.1.1
VERT, HOR, DC, DIAG_DL, DIAG_DR, VERT_R, HOR_D, VERT_L, HOR_U = range(9)
INF_COST = 1 << 29


def wavefront_schedule(cy: int, cx: int):
    """Static schedule for w = 2*by + bx wavefronts.

    Returns (by [S, M], bx [S, M], valid [S, M]) numpy arrays."""
    waves: dict = {}
    for by in range(cy):
        for bx in range(cx):
            waves.setdefault(2 * by + bx, []).append((by, bx))
    S = max(waves) + 1
    M = max(len(v) for v in waves.values())
    a_by = np.zeros((S, M), np.int32)
    a_bx = np.zeros((S, M), np.int32)
    a_ok = np.zeros((S, M), bool)
    for w, blocks in waves.items():
        for i, (by, bx) in enumerate(blocks):
            a_by[w, i] = by
            a_bx[w, i] = bx
            a_ok[w, i] = True
    return a_by, a_bx, a_ok


# --- tap table: neighbour index 0 = corner, 1+i = top i, 9+i = left i ------

def _P(i):
    return 0 if i == -1 else 1 + i


def _L(i):
    return 0 if i == -1 else 9 + i


def _cp(x):
    return [(x, 1)], 0, 0


def _avg2(x, y):
    return [(x, 1), (y, 1)], 1, 1


def _tap3(x, y, z):
    return [(x, 1), (y, 2), (z, 1)], 2, 2


def _rule(mode, r, c):
    """(taps, rnd, shift) of pixel (r, c) for a directional mode (spec
    8.3.1.2.x, in the order of the JAX package's predict_modes_4x4)."""
    if mode == VERT:
        return _cp(_P(c))
    if mode == HOR:
        return _cp(_L(r))
    if mode == DIAG_DL:
        i = r + c
        if i == 6:
            return [(_P(6), 1), (_P(7), 3)], 2, 2
        return _tap3(_P(i), _P(i + 1), _P(i + 2))
    if mode == DIAG_DR:
        if c > r:
            i = c - r
            return _tap3(_P(i - 2), _P(i - 1), _P(i))
        if c < r:
            i = r - c
            return _tap3(_L(i - 2), _L(i - 1), _L(i))
        return _tap3(_P(0), 0, _L(0))
    if mode == VERT_R:
        z, i = 2 * c - r, c - (r >> 1)
        if z >= 0 and z % 2 == 0:
            return _avg2(_P(i - 1), _P(i))
        if z >= 0:
            return _tap3(_P(i - 2), _P(i - 1), _P(i))
        if z == -1:
            return _tap3(_L(0), 0, _P(0))
        j = r - 2 * c
        return _tap3(_L(j - 1), _L(j - 2), _L(j - 3))
    if mode == HOR_D:
        z, i = 2 * r - c, r - (c >> 1)
        if z >= 0 and z % 2 == 0:
            return _avg2(_L(i - 1), _L(i))
        if z >= 0:
            return _tap3(_L(i - 2), _L(i - 1), _L(i))
        if z == -1:
            return _tap3(_P(0), 0, _L(0))
        j = c - 2 * r
        return _tap3(_P(j - 1), _P(j - 2), _P(j - 3))
    if mode == VERT_L:
        i = c + (r >> 1)
        if r % 2 == 0:
            return _avg2(_P(i), _P(i + 1))
        return _tap3(_P(i), _P(i + 1), _P(i + 2))
    if mode == HOR_U:
        z, i = c + 2 * r, r + (c >> 1)
        if z > 5:
            return _cp(_L(3))
        if z == 5:
            return [(_L(2), 1), (_L(3), 3)], 2, 2
        if z % 2 == 0:
            return _avg2(_L(i), _L(i + 1))
        return _tap3(_L(i), _L(i + 1), _L(i + 2))
    raise ValueError(mode)


def _tap_tables():
    modes = [m for m in range(9) if m != DC]
    idx = np.zeros((8, 16, 3), np.int64)
    wgt = np.zeros((8, 16, 3), np.int32)
    rnd = np.zeros((8, 16), np.int32)
    sh = np.zeros((8, 16), np.int32)
    for mi, mode in enumerate(modes):
        for r in range(4):
            for c in range(4):
                taps, rd, s = _rule(mode, r, c)
                for k, (n, w) in enumerate(taps):
                    idx[mi, 4 * r + c, k] = n
                    wgt[mi, 4 * r + c, k] = w
                rnd[mi, 4 * r + c] = rd
                sh[mi, 4 * r + c] = s
    return idx, wgt, rnd, sh


_TAPS = _tap_tables()


def predict_modes_4x4(A: torch.Tensor, L: torch.Tensor, avail_top, avail_left,
                      avail_tr):
    """All 9 4x4 predictions for a batch of blocks (spec 8.3.1.2).

    A: [M, 9] — corner p[-1,-1] then top p[0..7,-1] (top + top-right);
    L: [M, 4] — left p[-1,0..3].  avail_*: [M] bool.
    Returns preds [M, 9, 4, 4] int32, allowed [M, 9] bool.
    """
    dev = A.device
    M = A.shape[0]
    # unavailable top-right replicates the last top pixel
    top_r = torch.where(avail_tr[:, None], A[:, 5:9], A[:, 4:5])
    nb = torch.cat([A[:, :5], top_r, L], dim=1)            # [M, 13]
    idx, wgt, rnd, sh = (device_const(f"intra_taps{k}", t, dev)
                         for k, t in enumerate(_TAPS))
    p8 = ((nb[:, idx] * wgt).sum(dim=-1, dtype=torch.int32) + rnd) >> sh

    both = avail_top & avail_left
    s_t = A[:, 1:5].sum(dim=1, dtype=torch.int32)
    s_l = L.sum(dim=1, dtype=torch.int32)
    dc = torch.where(both, (s_t + s_l + 4) >> 3,
                     torch.where(avail_top, (s_t + 2) >> 2,
                                 torch.where(avail_left, (s_l + 2) >> 2, 128)))
    preds = torch.cat([p8[:, :2], dc[:, None, None].expand(M, 1, 16), p8[:, 2:]],
                      dim=1).reshape(M, 9, 4, 4)
    ones = torch.ones_like(avail_top)
    allowed = torch.stack([avail_top, avail_left, ones, avail_top, both, both,
                           both, avail_top, avail_left], dim=1)
    return preds, allowed


def _lambda_penalty(qp: int) -> int:
    """JM-style non-RDO penalty for coding a non-most-probable mode:
    ``round(3.4 * 2^((qp-12)/3))`` in float32 (round half to even), at least
    1.  XLA evaluates ``/3`` as ``*(1/3)``; so does this."""
    f32 = np.float32
    x = (f32(qp) - f32(12.0)) * (f32(1.0) / f32(3.0))
    p = np.round(f32(4.0 * 0.85) * np.exp2(x, dtype=f32))
    return int(max(1, p))


_SCHEDULES: dict = {}


def _schedule(H: int, W: int, device):
    """Per-wavefront flat index tables on ``device``, padded to [S, M, .];
    step s uses the first counts[s] lanes.  Built once per (H, W, device)."""
    key = (H, W, str(device))
    if key not in _SCHEDULES:
        _SCHEDULES[key] = _build_schedule(H, W, device)
    return _SCHEDULES[key]


def _build_schedule(H: int, W: int, device):
    cy, cx = H // 4, W // 4
    a_by, a_bx, a_ok = wavefront_schedule(cy, cx)
    key = f"wavefront{H}x{W}"
    py, px = a_by * 4, a_bx * 4
    rows_a = np.clip(py - 1, 0, H - 1)[..., None]
    cols_a = np.clip(px[..., None] + np.arange(-1, 8), 0, W - 1)
    rows_l = np.clip(py[..., None] + np.arange(4), 0, H - 1)
    cols_l = np.clip(px - 1, 0, W - 1)[..., None]
    pix = ((py[..., None, None] + np.arange(4)[:, None]) * W
           + px[..., None, None] + np.arange(4)[None, :]).reshape(*py.shape, 16)
    tables = dict(
        a_idx=(rows_a * W + cols_a).astype(np.int64),
        l_idx=(rows_l * W + cols_l).astype(np.int64),
        pix=pix.astype(np.int64),
        cell=(a_by * cx + a_bx).astype(np.int64),
        left=(a_by * cx + np.maximum(a_bx - 1, 0)).astype(np.int64),
        top=(np.maximum(a_by - 1, 0) * cx + a_bx).astype(np.int64),
        avail_top=py > 0, avail_left=px > 0,
        avail_tr=(py > 0) & (px + 4 < W))
    out = {k: device_const(key + k, v, device) for k, v in tables.items()}
    out["counts"] = a_ok.sum(axis=1).tolist()
    return out


def _wavefront_scan(H: int, W: int, qp: int, org=None, modes_in=None,
                    levels_in=None, device=None):
    """Shared encode/decode wavefront scan.

    Encode (org given): picks modes + levels.  Decode (modes_in, levels_in
    given): reconstructs with transmitted data.  Both maintain the running
    reconstruction buffer that predictions read from.
    """
    cy, cx = H // 4, W // 4
    dev = org.device if org is not None else modes_in.device
    sch = _schedule(H, W, dev)
    decode = org is None
    penalty = _lambda_penalty(qp)
    mode_ids = device_const("arange9", np.arange(9, dtype=np.int32), dev)

    buf = torch.full((H * W,), 128, dtype=torch.int32, device=dev)
    if decode:
        modes = modes_in.to(torch.int32).reshape(-1)
        levels = levels_in.to(torch.int32).reshape(cy * cx, 16)
    else:
        org_flat = org.to(torch.int32).reshape(-1)
        modes = torch.zeros(cy * cx, dtype=torch.int32, device=dev)
        levels = torch.zeros((cy * cx, 16), dtype=torch.int32, device=dev)

    for s, m in enumerate(sch["counts"]):
        def lane(name):
            return sch[name][s, :m]

        at, al = lane("avail_top"), lane("avail_left")
        preds, allowed = predict_modes_4x4(buf[lane("a_idx")], buf[lane("l_idx")],
                                           at, al, lane("avail_tr"))
        lanes = torch.arange(m, device=dev)
        cell = lane("cell")
        if decode:
            pred = preds[lanes, modes[cell].long()]
            deq = T.dequant4x4(T.zigzag_unscan(levels[cell]), qp)
            rec = T.reconstruct(pred, T.idct4x4(deq))
        else:
            org_blocks = org_flat[lane("pix")].reshape(m, 4, 4)
            sad = torch.abs(preds - org_blocks[:, None]).sum(dim=(2, 3),
                                                             dtype=torch.int32)
            left_m = torch.where(al, modes[lane("left")], DC)
            top_m = torch.where(at, modes[lane("top")], DC)
            mpm = torch.minimum(left_m, top_m)
            cost = sad + penalty * (mode_ids[None, :] != mpm[:, None]).to(torch.int32)
            cost = torch.where(allowed, cost, INF_COST)
            mode = torch.argmin(cost, dim=1)
            pred = preds[lanes, mode]
            lev, rec = T.transform_quant_reconstruct(org_blocks - pred, pred, qp)
            modes[cell] = mode.to(torch.int32)
            levels[cell] = T.zigzag_scan(lev)
        buf[lane("pix")] = rec.reshape(m, 16)
    return modes.reshape(cy, cx), levels, buf.reshape(H, W)


def encode_plane(org: torch.Tensor, qp: int):
    """Intra-code a plane. Returns (modes [CY,CX], zz [CY*CX,16], recon)."""
    H, W = org.shape
    return _wavefront_scan(H, W, qp, org=org)


def decode_plane(modes: torch.Tensor, zz: torch.Tensor, H: int, W: int,
                 qp: int) -> torch.Tensor:
    """Reconstruct a plane from transmitted modes + levels (bit-exact with
    the encoder's reconstruction)."""
    return _wavefront_scan(H, W, qp, modes_in=modes, levels_in=zz)[2]
