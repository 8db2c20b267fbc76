"""Plain reference of the fractal codec's cells.

Four checks of what the window wrote:

* ``decode_frame``: the FVC payload of a frame, decoded by the frozen copy of
  the decoder (``frozen/``, plain PyTorch on the CPU), must give the
  encoder's reconstruction exactly.  A P frame is decoded from the encoder's
  reconstruction of the frame before it; a clip's I frame from nothing.
* ``search_gaps``: for leaves of a P frame's quadtree, the squared error of
  the parameters the stream carries against the least squared error that any
  candidate of the full search reaches (every offset of the +-SR window, each
  of the four half-pel planes, the quantised least-squares alpha/beta fit),
  both computed here exactly in float64 from integer sums.
* ``residual_mismatch``: a P frame's decoded residual levels against the
  residual coding of source minus the decoded fractal prediction at the
  frame's QP (4x4 transform, the quantiser, the coefficient-cost drops), an
  exact comparison.
* ``split_violations``: for macroblocks of a P frame, the quadtree the
  stream carries against the split rule of the configuration's tolerances
  (``split_rule``), with the least squared errors of the full search.
"""

from __future__ import annotations

import numpy as np
import torch

from .frozen.entropy import fractal_syntax as FS
from .frozen.entropy.bitio import BitReader
from .frozen.ops import deblock as DB
from .frozen.ops import fractal as F
from .frozen.ops import intra as IN
from .frozen.ops import transform as T

HEADER_BYTES = 22      # the FVC stream header (version 2) is 176 bits
_CPU = torch.device("cpu")


def split_payloads(stream: bytes, frame_bytes):
    """(header dict, [payload bytes of each frame]) of a raw FVC stream,
    cut at the frame sizes the encoder reported; raises unless the sizes
    tile the stream exactly and the header counts as many frames."""
    hdr = FS.read_header(BitReader(stream[:HEADER_BYTES]))
    if hdr["version"] != 2 or sum(frame_bytes) + HEADER_BYTES != len(stream):
        raise ValueError("frame sizes do not tile the FVC stream")
    if hdr["num_frames"] != len(frame_bytes):
        raise ValueError("the FVC header counts another number of frames")
    out, pos = [], HEADER_BYTES
    for n in frame_bytes:
        out.append(stream[pos:pos + n])
        pos += n
    return hdr, out


def _pad16(plane: torch.Tensor) -> torch.Tensor:
    h, w = plane.shape
    rows = torch.clamp(torch.arange(h + (-h) % 16), max=h - 1)
    cols = torch.clamp(torch.arange(w + (-w) % 16), max=w - 1)
    return plane[rows][:, cols]


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int32)).to(_CPU)


def _add_residual(pred, zz, h, w, qp):
    deq = T.dequant4x4(T.zigzag_unscan(zz), qp)
    rec = T.reconstruct(T.frame_to_blocks(pred, 4), T.idct4x4(deq))
    return T.blocks_to_frame(rec, h, w)


def decode_frame(hdr: dict, payload: bytes, ref=None,
                 loop_filter: bool = True, details: list = None):
    """Decode one fractal (type 1) or intra (type 0) frame payload.

    Returns ((Y, U, V) uint8 numpy, [leaf maps of each plane] or None for
    an intra frame).  ``ref``: the (Y, U, V) reference picture of a P
    frame.  ``loop_filter=False`` leaves out the in-loop filter that the
    stream's header turns on: the control of ``PERF.md``.  ``details``: a
    list that gets, for each plane of a P frame, its fractal prediction
    ``frec`` and decoded levels ``zz`` (int32 tensors)."""
    W, H = hdr["width"], hdr["height"]
    groups = max(hdr["tile_rows"], 1)
    r = BitReader(payload)
    ftype, fqp = r.u(8), r.u(8)
    cqp = T.chroma_qp(fqp)
    dims = ((H, W, True, fqp), (H // 2, W // 2, False, cqp),
            (H // 2, W // 2, False, cqp))
    planes, all_maps = [], []
    for pi, (h, w, luma, q) in enumerate(dims):
        if ftype == 0:
            modes = FS.read_intra_modes(r, h // 4, w // 4)
            zz = FS.read_residual(r, h // 4, w // 4, hdr["entropy"])
            rec = IN.decode_plane(_t(modes), _t(zz), h, w, q)
            if hdr["deblock"] and loop_filter:
                bs_v, bs_h = DB.strengths_intra(h, w, _CPU)
                rec = DB.deblock_plane_grouped(rec, bs_v, bs_h, q, luma,
                                               groups)
        elif ftype == 1:
            refp = _pad16(_t(ref[pi]))
            hp, wp = refp.shape
            maps = FS.read_tree(r, hp, wp, hdr["search_range"],
                                hdr["use_halfpel"])
            zz = _t(FS.read_residual(r, h // 4, w // 4, hdr["entropy"]))
            tmaps = {k: _t(m) for k, m in maps.items()}
            frec = F.reconstruct_from_maps(tmaps, refp, hp, wp,
                                           hdr["use_halfpel"])[:h, :w]
            rec = _add_residual(frec, zz, h, w, q)
            if details is not None:
                details.append(dict(frec=frec, zz=zz))
            if hdr["deblock"] and loop_filter:
                nz = (zz != 0).any(dim=-1).reshape(h // 4, w // 4)
                bs_v, bs_h = DB.strengths_fractal(
                    {k: m[:h // 4, :w // 4] for k, m in tmaps.items()}, nz)
                rec = DB.deblock_plane_grouped(rec, bs_v, bs_h, q, luma,
                                               groups)
            all_maps.append(maps)
        else:
            raise ValueError(f"frame type {ftype} is not in the cell")
        planes.append(rec.to(torch.uint8).numpy())
    r.byte_align()
    if r.pos != 8 * len(payload):
        raise ValueError("the frame payload holds bits after the last plane")
    return tuple(planes), (all_maps if ftype == 1 else None)


# ---------------------------------------------------------------------------
# The full search, recomputed for single leaves
# ---------------------------------------------------------------------------

def spiral_offsets(sr: int) -> np.ndarray:
    """Every (dx, dy) of the +-sr window in the codec's tie-break order:
    the centre, then ring l = 1..sr from (-l, -l) right, down, left, up."""
    out = [(0, 0)]
    for ring in range(1, sr + 1):
        i = j = -ring
        for k in range(8 * ring):
            out.append((i, j))
            if k < 2 * ring:
                i += 1
            elif k < 4 * ring:
                j += 1
            elif k < 6 * ring:
                i -= 1
            else:
                j -= 1
    return np.asarray(out, np.int64)


def reference_stack(ref: np.ndarray, use_halfpel: bool) -> np.ndarray:
    """[R, H, W] int64: the plane, then its truncating bilinear half-pel
    planes (right, down, diagonal) with the edge repeated."""
    c = np.asarray(ref, np.int64)
    if not use_halfpel:
        return c[None]
    right = np.concatenate([c[:, 1:], c[:, -1:]], axis=1)
    down = np.concatenate([c[1:], c[-1:]], axis=0)
    dr = np.concatenate([right[1:], right[-1:]], axis=0)
    return np.stack([c, (c + right) // 2, (c + down) // 2,
                     (c + down + right + dr) // 4])


def _quan_a(x: np.ndarray) -> np.ndarray:
    """The alpha/beta quantiser: to multiples of 5 by the remainder of
    truncation toward zero (below 3 down, 3-7 to 5, above 7 up)."""
    x = x.astype(np.int64)
    c = np.sign(x) * (np.abs(x) // 10)
    b = x - c * 10
    return np.where(b > 7, c + 1, c) * 10 + np.where((b > 2) & (b < 8), 5, 0)


def _sse(n, s_r, s_r2, s_d, s_d2, s_rd, a, beta):
    """Exact squared error of r against (a/100)(d - mean d) + beta."""
    aq = a / 100.0
    m = beta - aq * s_d / n
    return (n * m * m - 2 * m * s_r + 2 * aq * m * s_d + aq * aq * s_d2
            - 2 * aq * s_rd + s_r2)


def _pad16_np(plane) -> np.ndarray:
    """The plane with its last row and column repeated up to multiples of
    16, as the codec searches it."""
    p = np.asarray(plane, np.int64)
    h, w = p.shape
    return np.pad(p, ((0, (-h) % 16), (0, (-w) % 16)), mode="edge")


class LeafSearch:
    """The full search of one plane against one reference picture, both
    padded to multiples of 16 as the codec pads them."""

    def __init__(self, org: np.ndarray, ref: np.ndarray, sr: int,
                 use_halfpel: bool, bounds):
        self.org = _pad16_np(org)
        ref = _pad16_np(ref)
        self.H, self.W = self.org.shape
        self.sr = sr
        self.offsets = spiral_offsets(sr)
        stack = reference_stack(ref, use_halfpel)
        self.R = stack.shape[0]
        self.pad = np.pad(stack, ((0, 0), (sr, sr), (sr, sr)))
        self.bounds = bounds           # (a_min, a_max, beta_min, beta_max)

    def candidates(self, y0: int, x0: int, bh: int, bw: int):
        """Integer sums of every candidate of the block at (y0, x0):
        (n, s_r, s_r2, [R, n_off] s_d, s_d2, s_rd, valid)."""
        sr = self.sr
        r = self.org[y0:y0 + bh, x0:x0 + bw]
        win = self.pad[:, y0:y0 + bh + 2 * sr, x0:x0 + bw + 2 * sr]
        views = np.lib.stride_tricks.sliding_window_view(
            win, (bh, bw), axis=(1, 2))                  # [R, 2sr+1, 2sr+1, bh, bw]
        dy = self.offsets[:, 1] + sr
        dx = self.offsets[:, 0] + sr
        d = views[:, dy, dx]                             # [R, n_off, bh, bw]
        s_d = d.sum(axis=(2, 3))
        s_d2 = (d * d).sum(axis=(2, 3))
        s_rd = np.einsum("ropq,pq->ro", d, r)
        yy = y0 + self.offsets[:, 1]
        xx = x0 + self.offsets[:, 0]
        valid = (yy >= 0) & (yy + bh <= self.H) & (xx >= 0) & (xx + bw <= self.W)
        return (bh * bw, int(r.sum()), int((r * r).sum()), s_d, s_d2, s_rd,
                np.broadcast_to(valid, s_d.shape))

    def fit(self, n, s_r, s_d, s_d2, s_rd, dtype=np.float64):
        """(a, beta) of the quantised least-squares fit, alpha computed in
        ``dtype`` (torch.bfloat16 for the control)."""
        num = n * s_rd - s_r * s_d
        det = n * s_d2 - s_d * s_d
        if dtype is np.float64:
            alpha = np.where(det == 0, 0.0, num / np.where(det == 0, 1, det))
        else:
            tn = torch.as_tensor(num, dtype=torch.float64).to(dtype)
            td = torch.as_tensor(det, dtype=torch.float64).to(dtype)
            alpha = torch.where(td == 0, torch.zeros_like(tn),
                                tn / torch.where(td == 0, torch.ones_like(td), td))
            alpha = alpha.to(torch.float64).numpy()
        a_raw = np.clip(np.trunc(alpha * 100.0), -1e6, 1e6).astype(np.int64)
        a = np.where(det == 0, 0, _quan_a(a_raw))
        beta = _quan_a(np.asarray(s_r // n))
        return a, np.broadcast_to(beta, a.shape)

    def least(self, y0, x0, bh, bw) -> float:
        """The least squared error that any valid candidate of the block
        reaches (inf where none is valid)."""
        n, s_r, s_r2, s_d, s_d2, s_rd, valid = self.candidates(y0, x0, bh, bw)
        a, beta = self.fit(n, s_r, s_d, s_d2, s_rd)
        amin, amax, bmin, bmax = self.bounds
        ok = valid & (a >= amin) & (a <= amax) & (beta >= bmin) & (beta <= bmax)
        return float(np.where(ok, _sse(n, s_r, s_r2, s_d, s_d2, s_rd, a, beta),
                              np.inf).min())

    def gap(self, y0, x0, bh, bw, chosen, dtype=np.float64):
        """Per-pixel squared error of the leaf's parameters above the least
        that any valid candidate reaches.  ``chosen``: (ref, dx, dy, a,
        beta) as the stream carries them, or None to let the search at
        ``dtype`` choose them (the control)."""
        n, s_r, s_r2, s_d, s_d2, s_rd, valid = self.candidates(y0, x0, bh, bw)
        a, beta = self.fit(n, s_r, s_d, s_d2, s_rd)
        amin, amax, bmin, bmax = self.bounds
        ok = valid & (a >= amin) & (a <= amax) & (beta >= bmin) & (beta <= bmax)
        sse = np.where(ok, _sse(n, s_r, s_r2, s_d, s_d2, s_rd, a, beta),
                       np.inf)
        best = sse.min()
        if chosen is None:
            ref, k, ca, cb = self._choose(n, s_r, s_r2, s_d, s_d2, s_rd,
                                          valid, dtype)
        else:
            ref, dx, dy, ca, cb = (int(v) for v in chosen)
            hit = np.flatnonzero((self.offsets[:, 0] == dx)
                                 & (self.offsets[:, 1] == dy))
            if not (0 <= ref < self.R) or hit.size != 1:
                return np.inf
            k = int(hit[0])
            if not (valid[ref, k] and amin <= ca <= amax and bmin <= cb <= bmax):
                return np.inf
        got = _sse(n, s_r, s_r2, s_d[ref, k], s_d2[ref, k], s_rd[ref, k],
                   ca, cb)
        return float((got - best) / n)

    def _choose(self, n, s_r, s_r2, s_d, s_d2, s_rd, valid, dtype):
        """The search in ``dtype``: the fit and the squared error computed
        in it, the first candidate in (plane, spiral) order at the least."""
        a, beta = self.fit(n, s_r, s_d, s_d2, s_rd, dtype)
        amin, amax, bmin, bmax = self.bounds
        ok = valid & (a >= amin) & (a <= amax) & (beta >= bmin) & (beta <= bmax)
        t = {k: torch.as_tensor(np.asarray(v, np.float64)).to(dtype)
             for k, v in dict(s_r=s_r, s_r2=s_r2, s_d=s_d, s_d2=s_d2,
                              s_rd=s_rd, a=a, beta=beta).items()}
        aq = t["a"] / 100.0
        m = t["beta"] - aq * t["s_d"] / n
        sse = (n * m * m - 2 * m * t["s_r"] + 2 * aq * m * t["s_d"]
               + aq * aq * t["s_d2"] - 2 * aq * t["s_rd"] + t["s_r2"])
        sse = torch.where(torch.as_tensor(ok), sse.to(torch.float64),
                          torch.tensor(np.inf, dtype=torch.float64)).numpy()
        flat = int(np.flatnonzero(sse.reshape(-1) == sse.min())[0])
        ref, k = divmod(flat, sse.shape[1])
        return ref, k, int(a[ref, k]), int(beta[ref, k])


def leaves(maps: dict):
    """[(y0, x0, bh, bw, (ref, dx, dy, a, beta))] of every leaf of a plane's
    maps (cell grid), in raster order of the leaves' top-left cells."""
    shape = np.asarray(maps["shape"])
    out = []
    for code, (bh, bw) in enumerate(F.SHAPES):
        ch, cw = bh // 4, bw // 4
        cy = np.arange(shape.shape[0])[:, None]
        cx = np.arange(shape.shape[1])[None, :]
        corner = (shape == code) & (cy % ch == 0) & (cx % cw == 0)
        for y, x in zip(*np.nonzero(corner)):
            out.append((4 * int(y), 4 * int(x), bh, bw,
                        tuple(int(maps[k][y, x])
                              for k in ("ref", "dx", "dy", "a", "beta"))))
    return out


def residual_mismatch(src, frec, zz, qp: int, luma: bool) -> int:
    """Levels where the decoded ``zz`` differs from the residual coding of
    ``src`` minus the fractal prediction ``frec``."""
    want, _ = T.residual_code_plane(_t(src), frec, qp, luma)
    return int((want != zz).sum())


def _outcomes(e: float, t: float, margin: float) -> set:
    """The values ``e <= t`` can take in the codec's float32 arithmetic:
    both where ``e`` lies within ``margin`` of ``t``."""
    if abs(e - t) <= margin * t + 1.0:
        return {True, False}
    return {e <= t}


def _all_outcomes(es, t: float, margin: float) -> set:
    sets = [_outcomes(e, t, margin) for e in es]
    out = set()
    if all(True in o for o in sets):
        out.add(True)
    if any(False in o for o in sets):
        out.add(False)
    return out


def chun(org: np.ndarray, ref: np.ndarray) -> float:
    """The squared normalised correlation of a 16x16 block with its
    co-located reference block: centred sums exact in float64, each rounded
    to float32, the ratio in float32 (NaN where a side is flat)."""
    o = np.asarray(org, np.float64)
    d = np.asarray(ref, np.float64)
    oc, dc = o - o.mean(), d - d.mean()
    f = np.float32
    cov, vo, vd = f((oc * dc).sum()), f((oc * oc).sum()), f((dc * dc).sum())
    with np.errstate(invalid="ignore", divide="ignore"):
        return float(f(cov * cov) / f(vo * vd))


def split_rule(search: LeafSearch, ref_plane, my: int, mx: int,
               shape: np.ndarray, tol16: float, tol8: float,
               chun_lo: float, chun_hi: float, margin: float = 1e-3) -> bool:
    """Whether macroblock (my, mx) of a plane has a quadtree the split rule
    allows.  A 16x16 block splits where its correlation with the co-located
    reference block lies in [chun_lo, chun_hi] and its least squared error
    exceeds tol16**2 * 256; each 8x8 quarter of a split block stays whole
    where its least error is at most tol8**2 * 64, else halves into two 8x4
    rows, else two 4x8 columns, where both halves are at most tol8**2 * 32,
    else into four 4x4 cells.  Thresholds are float32 as the codec has them;
    a comparison within ``margin`` (relative) of its threshold may go
    either way.  ``shape``: the plane's map of shape codes (cells)."""
    f = np.float32
    y0, x0 = 16 * my, 16 * mx
    t16 = float(f(tol16 * tol16 * 256))
    t8, t_rect = float(f(tol8 * tol8 * 64)), float(f(tol8 * tol8 * 32))
    refp = _pad16_np(ref_plane)
    c = chun(search.org[y0:y0 + 16, x0:x0 + 16], refp[y0:y0 + 16, x0:x0 + 16])
    gate = {bool(f(chun_lo) <= c <= f(chun_hi))}
    for b in (chun_lo, chun_hi):
        if abs(c - float(f(b))) <= 1e-6:
            gate = {True, False}
    fits16 = _outcomes(search.least(y0, x0, 16, 16), t16, margin)
    can_split = {g and not a for g in gate for a in fits16}
    split = bool(shape[4 * my, 4 * mx] != 0)
    if split not in can_split:
        return False
    if not split:
        return True
    for qy in (0, 8):
        for qx in (0, 8):
            code = int(shape[(y0 + qy) // 4, (x0 + qx) // 4])
            modes = set()
            for whole in _outcomes(search.least(y0 + qy, x0 + qx, 8, 8), t8,
                                   margin):
                if whole:
                    modes.add(1)
                    continue
                rows = [search.least(y0 + qy + h, x0 + qx, 4, 8) for h in (0, 4)]
                for both_rows in _all_outcomes(rows, t_rect, margin):
                    if both_rows:
                        modes.add(2)
                        continue
                    cols = [search.least(y0 + qy, x0 + qx + v, 8, 4)
                            for v in (0, 4)]
                    for both_cols in _all_outcomes(cols, t_rect, margin):
                        modes.add(3 if both_cols else 4)
            if code not in modes:
                return False
    return True
