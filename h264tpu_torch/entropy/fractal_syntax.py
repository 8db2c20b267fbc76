"""FVC bitstream syntax — serialization of fractal trees, intra modes and
residual levels (the port's own copy of the parts of
``h264tpu/entropy/fractal_syntax.py`` that the IPPP path uses).

Stream layout
  header:  magic 'FVC1' u(32) | version u(8) | width u(16) | height u(16)
           intra_period u(16) | qp u(8) | search_range u(8) | halfpel u(8)
           deblock u(8) | entropy u(8) | views u(8) | num_frames u(32)
           tile_rows u(8)
  frame:   type u(8) (0=I, 1=P) | qp u(8) | payload | byte-align
  I payload:   intra_modes(P) residual(P) for P in Y, U, V
  P payload:   tree(P) residual(P) for P in Y, U, V
  tree (on the 16-padded plane grid):
           split flags u(1) x nMB (raster)
           b8 modes u(2) x 4 per split MB
           per shape s in (16x16, 8x8, 8x4w, 4x8t, 4x4), leaves in raster
           order, field-major: ref u(2) [if halfpel], then dx+SR, dy+SR,
           (a+235)/5, (β+60)/5 each as first value raw + se(deltas)
  residual:  H.264 CAVLC of every 4x4 block (entropy/cavlc.py)
"""

from __future__ import annotations

import numpy as np

from .bitio import BitWriter, BitReader
from . import cavlc
from ..ops.fractal import SHAPES

MAGIC = 0x46564331  # 'FVC1'

ENTROPY_CAVLC = 0   # utils.config.EntropyMode.CAVLC


def _cavlc_only(mode: int):
    if mode != ENTROPY_CAVLC:
        raise NotImplementedError(
            f"entropy mode {mode}: only CAVLC residuals are ported; CABAC "
            "(entropy/cabac_eng.py) and Exp-Golomb sets come in a later slice")


def write_residual(w: BitWriter, zz: np.ndarray, cy: int, cx: int, mode: int):
    _cavlc_only(mode)
    cavlc.encode_plane(np.asarray(zz), cy, cx, w)


def read_residual(r: BitReader, cy: int, cx: int, mode: int) -> np.ndarray:
    _cavlc_only(mode)
    return cavlc.decode_plane(r, cy, cx)


def _mv_bits(search_range: int) -> int:
    span = 2 * search_range + 1
    return max(1, int(np.ceil(np.log2(span))))


# ---------------------------------------------------------------------------
# Tree (leaf cell maps <-> bits)
# ---------------------------------------------------------------------------

def _leaf_corner_mask(shape_map: np.ndarray, code: int):
    """Boolean mask of cells that are the top-left corner of a leaf of
    ``code``; raster order of True cells == leaf raster order."""
    bh, bw = SHAPES[code]
    ch, cw = bh // 4, bw // 4
    cy = np.arange(shape_map.shape[0])[:, None]
    cx = np.arange(shape_map.shape[1])[None, :]
    return (shape_map == code) & (cy % ch == 0) & (cx % cw == 0)


def write_tree(w: BitWriter, maps: dict, search_range: int,
               use_halfpel: bool):
    ref_bits = 2 if use_halfpel else 0
    shape = np.asarray(maps["shape"])
    mb_split = shape[::4, ::4] != 0
    w.u(mb_split.astype(np.int64).reshape(-1), 1)

    # b8 modes for split MBs: shape code at 8x8 corners -> mode = code-1
    code8 = shape[::2, ::2]
    nmby, nmbx = mb_split.shape
    modes = (code8.reshape(nmby, 2, nmbx, 2).transpose(0, 2, 1, 3)
             .reshape(nmby, nmbx, 4) - 1)
    sel = modes[mb_split]
    if sel.size:
        w.u(sel.reshape(-1), 2)

    sr = search_range
    mvb = _mv_bits(sr)
    for code in range(len(SHAPES)):
        m = _leaf_corner_mask(shape, code)
        if not m.any():
            continue
        if ref_bits:
            w.u(np.asarray(maps["ref"])[m], ref_bits)
        # first leaf raw, then se(delta-to-previous) along the leaf raster
        for vals, nbits in (
                (np.asarray(maps["dx"])[m] + sr, mvb),
                (np.asarray(maps["dy"])[m] + sr, mvb),
                ((np.asarray(maps["a"])[m] + 235) // 5, 7),
                ((np.asarray(maps["beta"])[m] + 60) // 5, 6)):
            w.u(int(vals[0]), nbits)
            if vals.size > 1:
                w.se(np.diff(vals))


def read_tree(r: BitReader, Hp: int, Wp: int, search_range: int,
              use_halfpel: bool) -> dict:
    ref_bits = 2 if use_halfpel else 0
    nmby, nmbx = Hp // 16, Wp // 16
    cy, cx = Hp // 4, Wp // 4
    mb_split = r.u_array(nmby * nmbx, 1).reshape(nmby, nmbx).astype(bool)

    shape = np.zeros((cy, cx), dtype=np.int64)
    nsplit = int(mb_split.sum())
    if nsplit:
        modes = r.u_array(nsplit * 4, 2).reshape(nsplit, 4)
        full = np.zeros((nmby, nmbx, 4), dtype=np.int64)
        full[mb_split] = modes
        code8 = (full.reshape(nmby, nmbx, 2, 2).transpose(0, 2, 1, 3)
                 .reshape(2 * nmby, 2 * nmbx) + 1)
        split8 = np.repeat(np.repeat(mb_split, 2, 0), 2, 1)
        code_cells = np.repeat(np.repeat(code8, 2, 0), 2, 1)
        shape = np.where(np.repeat(np.repeat(split8, 2, 0), 2, 1), code_cells, 0)
    maps = {k: np.zeros((cy, cx), dtype=np.int64)
            for k in ("a", "beta", "dx", "dy", "ref")}
    maps["shape"] = shape

    sr = search_range
    mvb = _mv_bits(sr)
    for code in range(len(SHAPES)):
        m = _leaf_corner_mask(shape, code)
        n = int(m.sum())
        if n == 0:
            continue
        ref = r.u_array(n, ref_bits) if ref_bits else \
            np.zeros(n, dtype=np.int64)

        def pred(nbits):
            first = r.u(nbits)
            if n > 1:
                d = r.se_array(n - 1)
                return np.concatenate([[first], first + np.cumsum(d)])
            return np.array([first], dtype=np.int64)

        dx = pred(mvb) - sr
        dy = pred(mvb) - sr
        a = pred(7) * 5 - 235
        beta = pred(6) * 5 - 60
        bh, bw = SHAPES[code]
        ch, cw = bh // 4, bw // 4
        for name, vals in (("ref", ref), ("dx", dx), ("dy", dy),
                           ("a", a), ("beta", beta)):
            g = np.zeros((cy // ch, cx // cw), dtype=np.int64)
            g[m[::ch, ::cw]] = vals
            up = np.repeat(np.repeat(g, ch, 0), cw, 1)
            maps[name] = np.where(shape == code, up, maps[name])
    return maps


# ---------------------------------------------------------------------------
# Intra prediction modes (most-probable-mode coding, field-major)
# ---------------------------------------------------------------------------

def _mpm(modes: np.ndarray) -> np.ndarray:
    """Most probable mode per block: min(left, top), DC (=2) at edges."""
    left = np.full_like(modes, 2)
    left[:, 1:] = modes[:, :-1]
    top = np.full_like(modes, 2)
    top[1:, :] = modes[:-1, :]
    return np.minimum(left, top)


def write_intra_modes(w: BitWriter, modes: np.ndarray):
    """u(1) use-mpm flag per block (raster), then u(3) rem for the rest."""
    modes = np.asarray(modes, dtype=np.int64)
    mpm = _mpm(modes)
    use = modes == mpm
    w.u(use.astype(np.int64).reshape(-1), 1)
    rem = np.where(modes < mpm, modes, modes - 1)[~use]
    if rem.size:
        w.u(rem, 3)


def read_intra_modes(r: BitReader, cy: int, cx: int) -> np.ndarray:
    use = r.u_array(cy * cx, 1).astype(bool).reshape(cy, cx)
    n_rem = int((~use).sum())
    rem = r.u_array(n_rem, 3) if n_rem else np.zeros(0, np.int64)
    modes = np.zeros((cy, cx), dtype=np.int64)
    it = iter(rem.tolist())
    for y in range(cy):
        for x in range(cx):
            left = modes[y, x - 1] if x > 0 else 2
            top = modes[y - 1, x] if y > 0 else 2
            mpm = min(left, top)
            if use[y, x]:
                modes[y, x] = mpm
            else:
                v = next(it)
                modes[y, x] = v if v < mpm else v + 1
    return modes


# ---------------------------------------------------------------------------
# Stream header
# ---------------------------------------------------------------------------

def write_header(w: BitWriter, cfg, num_frames: int):
    w.u(MAGIC, 32)
    w.u(2, 8)
    w.u(cfg.width, 16)
    w.u(cfg.height, 16)
    w.u(cfg.intra_period, 16)
    w.u(cfg.qp, 8)
    w.u(cfg.fractal.search_range, 8)
    w.u(int(cfg.fractal.use_halfpel_refs), 8)
    w.u(int(cfg.deblock), 8)
    w.u(int(cfg.entropy), 8)
    w.u(cfg.views, 8)
    w.u(num_frames, 32)
    w.u(max(cfg.tile_rows, 1), 8)


def read_header(r: BitReader) -> dict:
    magic = r.u(32)
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic:#x}")
    version = r.u(8)
    out = dict(version=version, width=r.u(16), height=r.u(16),
               intra_period=r.u(16), qp=r.u(8), search_range=r.u(8),
               use_halfpel=bool(r.u(8)), deblock=bool(r.u(8)),
               entropy=r.u(8), views=r.u(8), num_frames=r.u(32))
    out["tile_rows"] = r.u(8) if version >= 2 else 1
    return out
