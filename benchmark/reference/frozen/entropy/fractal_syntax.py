"""FVC bitstream syntax — serialization of fractal trees, intra modes,
residual levels and region parameters (the port's own copy of
``h264tpu/entropy/fractal_syntax.py``).

Stream layout
  header:  magic 'FVC1' u(32) | version u(8) | width u(16) | height u(16)
           intra_period u(16) | qp u(8) | search_range u(8) | halfpel u(8)
           deblock u(8) | entropy u(8) | views u(8) | num_frames u(32)
           tile_rows u(8)
  frame:   type u(8) (0=I, 1=P, 2=classic P, 3=region P) | qp u(8) |
           payload | byte-align
  I payload:   intra_modes(P) residual(P) for P in Y, U, V
  P payload:   tree(P) residual(P) for P in Y, U, V
  classic P:   se(mv_x) se(mv_y) per 16x16 MB, then residual(P) per plane
  region P:    region_params residual(Y), then tree(P) residual(P) for U, V
  tree (on the 16-padded plane grid):
           split flags u(1) x nMB (raster)
           b8 modes u(2) x 4 per split MB
           per shape s in (16x16, 8x8, 8x4w, 4x8t, 4x4), leaves in raster
           order, field-major: ref u(2) [u(3) with two reference frames; if
           halfpel], then dx+SR, dy+SR, (a+235)/5, (β+60)/5 each as first
           value raw + se(deltas)
  residual:  by the header's entropy mode: H.264 CAVLC of every 4x4 block
           (entropy/cavlc.py); CABAC (byte-aligned u(32) length + the
           M-coder's bytes, entropy/cabac_eng.py); or Exp-Golomb sets
           ue(nnz) per block | ue(run) per level | se(level) per level
"""

from __future__ import annotations

import numpy as np

from .bitio import BitReader
from . import cavlc
from ..ops.fractal import SHAPES

MAGIC = 0x46564331  # 'FVC1'

# residual entropy modes; equal to utils.config.EntropyMode
ENTROPY_CAVLC = 0   # H.264 CAVLC
ENTROPY_CABAC = 1   # H.264 M-coder arithmetic coding (entropy/cabac_eng.py)
ENTROPY_EG = 2      # Exp-Golomb coefficient sets


def read_residual(r: BitReader, cy: int, cx: int, mode: int) -> np.ndarray:
    if mode == ENTROPY_CAVLC:
        return cavlc.decode_plane(r, cy, cx)
    if mode == ENTROPY_CABAC:
        raise NotImplementedError("CABAC residuals are outside the frozen copy")
    return read_coeff_set(r, cy * cx)


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


def read_tree(r: BitReader, Hp: int, Wp: int, search_range: int,
              use_halfpel: bool, ref_bits: int = None) -> dict:
    if ref_bits is None:
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


def read_intra_modes(r: BitReader, cy: int, cx: int) -> np.ndarray:
    use = r.u_array(cy * cx, 1).astype(bool).reshape(cy, cx)
    n_rem = int((~use).sum())
    rem = r.u_array(n_rem, 3) if n_rem else np.zeros(0, np.int64)
    return resolve_intra_modes_python(use, rem, cy, cx)


def resolve_intra_modes_python(use: np.ndarray, rem: np.ndarray, cy: int,
                               cx: int) -> np.ndarray:
    """The Python twin of ``native.resolve_intra_modes``: each block's mode
    is its MPM (the smaller of left and top, 2 off the plane) where ``use``
    is set, else the next of ``rem`` skipping the MPM."""
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
# Exp-Golomb coefficient sets
# ---------------------------------------------------------------------------

def read_coeff_set(r: BitReader, nblocks: int) -> np.ndarray:
    nnz = r.ue_array(nblocks)
    total = int(nnz.sum())
    zz = np.zeros((nblocks, 16), dtype=np.int64)
    if total == 0:
        return zz
    runs = r.ue_array(total)
    levels = r.se_array(total)
    block = np.repeat(np.arange(nblocks), nnz)
    csum = np.cumsum(runs + 1)
    # cumulative steps before each block's first level
    first = np.cumsum(nnz) - nnz
    base = np.where(first > 0, csum[np.maximum(first, 1) - 1], 0)
    zz[block, csum - np.repeat(base, nnz) - 1] = levels
    return zz


# ---------------------------------------------------------------------------
# Stream header
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# Region-coded frame parameters: per-object 16x16 grids
# ---------------------------------------------------------------------------

