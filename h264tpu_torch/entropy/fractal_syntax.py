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

from .bitio import BitWriter, BitReader
from . import native
from ..ops.fractal import SHAPES

MAGIC = 0x46564331  # 'FVC1'

# residual entropy modes; equal to utils.config.EntropyMode
ENTROPY_CAVLC = 0   # H.264 CAVLC
ENTROPY_CABAC = 1   # H.264 M-coder arithmetic coding (entropy/cabac_eng.py)
ENTROPY_EG = 2      # Exp-Golomb coefficient sets


def write_residual(w: BitWriter, zz: np.ndarray, cy: int, cx: int, mode: int):
    """Levels [cy*cx, 16] of one plane in the stream's entropy mode; CAVLC
    and CABAC through the native coders (twins: ``cavlc.encode_plane``,
    ``cabac_eng.encode_plane``)."""
    if mode == ENTROPY_CAVLC:
        codes, lens = native.cavlc_encode_plane(np.asarray(zz), cy, cx)
        mask = lens > 0
        w.raw(codes[mask], lens[mask])
    elif mode == ENTROPY_CABAC:
        payload = native.cabac_encode_plane(np.asarray(zz), cy, cx)
        pad = (-w.bit_length()) % 8
        if pad:
            w.u(0, pad)
        w.u(len(payload), 32)
        if payload:
            w.u(np.frombuffer(payload, np.uint8), 8)
    else:
        write_coeff_set(w, np.asarray(zz))


def read_residual(r: BitReader, cy: int, cx: int, mode: int) -> np.ndarray:
    if mode == ENTROPY_CAVLC:
        zz, r.pos = native.cavlc_decode_plane(r.data, len(r._bits), r.pos,
                                              cy, cx)
        return zz
    if mode == ENTROPY_CABAC:
        r.byte_align()
        n = r.u(32)
        payload = r.data[r.pos // 8:r.pos // 8 + n]
        r.pos += 8 * n
        return native.cabac_decode_plane(payload, cy, cx)
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


def write_tree(w: BitWriter, maps: dict, search_range: int,
               use_halfpel: bool, ref_bits: int = None):
    """``ref_bits``: width of the ref field; 2 with half-pel planes, 0
    without, 3 for two reference frames (3-view side views)."""
    if ref_bits is None:
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
    return native.resolve_intra_modes(use, rem, cy, cx)


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

def write_coeff_set(w: BitWriter, zz: np.ndarray):
    """zz: [nblocks, 16] levels in zig-zag order: ue(nnz) per block, then
    ue(run) and se(level) of every nonzero level in block order."""
    zz = np.asarray(zz, dtype=np.int64)
    nz = zz != 0
    w.ue(nz.sum(axis=1))
    if not nz.any():
        return
    pos = np.broadcast_to(np.arange(16), zz.shape)[nz]
    block = np.broadcast_to(np.arange(zz.shape[0])[:, None], zz.shape)[nz]
    prev = np.empty_like(pos)
    prev[0] = -1
    prev[1:] = pos[:-1]
    prev[np.r_[True, block[1:] != block[:-1]]] = -1
    w.ue(pos - prev - 1)
    w.se(zz[nz])


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


# ---------------------------------------------------------------------------
# Region-coded frame parameters: per-object 16x16 grids
# ---------------------------------------------------------------------------

def write_region_params(w: BitWriter, params: dict, search_range: int,
                        use_halfpel: bool):
    """Per object (0 = background, 1 = object), field-major over the MB
    raster: [ref u(2) if half-pel] dx+SR dy+SR u(mv_bits), (a+235)/5 u(7),
    (β+60)/5 u(6)."""
    sr = search_range
    mvb = _mv_bits(sr)
    for obj in range(2):
        if use_halfpel:
            w.u(np.asarray(params["ref"][obj]).reshape(-1), 2)
        w.u(np.asarray(params["dx"][obj]).reshape(-1) + sr, mvb)
        w.u(np.asarray(params["dy"][obj]).reshape(-1) + sr, mvb)
        w.u((np.asarray(params["a"][obj]).reshape(-1) + 235) // 5, 7)
        w.u((np.asarray(params["beta"][obj]).reshape(-1) + 60) // 5, 6)


def read_region_params(r: BitReader, nmby: int, nmbx: int, search_range: int,
                       use_halfpel: bool) -> dict:
    """Inverse of :func:`write_region_params`: [2, nmby, nmbx] int32 maps."""
    sr = search_range
    mvb = _mv_bits(sr)
    n = nmby * nmbx
    out = {k: [] for k in ("ref", "dx", "dy", "a", "beta")}
    for _ in range(2):
        out["ref"].append(r.u_array(n, 2) if use_halfpel
                          else np.zeros(n, np.int64))
        out["dx"].append(r.u_array(n, mvb) - sr)
        out["dy"].append(r.u_array(n, mvb) - sr)
        out["a"].append(r.u_array(n, 7) * 5 - 235)
        out["beta"].append(r.u_array(n, 6) * 5 - 60)
    return {k: np.stack(v).reshape(2, nmby, nmbx).astype(np.int32)
            for k, v in out.items()}
