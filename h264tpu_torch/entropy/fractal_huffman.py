"""Legacy per-frame Huffman fractal bitstream (reference capability F23).

The reference's historical fractal stream (``write_Codestream``, commented at
FR/src/code.c:404-480; ``CreateHuffmanCodeBook``/``HuffmanEncoder``
FR/src/huffman.c:5,:89; bit packer ``pack`` FR/src/file.c:27) Huffman-codes
the fractal parameters (x, y, alpha, beta) of every tree leaf with codebooks
built from that frame's symbol histograms and serialized into the stream.
It was superseded by the H.264-style entropy layer but is part of the
capability surface.

The port's own copy of ``h264tpu/entropy/fractal_huffman.py`` (host
numpy; it imports nothing from ``h264tpu``).  The quadtree is already a set
of dense leaf maps (``ops/fractal.py`` ``leaf_maps``), so symbol extraction
is pure numpy gathering (no per-node walk): leaf origins are the 4x4 cells
whose coordinates are multiples of their leaf's shape.  Five symbol streams
(alpha-, beta-lattice indices on the reference's 128x64 grid, dx, dy, ref)
each carry their own canonical codebook (``entropy/huffman.py``).
"""

from __future__ import annotations

import numpy as np

from ..ops.fractal import A_MIN, BETA_MIN, SHAPES
from . import huffman as HUF
from .bitio import BitReader, BitWriter


def _leaf_origin_mask(shape_map: np.ndarray) -> np.ndarray:
    """Boolean [Cy, Cx]: cell is the top-left cell of its leaf block."""
    cy, cx = shape_map.shape
    yy, xx = np.mgrid[0:cy, 0:cx]
    mask = np.zeros_like(shape_map, dtype=bool)
    for code, (bh, bw) in enumerate(SHAPES):
        ch, cw = bh // 4, bw // 4
        mask |= (shape_map == code) & (yy % ch == 0) & (xx % cw == 0)
    return mask


def _structure_symbols(shape_map: np.ndarray):
    """MB split flags + per-8x8 mode symbols from the dense shape map."""
    mb_split = shape_map[::4, ::4] != 0                      # [nMBy, nMBx]
    b8 = shape_map[::2, ::2]                                 # at 8x8 origins
    b8_mode = np.clip(b8 - 1, 0, 3)                          # 0:8x8 .. 3:4x4
    sel = np.repeat(np.repeat(mb_split, 2, 0), 2, 1)
    return mb_split, b8_mode[sel]                            # modes under split MBs


def encode_maps(maps: dict, search_range: int) -> bytes:
    """Serialize one plane's leaf maps as a Huffman fractal codestream."""
    shape_map = np.asarray(maps["shape"], dtype=np.int64)
    mb_split, b8_syms = _structure_symbols(shape_map)
    origins = _leaf_origin_mask(shape_map)

    sr = search_range + 1  # half-pel refs may land one past the integer range
    fields = {
        "a": (np.asarray(maps["a"], np.int64) - A_MIN) // 5,
        "beta": (np.asarray(maps["beta"], np.int64) - BETA_MIN) // 5,
        "dx": np.asarray(maps["dx"], np.int64) + sr,
        "dy": np.asarray(maps["dy"], np.int64) + sr,
        "ref": np.asarray(maps["ref"], np.int64),
    }
    w = BitWriter()
    w.u(np.asarray(mb_split.reshape(-1), dtype=np.int64), 1)
    b8_hist = np.bincount(b8_syms, minlength=4)
    b8_len = HUF.code_lengths(b8_hist)
    HUF.write_codebook(w, b8_len)
    HUF.encode_symbols(w, b8_syms, b8_len)
    for name, nsym in (("a", 128), ("beta", 64), ("dx", 2 * sr + 1),
                       ("dy", 2 * sr + 1), ("ref", 8)):
        syms = fields[name][origins]
        lens = HUF.code_lengths(np.bincount(syms, minlength=nsym))
        HUF.write_codebook(w, lens)
        HUF.encode_symbols(w, syms, lens)
    return w.to_bytes()


def decode_maps(data: bytes, h: int, w_px: int, search_range: int) -> dict:
    """Inverse of :func:`encode_maps` -> dense [H/4, W/4] leaf maps."""
    cy, cx = h // 4, w_px // 4
    r = BitReader(data)
    mb_split = r.u_array((cy // 4) * (cx // 4), 1).astype(bool).reshape(
        cy // 4, cx // 4)
    b8_len = HUF.read_codebook(r)
    n_b8 = int(mb_split.sum()) * 4
    b8_syms = HUF.decode_symbols(r, b8_len, n_b8) if n_b8 else np.zeros(0, np.int64)

    # rebuild the dense shape map: 0 for unsplit MBs, else per-8x8 mode + 1
    shape_map = np.zeros((cy, cx), dtype=np.int64)
    sel = np.repeat(np.repeat(mb_split, 2, 0), 2, 1)         # [cy/2, cx/2]
    b8_grid = np.zeros((cy // 2, cx // 2), dtype=np.int64)
    b8_grid[sel] = b8_syms + 1
    full = np.repeat(np.repeat(b8_grid, 2, 0), 2, 1)
    split_cells = np.repeat(np.repeat(mb_split, 4, 0), 4, 1)
    shape_map[split_cells] = full[split_cells]
    # 8x4 / 4x8 leaves subdivide the 8x8: shape codes already per-cell
    origins = _leaf_origin_mask(shape_map)
    n_leaf = int(origins.sum())

    sr = search_range + 1
    out = {"shape": shape_map.astype(np.int32)}
    for name, nsym, off in (("a", 128, A_MIN), ("beta", 64, BETA_MIN),
                            ("dx", 2 * sr + 1, -sr), ("dy", 2 * sr + 1, -sr),
                            ("ref", 8, 0)):
        lens = HUF.read_codebook(r)
        syms = HUF.decode_symbols(r, lens, n_leaf)
        vals = syms * (5 if name in ("a", "beta") else 1) + off
        dense = np.zeros((cy, cx), dtype=np.int64)
        dense[origins] = vals
        # broadcast each leaf origin's value over its leaf cells
        for code, (bh, bw) in enumerate(SHAPES):
            ch, cw = bh // 4, bw // 4
            if ch == 1 and cw == 1:
                continue
            m = shape_map == code
            block = dense.reshape(cy // ch, ch, cx // cw, cw)
            filled = np.repeat(np.repeat(block[:, 0, :, 0], ch, axis=0),
                               cw, axis=1)
            dense = np.where(m, filled, dense)
        out[name] = dense.astype(np.int32)
    return out
