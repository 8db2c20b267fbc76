"""H.264 spec constant tables used by the conformant AVC layer.

All tables are constants fixed by the standard (Tables 9-4, 9-5, 9-9(a));
values cross-checked against JM 18.5 (``JM/lencod/src/vlc.c:32`` NCBP,
``:920`` chroma-DC coeff_token, ``:1069`` chroma-DC total_zeros).

The port's own copy of ``h264tpu/avc/tables.py``; it imports nothing from ``h264tpu``.
"""

from __future__ import annotations

import numpy as np

# --- Table 9-4: coded_block_pattern me(v) mapping, chroma_format != 0.
# CBP_TO_CODENUM[cbp] = codeNum for Intra_4x4 / for Inter.
_NCBP48 = [
    (3, 0), (29, 2), (30, 3), (17, 7), (31, 4), (18, 8), (37, 17), (8, 13),
    (32, 5), (38, 18), (19, 9), (9, 14), (20, 10), (10, 15), (11, 16), (2, 11),
    (16, 1), (33, 32), (34, 33), (21, 36), (35, 34), (22, 37), (39, 44), (4, 40),
    (36, 35), (40, 45), (23, 38), (5, 41), (24, 39), (6, 42), (7, 43), (1, 19),
    (41, 6), (42, 24), (43, 25), (25, 20), (44, 26), (26, 21), (46, 46), (12, 28),
    (45, 27), (47, 47), (27, 22), (13, 29), (28, 23), (14, 30), (15, 31), (0, 12),
]
CBP_TO_CODENUM_INTRA = np.array([x[0] for x in _NCBP48], np.int64)
CBP_TO_CODENUM_INTER = np.array([x[1] for x in _NCBP48], np.int64)
CODENUM_TO_CBP_INTRA = np.argsort(CBP_TO_CODENUM_INTRA).astype(np.int64)
CODENUM_TO_CBP_INTER = np.argsort(CBP_TO_CODENUM_INTER).astype(np.int64)

# --- chroma DC (4:2:0) coeff_token, nC == -1 (Table 9-5 right column).
# [trailing_ones][total_coeff] -> (len, code); len 0 = invalid combination.
CHROMA_DC_TOKEN_LEN = np.array([
    [2, 6, 6, 6, 6],
    [0, 1, 6, 7, 8],
    [0, 0, 3, 7, 8],
    [0, 0, 0, 6, 7],
], np.int64)
CHROMA_DC_TOKEN_CODE = np.array([
    [1, 7, 4, 3, 2],
    [0, 1, 6, 3, 3],
    [0, 0, 1, 2, 2],
    [0, 0, 0, 5, 0],
], np.int64)

# --- chroma DC total_zeros (Table 9-9(a)): [total_coeff-1][total_zeros]
CHROMA_DC_TZ_LEN = np.array([
    [1, 2, 3, 3],
    [1, 2, 2, 0],
    [1, 1, 0, 0],
], np.int64)
CHROMA_DC_TZ_CODE = np.array([
    [1, 1, 1, 0],
    [1, 1, 0, 0],
    [1, 0, 0, 0],
], np.int64)

# --- 4x4 block coding order inside a macroblock (spec 6.4.3): 8x8 groups in
# raster order, 4x4 blocks in raster order inside each group.  Entry k =
# (y4, x4) raster position of the k-th coded block.
BLOCK_SCAN = []
for _b8 in range(4):
    for _b4 in range(4):
        BLOCK_SCAN.append((((_b8 >> 1) << 1) + (_b4 >> 1),
                           ((_b8 & 1) << 1) + (_b4 & 1)))
BLOCK_SCAN = np.array(BLOCK_SCAN, np.int64)          # [16, 2] (y4, x4)
# inverse: coding-order index of the block at raster position (y4, x4)
BLOCK_SCAN_INV = np.zeros((4, 4), np.int64)
for _k, (_y, _x) in enumerate(BLOCK_SCAN):
    BLOCK_SCAN_INV[_y, _x] = _k

# mb_type constants for I slices (Table 7-11)
MB_I4x4 = 0


def mb_type_i16(pred_mode: int, cbp_chroma: int, cbp_luma_nonzero: bool) -> int:
    """I_16x16 mb_type (Table 7-11): 1 + pm + 4*cbpC + 12*(cbpL != 0)."""
    return 1 + pred_mode + 4 * cbp_chroma + 12 * (1 if cbp_luma_nonzero else 0)


def mb_type_i16_parse(mb_type: int):
    """Inverse of :func:`mb_type_i16` for mb_type in 1..24."""
    t = mb_type - 1
    return t % 4, (t // 4) % 3, t >= 12
