"""CAVLC residual block coding for real H.264 MB syntax (spec 9.2).

Reuses the spec constant tables from ``entropy.cavlc`` (Tables 9-5/9-7/9-10)
plus the chroma-DC tables (``avc.tables``).  This is the scalar per-block
writer used by the conformant MB encoder — each call emits one
``residual_block_cavlc()`` of the spec, for any maxNumCoeff (16 luma / 15 AC /
4 chroma DC) and any nC (>=0 from neighbors, -1 chroma DC).

Reference writers: ``JM/lencod/src/macroblock.c:4053`` writeCoeff4x4_CAVLC,
``JM/lencod/src/vlc.c:820-1340`` symbol writers; decode twin
``JM/ldecod/src/read_comp_cavlc.c``.

The port's own copy of ``h264tpu/avc/cavlc.py``; it imports nothing from ``h264tpu``.
"""

from __future__ import annotations

import numpy as np

from ..entropy.bitio import BitWriter, BitReader
from ..entropy.cavlc import (COEFF_TOKEN_LEN, COEFF_TOKEN_CODE,
                             TOTAL_ZEROS_LEN, TOTAL_ZEROS_CODE,
                             RUN_BEFORE_LEN, RUN_BEFORE_CODE, INC_VLC)
from .tables import (CHROMA_DC_TOKEN_LEN, CHROMA_DC_TOKEN_CODE,
                     CHROMA_DC_TZ_LEN, CHROMA_DC_TZ_CODE)


def block_fields(zz):
    """Scan-order levels/runs of one block. zz: 1-D array of scan levels.

    Returns (total, t1, t1_signbits, levels, runs, total_zeros); levels/runs
    are lists ordered by scan position of the nonzeros.
    """
    nz = [(k, int(v)) for k, v in enumerate(zz) if v != 0]
    total = len(nz)
    if total == 0:
        return 0, 0, [], [], [], 0
    levels = [v for _, v in nz]
    pos = [k for k, _ in nz]
    runs = [pos[0]] + [pos[i] - pos[i - 1] - 1 for i in range(1, total)]
    total_zeros = pos[-1] + 1 - total
    t1 = 0
    signs = []
    for lv in reversed(levels):
        if abs(lv) == 1 and t1 < 3:
            t1 += 1
            signs.append(1 if lv < 0 else 0)
        else:
            break
    return total, t1, signs, levels, runs, total_zeros


def _write_level(w: BitWriter, level: int, vlcnum: int):
    """JM writeSyntaxElement_Level_VLC1/VLCN exact bit layouts."""
    sign = 1 if level < 0 else 0
    labs = abs(level)
    if vlcnum == 0:
        if labs < 8:
            w.u(1, labs * 2 + sign - 1)
        elif labs < 16:
            w.u(16 | ((labs << 1) - 16) | sign, 19)
        else:
            lm16 = labs + 2032
            npfx = 0
            while lm16 >= (4096 << npfx):
                npfx += 1
            imask = 4096 << npfx
            w.u(imask | ((lm16 << 1) - imask) | sign, 28 + (npfx << 1))
        return
    shift = vlcnum - 1
    escape = 15 << shift
    labn = labs - 1
    if labn < escape:
        sufmask = (1 << shift) - 1
        w.u((2 << shift) | ((labn & sufmask) << 1) | sign, (labn >> shift) + 1 + vlcnum)
    else:
        lesc = labn - escape + 2048
        npfx = 0
        while lesc >= (4096 << npfx):
            npfx += 1
        imask = 4096 << npfx
        w.u(imask | ((lesc << 1) - imask) | sign, 28 + (npfx << 1))


def write_block(w: BitWriter, zz, nc: int, max_coeff: int = 16) -> int:
    """Encode one residual block; returns TotalCoeff (for nnz bookkeeping).

    zz: scan-order levels (len == max_coeff).  nc: spec nC (-1 = chroma DC).
    """
    total, t1, signs, levels, runs, total_zeros = block_fields(zz)

    if nc == -1:                    # chroma DC token table
        w.u(int(CHROMA_DC_TOKEN_CODE[t1, total]),
            int(CHROMA_DC_TOKEN_LEN[t1, total]))
    else:
        vt = 0 if nc < 2 else (1 if nc < 4 else (2 if nc < 8 else 3))
        if vt == 3:
            w.u(((total - 1) << 2) | t1 if total > 0 else 3, 6)
        else:
            w.u(int(COEFF_TOKEN_CODE[vt, t1, total]),
                int(COEFF_TOKEN_LEN[vt, t1, total]))
    if total == 0:
        return 0

    for s in signs:                 # high scan position -> low
        w.u(s, 1)

    vlcnum = 1 if (total > 10 and t1 < 3) else 0
    first = True
    lth = not (total > 3 and t1 == 3)
    for k in range(total - 1 - t1, -1, -1):
        lv = levels[k]
        adj = (lv - 1 if lv > 0 else lv + 1) if (first and lth) else lv
        _write_level(w, adj, vlcnum)
        first = False
        if abs(lv) > INC_VLC[min(vlcnum, 6)]:
            vlcnum += 1
        if k == total - 1 - t1 and abs(lv) > 3:
            vlcnum = max(vlcnum, 2)

    if total < max_coeff:
        if nc == -1:
            w.u(int(CHROMA_DC_TZ_CODE[total - 1, total_zeros]),
                int(CHROMA_DC_TZ_LEN[total - 1, total_zeros]))
        else:
            w.u(int(TOTAL_ZEROS_CODE[total - 1, total_zeros]),
                int(TOTAL_ZEROS_LEN[total - 1, total_zeros]))

    zerosleft = total_zeros
    for k in range(total - 1, 0, -1):
        if zerosleft <= 0:
            break
        run = runs[k]
        row = min(zerosleft - 1, 6)
        w.u(int(RUN_BEFORE_CODE[row, run]), int(RUN_BEFORE_LEN[row, run]))
        zerosleft -= run
    return total


def block_bits(zz, nc: int, max_coeff: int = 16) -> int:
    """Exact bit cost of write_block without materializing the stream."""
    w = BitWriter()
    write_block(w, zz, nc, max_coeff)
    return w.bit_length()


# ---------------------------------------------------------------------------
# Decode side (for the framework's own standard-H.264 decoder)
# ---------------------------------------------------------------------------

_CDC_TOKEN_DEC = {}
for _t1 in range(4):
    for _tot in range(5):
        _ln = int(CHROMA_DC_TOKEN_LEN[_t1, _tot])
        if _ln:
            _CDC_TOKEN_DEC[(_ln, int(CHROMA_DC_TOKEN_CODE[_t1, _tot]))] = (_tot, _t1)
_CDC_TZ_DEC = [{(int(CHROMA_DC_TZ_LEN[i, j]), int(CHROMA_DC_TZ_CODE[i, j])): j
                for j in range(4) if CHROMA_DC_TZ_LEN[i, j]} for i in range(3)]


def read_block(r: BitReader, nc: int, max_coeff: int = 16) -> np.ndarray:
    """Parse one residual_block_cavlc; returns scan-order levels."""
    from ..entropy.cavlc import _read_vlc, _read_level, _TOKEN_DEC, _TZ_DEC, _RB_DEC
    zz = np.zeros(max_coeff, np.int64)
    if nc == -1:
        total, t1 = _read_vlc(r, _CDC_TOKEN_DEC, 8)
    else:
        vt = 0 if nc < 2 else (1 if nc < 4 else (2 if nc < 8 else 3))
        if vt == 3:
            code = r.u(6)
            total, t1 = (0, 0) if code == 3 else ((code >> 2) + 1, code & 3)
        else:
            total, t1 = _read_vlc(r, _TOKEN_DEC[vt])
    if total == 0:
        return zz
    levels = np.zeros(total, np.int64)
    for j in range(t1):
        levels[total - 1 - j] = -1 if r.u(1) else 1
    vlcnum = 1 if (total > 10 and t1 < 3) else 0
    first = True
    for k in range(total - 1 - t1, -1, -1):
        lv = _read_level(r, vlcnum)
        if first and not (total > 3 and t1 == 3):
            lv = lv + 1 if lv > 0 else lv - 1
        first = False
        levels[k] = lv
        if abs(lv) > INC_VLC[min(vlcnum, 6)]:
            vlcnum += 1
        if k == total - 1 - t1 and abs(lv) > 3:
            vlcnum = max(vlcnum, 2)
    if total < max_coeff:
        if nc == -1:
            tz = _read_vlc(r, _CDC_TZ_DEC[total - 1], 4)
        else:
            tz = _read_vlc(r, _TZ_DEC[total - 1])
    else:
        tz = 0
    runs = np.zeros(total, np.int64)
    zerosleft = tz
    for k in range(total - 1, 0, -1):
        if zerosleft > 0:
            rb = _read_vlc(r, _RB_DEC[min(zerosleft - 1, 6)])
        else:
            rb = 0
        runs[k] = rb
        zerosleft -= rb
    runs[0] = zerosleft
    pos = -1
    for k in range(total):
        pos += int(runs[k]) + 1
        zz[pos] = levels[k]
    return zz
