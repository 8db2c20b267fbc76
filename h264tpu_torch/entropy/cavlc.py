"""CAVLC residual coding (H.264 9.2), vectorized across all blocks of a frame.

Spec constant tables and bit-exact semantics follow the standard (and the
reference implementations: ``FR/src/macroblock.c:4367`` writeCoeff4x4_CAVLC,
``JM/lencod/src/vlc.c:820-1340`` writers).  The encoder computes every
syntax element for EVERY 4x4 block simultaneously with numpy array ops —
the per-coefficient "loops" are 16-step static unrolls over [nblocks]
vectors — then emits one (code, length) symbol stream.  The decoder is a
sequential bit parser (variable-length decode is inherently serial).

This is the port's own copy of ``h264tpu/entropy/cavlc.py``; the port imports
nothing from ``h264tpu``.  The C++ CAVLC path of ``native/`` is not bound here.

Our FVC format codes every 4x4 block (luma and chroma) with the 16-coeff
tables; nC context is the in-plane left/top TotalCoeffs predictor.
"""

from __future__ import annotations

import numpy as np

from .bitio import BitWriter, BitReader

# --- spec tables (H.264 Table 9-5): coeff_token (len, code) by
# [vlcnum 0..2][TrailingOnes 0..3][TotalCoeff 0..16]; vlcnum 3 is a 6-bit FLC.
COEFF_TOKEN_LEN = np.array([
    [[1, 6, 8, 9, 10, 11, 13, 13, 13, 14, 14, 15, 15, 16, 16, 16, 16],
     [0, 2, 6, 8, 9, 10, 11, 13, 13, 14, 14, 15, 15, 15, 16, 16, 16],
     [0, 0, 3, 7, 8, 9, 10, 11, 13, 13, 14, 14, 15, 15, 16, 16, 16],
     [0, 0, 0, 5, 6, 7, 8, 9, 10, 11, 13, 14, 14, 15, 15, 16, 16]],
    [[2, 6, 6, 7, 8, 8, 9, 11, 11, 12, 12, 12, 13, 13, 13, 14, 14],
     [0, 2, 5, 6, 6, 7, 8, 9, 11, 11, 12, 12, 13, 13, 14, 14, 14],
     [0, 0, 3, 6, 6, 7, 8, 9, 11, 11, 12, 12, 13, 13, 13, 14, 14],
     [0, 0, 0, 4, 4, 5, 6, 6, 7, 9, 11, 11, 12, 13, 13, 13, 14]],
    [[4, 6, 6, 6, 7, 7, 7, 7, 8, 8, 9, 9, 9, 10, 10, 10, 10],
     [0, 4, 5, 5, 5, 5, 6, 6, 7, 8, 8, 9, 9, 9, 10, 10, 10],
     [0, 0, 4, 5, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 10],
     [0, 0, 0, 4, 4, 4, 4, 4, 5, 6, 7, 8, 8, 9, 10, 10, 10]],
], dtype=np.int64)
COEFF_TOKEN_CODE = np.array([
    [[1, 5, 7, 7, 7, 7, 15, 11, 8, 15, 11, 15, 11, 15, 11, 7, 4],
     [0, 1, 4, 6, 6, 6, 6, 14, 10, 14, 10, 14, 10, 1, 14, 10, 6],
     [0, 0, 1, 5, 5, 5, 5, 5, 13, 9, 13, 9, 13, 9, 13, 9, 5],
     [0, 0, 0, 3, 3, 4, 4, 4, 4, 4, 12, 12, 8, 12, 8, 12, 8]],
    [[3, 11, 7, 7, 7, 4, 7, 15, 11, 15, 11, 8, 15, 11, 7, 9, 7],
     [0, 2, 7, 10, 6, 6, 6, 6, 14, 10, 14, 10, 14, 10, 11, 8, 6],
     [0, 0, 3, 9, 5, 5, 5, 5, 13, 9, 13, 9, 13, 9, 6, 10, 5],
     [0, 0, 0, 5, 4, 6, 8, 4, 4, 4, 12, 8, 12, 12, 8, 1, 4]],
    [[15, 15, 11, 8, 15, 11, 9, 8, 15, 11, 15, 11, 8, 13, 9, 5, 1],
     [0, 14, 15, 12, 10, 8, 14, 10, 14, 14, 10, 14, 10, 7, 12, 8, 4],
     [0, 0, 13, 14, 11, 9, 13, 9, 13, 10, 13, 9, 13, 9, 11, 7, 3],
     [0, 0, 0, 12, 11, 10, 9, 8, 13, 12, 12, 12, 8, 12, 10, 6, 2]],
], dtype=np.int64)

# total_zeros (Table 9-7): rows = TotalCoeff 1..15
TOTAL_ZEROS_LEN = np.zeros((15, 16), np.int64)
TOTAL_ZEROS_CODE = np.zeros((15, 16), np.int64)
_tz_len = [
    [1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9],
    [3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6],
    [4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6],
    [5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5],
    [4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5],
    [6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6],
    [6, 5, 3, 3, 3, 2, 3, 4, 3, 6],
    [6, 4, 5, 3, 2, 2, 3, 3, 6],
    [6, 6, 4, 2, 2, 3, 2, 5],
    [5, 5, 3, 2, 2, 2, 4],
    [4, 4, 3, 3, 1, 3],
    [4, 4, 2, 1, 3],
    [3, 3, 1, 2],
    [2, 2, 1],
    [1, 1],
]
_tz_code = [
    [1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1],
    [7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0],
    [5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0],
    [3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0],
    [5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0],
    [1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0],
    [1, 1, 5, 4, 3, 3, 2, 1, 1, 0],
    [1, 1, 1, 3, 3, 2, 2, 1, 0],
    [1, 0, 1, 3, 2, 1, 1, 1],
    [1, 0, 1, 3, 2, 1, 1],
    [0, 1, 1, 2, 1, 3],
    [0, 1, 1, 1, 1],
    [0, 1, 1, 1],
    [0, 1, 1],
    [0, 1],
]
for _i, (_l, _c) in enumerate(zip(_tz_len, _tz_code)):
    TOTAL_ZEROS_LEN[_i, :len(_l)] = _l
    TOTAL_ZEROS_CODE[_i, :len(_c)] = _c

# run_before (Table 9-10): rows = min(zerosLeft, 7) - 1
RUN_BEFORE_LEN = np.zeros((7, 16), np.int64)
RUN_BEFORE_CODE = np.zeros((7, 16), np.int64)
_rb_len = [
    [1, 1], [1, 2, 2], [2, 2, 2, 2], [2, 2, 2, 3, 3], [2, 2, 3, 3, 3, 3],
    [2, 3, 3, 3, 3, 3, 3], [3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11],
]
_rb_code = [
    [1, 0], [1, 1, 0], [3, 2, 1, 0], [3, 2, 1, 1, 0], [3, 2, 3, 2, 1, 0],
    [3, 0, 1, 3, 2, 5, 4], [7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1],
]
for _i, (_l, _c) in enumerate(zip(_rb_len, _rb_code)):
    RUN_BEFORE_LEN[_i, :len(_l)] = _l
    RUN_BEFORE_CODE[_i, :len(_c)] = _c

INC_VLC = np.array([0, 3, 6, 12, 24, 48, 32768], dtype=np.int64)


# ---------------------------------------------------------------------------
# Block field extraction (vectorized)
# ---------------------------------------------------------------------------

def block_fields(zz: np.ndarray):
    """From zig-zag levels [N, 16] compute (total, t1, t1_signs, levels,
    runs, total_zeros): packed per-block arrays (levels/runs [N, 16], entry k
    = k-th nonzero in scan order)."""
    zz = np.asarray(zz, dtype=np.int64)
    N = zz.shape[0]
    nz = zz != 0
    total = nz.sum(axis=1)

    order = np.argsort(np.where(nz, np.arange(16)[None, :], 100), axis=1,
                       kind="stable")
    pos = np.take_along_axis(np.where(nz, np.arange(16)[None, :], 0), order, 1)
    levels = np.take_along_axis(zz, order, 1)          # packed, tail garbage
    k_idx = np.arange(16)[None, :]
    valid = k_idx < total[:, None]
    levels = np.where(valid, levels, 0)
    pos = np.where(valid, pos, 0)

    prev_pos = np.concatenate([np.full((N, 1), -1), pos[:, :-1]], axis=1)
    runs = np.where(valid, pos - prev_pos - 1, 0)

    last_pos = np.where(total > 0, pos[np.arange(N), np.maximum(total - 1, 0)], -1)
    total_zeros = np.where(total > 0, last_pos + 1 - total, 0)

    # trailing ones: walk back from the last coeff, up to 3
    t1 = np.zeros(N, np.int64)
    t1_signs = np.zeros((N, 3), np.int64)   # sign bits in coding order (high->low)
    stopped = total == 0
    for j in range(3):
        k = total - 1 - j
        lv = levels[np.arange(N), np.maximum(k, 0)]
        is_one = (np.abs(lv) == 1) & (k >= 0) & ~stopped
        t1_signs[np.arange(N), j] = np.where(is_one & (lv < 0), 1, 0)
        t1 += is_one
        stopped |= ~is_one
    return total, t1, t1_signs, levels, runs, total_zeros


def nc_context(total_map: np.ndarray) -> np.ndarray:
    """nC predictor per block from the in-plane left/top TotalCoeffs."""
    cy, cx = total_map.shape
    nA = np.zeros_like(total_map)
    nB = np.zeros_like(total_map)
    nA[:, 1:] = total_map[:, :-1]
    nB[1:, :] = total_map[:-1, :]
    has_a = np.zeros((cy, cx), bool)
    has_b = np.zeros((cy, cx), bool)
    has_a[:, 1:] = True
    has_b[1:, :] = True
    both = has_a & has_b
    return np.where(both, (nA + nB + 1) >> 1,
           np.where(has_a, nA, np.where(has_b, nB, 0)))


def _level_code(level: np.ndarray, vlcnum: np.ndarray):
    """(code, len) of a level symbol for per-element vlcnum (0 => VLC1)."""
    sign = (level < 0).astype(np.int64)
    # --- VLC1 (JM writeSyntaxElement_Level_VLC1) ---
    labs = np.abs(level)
    len1 = np.where(labs < 8, labs * 2 + sign - 1, 0)
    code1 = np.where(labs < 8, 1, 0)
    esc1 = (labs >= 8) & (labs < 16)
    len1 = np.where(esc1, 19, len1)
    code1 = np.where(esc1, 16 | ((labs << 1) - 16) | sign, code1)
    big1 = labs >= 16
    lm16 = labs + 2032
    npfx1 = np.zeros_like(labs)
    for _ in range(16):
        npfx1 = np.where(lm16 >= (4096 << npfx1).astype(np.int64) if False else
                         lm16 >= (np.int64(4096) << npfx1), npfx1 + 1, npfx1)
    imask1 = np.int64(4096) << npfx1
    len1 = np.where(big1, 28 + (npfx1 << 1), len1)
    code1 = np.where(big1, imask1 | ((lm16 << 1) - imask1) | sign, code1)

    # --- VLCN (writeSyntaxElement_Level_VLCN) ---
    vl = np.maximum(vlcnum, 1)
    labn = np.abs(level) - 1
    shift = vl - 1
    escape = np.int64(15) << shift
    sufmask = ~((np.int64(-1)) << shift)
    in_range = labn < escape
    lenn = np.where(in_range, (labn >> shift) + 1 + vl, 0)
    coden = np.where(in_range,
                     (np.int64(2) << shift) | ((labn & sufmask) << 1) | sign, 0)
    lesc = labn - escape + 2048
    npfxn = np.zeros_like(labn)
    for _ in range(16):
        npfxn = np.where(lesc >= (np.int64(4096) << npfxn), npfxn + 1, npfxn)
    imaskn = np.int64(4096) << npfxn
    lenn = np.where(~in_range, 28 + (npfxn << 1), lenn)
    coden = np.where(~in_range, imaskn | ((lesc << 1) - imaskn) | sign, coden)

    use1 = vlcnum == 0
    return np.where(use1, code1, coden), np.where(use1, len1, lenn)


def encode_blocks(zz: np.ndarray, nc: np.ndarray, w: BitWriter):
    """CAVLC-encode all blocks (raster order) into the BitWriter."""
    N = zz.shape[0]
    total, t1, t1_signs, levels, runs, total_zeros = block_fields(zz)
    nc = np.asarray(nc, dtype=np.int64).reshape(N)

    MAXS = 1 + 3 + 16 + 1 + 15
    codes = np.zeros((N, MAXS), np.int64)
    lens = np.zeros((N, MAXS), np.int64)
    s = 0

    # coeff_token
    vt = np.where(nc < 2, 0, np.where(nc < 4, 1, np.where(nc < 8, 2, 3)))
    flc_code = np.where(total > 0, ((total - 1) << 2) | t1, 3)
    tok_code = np.where(vt == 3, flc_code,
                        COEFF_TOKEN_CODE[np.minimum(vt, 2), t1, total])
    tok_len = np.where(vt == 3, 6,
                       COEFF_TOKEN_LEN[np.minimum(vt, 2), t1, total])
    codes[:, s], lens[:, s] = tok_code, tok_len
    s += 1

    # trailing-one signs (coded high->low scan order)
    for j in range(3):
        sel = j < t1
        codes[:, s] = t1_signs[:, j]
        lens[:, s] = np.where(sel, 1, 0)
        s += 1

    # levels, from k = total-1-t1 down to 0
    vlcnum = np.where((total > 10) & (t1 < 3), 1, 0).astype(np.int64)
    first = np.ones(N, bool)
    lth = ~((total > 3) & (t1 == 3))     # level_two_or_higher
    for step in range(16):
        k = total - 1 - t1 - step
        sel = k >= 0
        lv = levels[np.arange(N), np.maximum(k, 0)]
        adj = np.where(first & lth & sel, np.where(lv > 0, lv - 1, lv + 1), lv)
        code, ln = _level_code(adj, vlcnum)
        codes[:, s] = np.where(sel, code, 0)
        lens[:, s] = np.where(sel, ln, 0)
        s += 1
        # state update (only for selected lanes)
        inc = np.abs(lv) > INC_VLC[np.minimum(vlcnum, 6)]
        vlcnum = np.where(sel & inc, vlcnum + 1, vlcnum)
        big_first = first & sel & (np.abs(lv) > 3)
        vlcnum = np.where(big_first, np.maximum(vlcnum, 2), vlcnum)
        first = first & ~sel if False else np.where(sel, False, first)

    # total_zeros (only when 0 < total < 16)
    sel = (total > 0) & (total < 16)
    row = np.clip(total - 1, 0, 14)
    codes[:, s] = np.where(sel, TOTAL_ZEROS_CODE[row, np.minimum(total_zeros, 15)], 0)
    lens[:, s] = np.where(sel, TOTAL_ZEROS_LEN[row, np.minimum(total_zeros, 15)], 0)
    s += 1

    # run_before, from k = total-1 down to 1 while zerosleft > 0
    zerosleft = total_zeros.copy()
    for step in range(15):
        k = total - 1 - step
        sel = (k >= 1) & (zerosleft > 0)
        run = runs[np.arange(N), np.maximum(k, 0)]
        row = np.minimum(np.maximum(zerosleft, 1) - 1, 6)
        codes[:, s] = np.where(sel, RUN_BEFORE_CODE[row, np.minimum(run, 15)], 0)
        lens[:, s] = np.where(sel, RUN_BEFORE_LEN[row, np.minimum(run, 15)], 0)
        s += 1
        zerosleft = np.where(sel, zerosleft - run, zerosleft)

    mask = lens.reshape(-1) > 0
    w.raw(codes.reshape(-1)[mask], lens.reshape(-1)[mask])


def encode_plane(zz: np.ndarray, cy: int, cx: int, w: BitWriter):
    """Encode a plane's blocks (raster [cy*cx, 16]) with in-plane nC."""
    total = (np.asarray(zz) != 0).sum(axis=1).reshape(cy, cx)
    nc = nc_context(total)
    encode_blocks(np.asarray(zz), nc.reshape(-1), w)


# ---------------------------------------------------------------------------
# Decoder (sequential)
# ---------------------------------------------------------------------------

def _build_token_decoder():
    tabs = []
    for v in range(3):
        m = {}
        for t1 in range(4):
            for tot in range(17):
                ln = int(COEFF_TOKEN_LEN[v, t1, tot])
                if ln:
                    m[(ln, int(COEFF_TOKEN_CODE[v, t1, tot]))] = (tot, t1)
        tabs.append(m)
    return tabs


_TOKEN_DEC = _build_token_decoder()


def _read_vlc(r: BitReader, table: dict, max_len: int = 16):
    ln, code = 0, 0
    for _ in range(max_len):
        code = (code << 1) | r.u(1)
        ln += 1
        if (ln, code) in table:
            return table[(ln, code)]
    raise ValueError("bad VLC code")


_TZ_DEC = [{(int(TOTAL_ZEROS_LEN[i, j]), int(TOTAL_ZEROS_CODE[i, j])): j
            for j in range(16) if TOTAL_ZEROS_LEN[i, j]} for i in range(15)]
_RB_DEC = [{(int(RUN_BEFORE_LEN[i, j]), int(RUN_BEFORE_CODE[i, j])): j
            for j in range(16) if RUN_BEFORE_LEN[i, j]} for i in range(7)]


def _read_level(r: BitReader, vlcnum: int) -> int:
    """Inverse of the JM level writers.  Bit layout (MSB-first `inf` in `len`
    bits): prefix zeros, a leading 1, then suffix bits.
      VLC1 in-range  : prefix p <= 13 encodes labs=(p>>1)+1, sign=p&1.
      VLC1 escape 1  : p == 14, 4 suffix bits s: labs=8+(s>>1), sign=s&1.
      escape 2 (both): p >= 15, nbits=12+(p-15) suffix bits; the full value
                       (leading 1 included) is 2*m+sign with m = labs+2032
                       (VLC1) or labs-1-escape+2048 (VLCN).
      VLCN in-range  : p < 15; suffix = `shift` bits + sign bit;
                       labs = (p<<shift) + suffix + 1.
    """
    prefix = 0
    while r.u(1) == 0:
        prefix += 1
        if prefix > 48:
            raise ValueError("bad level prefix")
    shift = max(vlcnum - 1, 0)
    if vlcnum == 0:
        if prefix < 14:
            labs = (prefix >> 1) + 1
            sign = prefix & 1
            return -labs if sign else labs
        if prefix == 14:
            suf = r.u(4)
            labs = 8 + (suf >> 1)
            return -labs if (suf & 1) else labs
        nbits = prefix - 15 + 12
        full = (1 << nbits) | r.u(nbits)
        labs = (full >> 1) - 2032
        return -labs if (full & 1) else labs
    if prefix < 15:
        suffix = r.u(shift) if shift else 0
        sign = r.u(1)
        labs = (prefix << shift) + suffix + 1
        return -labs if sign else labs
    nbits = prefix - 15 + 12
    full = (1 << nbits) | r.u(nbits)
    labs = (full >> 1) - 2048 + (15 << shift) + 1
    return -labs if (full & 1) else labs


def decode_plane(r: BitReader, cy: int, cx: int) -> np.ndarray:
    """Sequentially parse a CAVLC plane; returns zz [cy*cx, 16]."""
    zz = np.zeros((cy * cx, 16), np.int64)
    total_map = np.zeros((cy, cx), np.int64)
    for by in range(cy):
        for bx in range(cx):
            nA = total_map[by, bx - 1] if bx > 0 else 0
            nB = total_map[by - 1, bx] if by > 0 else 0
            if bx > 0 and by > 0:
                nc = (nA + nB + 1) >> 1
            elif bx > 0:
                nc = nA
            elif by > 0:
                nc = nB
            else:
                nc = 0
            if nc < 2:
                vt = 0
            elif nc < 4:
                vt = 1
            elif nc < 8:
                vt = 2
            else:
                vt = 3
            if vt == 3:
                code = r.u(6)
                if code == 3:
                    total, t1 = 0, 0
                else:
                    total, t1 = (code >> 2) + 1, code & 3
            else:
                total, t1 = _read_vlc(r, _TOKEN_DEC[vt])
            total_map[by, bx] = total
            if total == 0:
                continue
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
            if total < 16:
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
            b = by * cx + bx
            for k in range(total):
                pos += runs[k] + 1
                zz[b, pos] = levels[k]
    return zz
