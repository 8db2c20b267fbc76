"""CABAC — context-adaptive binary arithmetic coding (H.264 M-coder).

TPU-framework equivalent of the reference's CABAC layer
(``FR/src/cabac.c:202`` writeSyntaxElement_CABAC, ``FR/src/biariencode.c``
biari_encode_symbol / ``FR/src/biaridecod.c``, contexts ``FR/src/context_ini.c``).
The arithmetic-coder constants are the H.264 spec tables 9-35/9-36
(``FR/inc/biariencode.h:47-136`` rLPS_table_64x4 / AC_next_state_{MPS,LPS}_64).

Architecture: the M-coder is inherently bit-serial, so it runs on the HOST —
a C++ fast path (native/fvc_native.cpp cabac_{encode,decode}_plane) with this
module as the bit-exact pure-Python reference and fallback.  The TPU produces
the quantized level arrays; binarization + arithmetic coding never touch the
device.  Contexts are reset per plane-call — the per-slice reset semantics of
``cabac_new_slice`` (``FR/src/cabac.c:59``), which is also what makes
tile-parallel entropy coding possible (SURVEY §5).

Residual block syntax follows H.264 9.3.2.3 (CBF + significance map + UEG0
levels), with per-scan-position significance contexts and the spec's
abs-level context increments (ctx 0..9).

The port's own copy of ``h264tpu/entropy/cabac_eng.py`` (the pure-Python
engine; the port has no native CABAC); it imports nothing from ``h264tpu``.
"""

from __future__ import annotations

import numpy as np

# --- spec table 9-35: rLPS given (state, (range>>6)&3) ---------------------
RLPS_64x4 = np.array([
    [128, 176, 208, 240], [128, 167, 197, 227], [128, 158, 187, 216],
    [123, 150, 178, 205], [116, 142, 169, 195], [111, 135, 160, 185],
    [105, 128, 152, 175], [100, 122, 144, 166], [95, 116, 137, 158],
    [90, 110, 130, 150], [85, 104, 123, 142], [81, 99, 117, 135],
    [77, 94, 111, 128], [73, 89, 105, 122], [69, 85, 100, 116],
    [66, 80, 95, 110], [62, 76, 90, 104], [59, 72, 86, 99],
    [56, 69, 81, 94], [53, 65, 77, 89], [51, 62, 73, 85],
    [48, 59, 69, 80], [46, 56, 66, 76], [43, 53, 63, 72],
    [41, 50, 59, 69], [39, 48, 56, 65], [37, 45, 54, 62],
    [35, 43, 51, 59], [33, 41, 48, 56], [32, 39, 46, 53],
    [30, 37, 43, 50], [29, 35, 41, 48], [27, 33, 39, 45],
    [26, 31, 37, 43], [24, 30, 35, 41], [23, 28, 33, 39],
    [22, 27, 32, 37], [21, 26, 30, 35], [20, 24, 29, 33],
    [19, 23, 27, 31], [18, 22, 26, 30], [17, 21, 25, 28],
    [16, 20, 23, 27], [15, 19, 22, 25], [14, 18, 21, 24],
    [14, 17, 20, 23], [13, 16, 19, 22], [12, 15, 18, 21],
    [12, 14, 17, 20], [11, 14, 16, 19], [11, 13, 15, 18],
    [10, 12, 15, 17], [10, 12, 14, 16], [9, 11, 13, 15],
    [9, 11, 12, 14], [8, 10, 12, 14], [8, 9, 11, 13],
    [7, 9, 11, 12], [7, 9, 10, 12], [7, 8, 10, 11],
    [6, 8, 9, 11], [6, 7, 9, 10], [6, 7, 8, 9], [2, 2, 2, 2],
], dtype=np.int64)

# --- spec table 9-36: state transitions -------------------------------------
NEXT_MPS = np.array(list(range(1, 62)) + [62, 62, 63], dtype=np.int64)
NEXT_LPS = np.array([
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12, 13, 13, 15, 15,
    16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24, 24, 25, 26, 26, 27, 27,
    28, 29, 29, 30, 30, 30, 31, 32, 32, 33, 33, 33, 34, 34, 35, 35, 35, 36,
    36, 36, 37, 37, 37, 38, 38, 63], dtype=np.int64)

HALF = 0x200      # B_BITS = 10 as in the reference coder
QUARTER = 0x100

# context layout per plane (reset each call): 4 CBF + 15 SIG + 15 LAST + 10 ABS
CTX_CBF = 0
CTX_SIG = 4
CTX_LAST = 19
CTX_ABS = 34
NUM_CTX = 44


class Encoder:
    """Binary arithmetic encoder (spec 9.3.4 flow, JM-style carry counter)."""

    def __init__(self, num_ctx: int = NUM_CTX):
        self.low = 0
        self.range = HALF - 2
        self.bits_to_follow = 0
        self.out = bytearray()
        self._buf = 0
        self._nbuf = 0
        self.state = np.zeros(num_ctx, dtype=np.int64)
        self.mps = np.zeros(num_ctx, dtype=np.int64)
        self._first = True  # swallow first redundant bit (Ebits_to_go=9 trick)

    # bit plumbing ---------------------------------------------------------
    def _putbit(self, b: int):
        if self._first:          # the spec's leading-bit discard
            self._first = False
            return
        self._buf = (self._buf << 1) | b
        self._nbuf += 1
        if self._nbuf == 8:
            self.out.append(self._buf)
            self._buf = 0
            self._nbuf = 0

    def _put_with_outstanding(self, b: int):
        self._putbit(b)
        nb = 1 - b
        while self.bits_to_follow > 0:
            self.bits_to_follow -= 1
            self._putbit(nb)

    def _renorm(self):
        while self.range < QUARTER:
            if self.low >= HALF:
                self._put_with_outstanding(1)
                self.low -= HALF
            elif self.low < QUARTER:
                self._put_with_outstanding(0)
            else:
                self.bits_to_follow += 1
                self.low -= QUARTER
            self.low <<= 1
            self.range <<= 1

    # coding primitives ------------------------------------------------------
    def bit(self, ctx: int, b: int):
        state = int(self.state[ctx])
        rlps = int(RLPS_64x4[state][(self.range >> 6) & 3])
        self.range -= rlps
        if b != self.mps[ctx]:
            self.low += self.range
            self.range = rlps
            if state == 0:
                self.mps[ctx] = 1 - self.mps[ctx]
            self.state[ctx] = NEXT_LPS[state]
        else:
            self.state[ctx] = NEXT_MPS[state]
        self._renorm()

    def bypass(self, b: int):
        self.low <<= 1
        if b:
            self.low += self.range
        if self.low >= 2 * HALF:
            self._put_with_outstanding(1)
            self.low -= 2 * HALF
        elif self.low < HALF:
            self._put_with_outstanding(0)
        else:
            self.bits_to_follow += 1
            self.low -= HALF

    def terminate0(self):
        """end_of_slice_flag = 0 (biari_encode_symbol_final(0)): the
        rLPS=2 terminate decision without ending the stream."""
        self.range -= 2
        self._renorm()

    def init_contexts(self, states, mps):
        """Load externally initialized (state, MPS) context arrays."""
        self.state = np.asarray(states, np.int64).copy()
        self.mps = np.asarray(mps, np.int64).copy()

    def flush(self) -> bytes:
        """Terminate and return bytes.

        Encodes the spec's end-of-stream terminate decision (rLPS=2 path of
        biari_encode_symbol_final) so that after renorm only ~2 values remain
        possible, then writes the JM ``arienco_done_encoding`` trailer
        (``FR/src/biariencode.c:133``): low bits 9 and 8 + a stop bit.
        """
        self.range -= 2
        self.low += self.range
        self.range = 2
        self._renorm()
        self._put_with_outstanding((self.low >> 9) & 1)
        self._putbit((self.low >> 8) & 1)
        self._putbit(1)            # stop bit
        while self._nbuf:          # zero-pad to byte
            self._putbit(0)
        return bytes(self.out)


class Decoder:
    """Binary arithmetic decoder mirroring :class:`Encoder`."""

    def __init__(self, data: bytes, num_ctx: int = NUM_CTX):
        self.data = data
        self.bitpos = 0
        self.value = 0
        for _ in range(B_INIT_BITS):
            self.value = (self.value << 1) | self._read1()
        self.range = HALF - 2
        self.state = np.zeros(num_ctx, dtype=np.int64)
        self.mps = np.zeros(num_ctx, dtype=np.int64)

    def _read1(self) -> int:
        p = self.bitpos
        self.bitpos += 1
        if (p >> 3) >= len(self.data):
            return 0
        return (self.data[p >> 3] >> (7 - (p & 7))) & 1

    def bit(self, ctx: int) -> int:
        state = int(self.state[ctx])
        rlps = int(RLPS_64x4[state][(self.range >> 6) & 3])
        self.range -= rlps
        if self.value < self.range:
            b = int(self.mps[ctx])
            self.state[ctx] = NEXT_MPS[state]
        else:
            b = 1 - int(self.mps[ctx])
            self.value -= self.range
            self.range = rlps
            if state == 0:
                self.mps[ctx] = 1 - self.mps[ctx]
            self.state[ctx] = NEXT_LPS[state]
        while self.range < QUARTER:
            self.range <<= 1
            self.value = (self.value << 1) | self._read1()
        return b

    def bypass(self) -> int:
        self.value = (self.value << 1) | self._read1()
        if self.value >= self.range:
            self.value -= self.range
            return 1
        return 0

    def terminate(self) -> int:
        """end_of_slice_flag decode (biari_decode_final)."""
        self.range -= 2
        if self.value < self.range:
            while self.range < QUARTER:
                self.range <<= 1
                self.value = (self.value << 1) | self._read1()
            return 0
        return 1

    def init_contexts(self, states, mps):
        self.state = np.asarray(states, np.int64).copy()
        self.mps = np.asarray(mps, np.int64).copy()


B_INIT_BITS = 9  # decoder preload: B_BITS - 1


# ---------------------------------------------------------------------------
# Residual plane coding (H.264 9.3.2.3 semantics on 4x4 blocks)
# ---------------------------------------------------------------------------

def _encode_level(enc: Encoder, v: int, num_eq1: int, num_gt1: int):
    """coeff_abs_level_minus1 as UEG0 (uCoff=14) + bypass sign."""
    a = abs(v) - 1
    if num_gt1:
        c0 = CTX_ABS + 0
    else:
        c0 = CTX_ABS + min(4, 1 + num_eq1)
    cn = CTX_ABS + 5 + min(4, num_gt1)
    # truncated unary prefix, cMax=14
    if a == 0:
        enc.bit(c0, 0)
    else:
        enc.bit(c0, 1)
        for _ in range(min(a, 14) - 1):
            enc.bit(cn, 1)
        if a < 14:
            enc.bit(cn, 0)
        else:
            # EG0 suffix in bypass for a-14
            x = a - 14
            k = 0
            while x >= (1 << k):
                enc.bypass(1)
                x -= 1 << k
                k += 1
            enc.bypass(0)
            for i in range(k - 1, -1, -1):
                enc.bypass((x >> i) & 1)
    enc.bypass(1 if v < 0 else 0)


def _decode_level(dec: Decoder, num_eq1: int, num_gt1: int) -> int:
    if num_gt1:
        c0 = CTX_ABS + 0
    else:
        c0 = CTX_ABS + min(4, 1 + num_eq1)
    cn = CTX_ABS + 5 + min(4, num_gt1)
    if dec.bit(c0) == 0:
        a = 0
    else:
        a = 1
        while a < 14 and dec.bit(cn):
            a += 1
        if a == 14:
            k = 0
            while dec.bypass():      # EG0 prefix
                a += 1 << k
                k += 1
            x = 0
            for _ in range(k):       # EG0 suffix bits
                x = (x << 1) | dec.bypass()
            a += x
    sign = dec.bypass()
    v = a + 1
    return -v if sign else v


def encode_plane(zz: np.ndarray, cy: int, cx: int) -> bytes:
    """Encode a plane of cy*cx 4x4 blocks' zig-zag levels; fresh contexts."""
    zz = np.asarray(zz, dtype=np.int64).reshape(cy, cx, 16)
    enc = Encoder()
    cbf_map = np.zeros((cy, cx), dtype=np.int64)
    for by in range(cy):
        for bx in range(cx):
            blk = zz[by, bx]
            nzpos = np.nonzero(blk)[0]
            cbf = 1 if nzpos.size else 0
            ca = cbf_map[by, bx - 1] if bx > 0 else 0
            cb = cbf_map[by - 1, bx] if by > 0 else 0
            enc.bit(CTX_CBF + int(ca + 2 * cb), cbf)
            cbf_map[by, bx] = cbf
            if not cbf:
                continue
            last = int(nzpos[-1])
            for i in range(15):
                sig = 1 if blk[i] != 0 else 0
                enc.bit(CTX_SIG + i, sig)
                if sig:
                    enc.bit(CTX_LAST + i, 1 if i == last else 0)
                    if i == last:
                        break
            num_eq1 = num_gt1 = 0
            for i in range(last, -1, -1):
                if blk[i] == 0:
                    continue
                _encode_level(enc, int(blk[i]), num_eq1, num_gt1)
                if abs(int(blk[i])) == 1:
                    num_eq1 += 1
                else:
                    num_gt1 += 1
    return enc.flush()


def decode_plane(data: bytes, cy: int, cx: int) -> np.ndarray:
    dec = Decoder(data)
    zz = np.zeros((cy, cx, 16), dtype=np.int64)
    cbf_map = np.zeros((cy, cx), dtype=np.int64)
    for by in range(cy):
        for bx in range(cx):
            ca = cbf_map[by, bx - 1] if bx > 0 else 0
            cb = cbf_map[by - 1, bx] if by > 0 else 0
            cbf = dec.bit(CTX_CBF + int(ca + 2 * cb))
            cbf_map[by, bx] = cbf
            if not cbf:
                continue
            sig = np.zeros(16, dtype=np.int64)
            last = 15
            for i in range(15):
                if dec.bit(CTX_SIG + i):
                    sig[i] = 1
                    if dec.bit(CTX_LAST + i):
                        last = i
                        break
            else:
                sig[15] = 1  # reached pos 15: implied significant
            if last == 15:
                sig[15] = 1
            num_eq1 = num_gt1 = 0
            for i in range(last, -1, -1):
                if not sig[i]:
                    continue
                v = _decode_level(dec, num_eq1, num_gt1)
                zz[by, bx, i] = v
                if abs(v) == 1:
                    num_eq1 += 1
                else:
                    num_gt1 += 1
    return zz.reshape(cy * cx, 16)
