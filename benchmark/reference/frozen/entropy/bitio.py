"""Bit-level I/O: vectorized packer and Exp-Golomb codes.

The reference writes bits one syntax element at a time through
``writeSyntaxElement_UVLC`` / ``writeUVLC2buffer`` (``FR/src/vlc.c:548``).
The TPU-framework equivalent computes (codeword, bit-length) for ALL symbols
of a frame as arrays, then packs them in one vectorized scatter-OR pass —
there is no per-symbol Python/host loop on the encode path.

The port's own copy of ``h264tpu/entropy/bitio.py``.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Exp-Golomb (vectorized encode)
# ---------------------------------------------------------------------------

def ue_code(v: np.ndarray):
    """Unsigned Exp-Golomb: returns (codeword, nbits) arrays.

    codeword = v+1 rendered in 2*floor(log2(v+1))+1 bits (leading zeros are
    part of nbits).  v must be < 2^31 - 1.
    """
    v = np.asarray(v, dtype=np.int64)
    assert (v >= 0).all(), "ue() requires non-negative values"
    x = v + 1
    nbits_half = np.int64(np.floor(np.log2(x.astype(np.float64)) + 1e-12))
    # exact correction in case of float rounding at powers of two
    nbits_half = np.where((np.int64(1) << (nbits_half + 1)) <= x, nbits_half + 1, nbits_half)
    nbits_half = np.where((np.int64(1) << nbits_half) > x, nbits_half - 1, nbits_half)
    return x, 2 * nbits_half + 1


def se_code(v: np.ndarray):
    """Signed Exp-Golomb: v>0 -> 2v-1, v<=0 -> -2v (spec 9.1.1)."""
    v = np.asarray(v, dtype=np.int64)
    k = np.where(v > 0, 2 * v - 1, -2 * v)
    return ue_code(k)


class BitWriter:
    """Accumulates (value, nbits) symbol arrays, packs once at the end."""

    def __init__(self):
        self._vals: list = []
        self._lens: list = []

    def u(self, vals, nbits: int):
        """Fixed-width unsigned codes (array or scalar)."""
        v = np.atleast_1d(np.asarray(vals, dtype=np.int64))
        assert ((v >= 0) & (v < (1 << nbits))).all(), (v.min(), v.max(), nbits)
        self._vals.append(v)
        self._lens.append(np.full(v.shape, nbits, dtype=np.int64))

    def ue(self, vals):
        v, n = ue_code(np.atleast_1d(vals))
        self._vals.append(v)
        self._lens.append(n)

    def se(self, vals):
        v, n = se_code(np.atleast_1d(vals))
        self._vals.append(v)
        self._lens.append(n)

    def raw(self, codes, lens):
        """Append precomputed (codeword, bit-length) symbol arrays."""
        self._vals.append(np.atleast_1d(np.asarray(codes, dtype=np.int64)))
        self._lens.append(np.atleast_1d(np.asarray(lens, dtype=np.int64)))

    def bit_length(self) -> int:
        return int(sum(int(l.sum()) for l in self._lens))

    def to_bytes(self) -> bytes:
        """Pack all symbols (stream order = append order) into bytes,
        zero-padded to a byte boundary."""
        if not self._vals:
            return b""
        vals = np.concatenate(self._vals).astype(np.uint64)
        lens = np.concatenate(self._lens).astype(np.int64)
        ends = np.cumsum(lens)
        starts = ends - lens
        total = int(ends[-1])
        nbytes = (total + 7) // 8
        buf = np.zeros(nbytes + 8, dtype=np.uint8)

        byte0 = (starts >> 3).astype(np.int64)
        shift = (starts & 7).astype(np.uint64)
        # place each code in a 64-bit big-endian window starting at byte0
        window = vals << (np.uint64(64) - shift - lens.astype(np.uint64))
        for k in range(8):
            part = ((window >> np.uint64(56 - 8 * k)) & np.uint64(0xFF)).astype(np.uint8)
            np.bitwise_or.at(buf, byte0 + k, part)
        return buf[:nbytes].tobytes()


class BitReader:
    """Sequential bit reader over a byte buffer (decode side).

    Decoding variable-length codes is inherently sequential; this reader keeps
    the bits as an unpacked uint8 array so scans are numpy-fast.
    """

    def __init__(self, data: bytes):
        self.data = bytes(data)
        self._bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
        self.pos = 0

    def u(self, nbits: int) -> int:
        b = self._bits[self.pos:self.pos + nbits]
        self.pos += nbits
        out = 0
        for bit in b:
            out = (out << 1) | int(bit)
        return out

    def align(self):
        """Skip to the next byte boundary (pcm_alignment_zero_bit)."""
        self.pos += (-self.pos) % 8

    def u_array(self, count: int, nbits: int) -> np.ndarray:
        """Vectorized read of `count` fixed-width codes."""
        total = count * nbits
        b = self._bits[self.pos:self.pos + total].reshape(count, nbits)
        self.pos += total
        weights = (1 << np.arange(nbits - 1, -1, -1)).astype(np.int64)
        return (b.astype(np.int64) * weights).sum(axis=1)

    def ue(self) -> int:
        bits = self._bits
        p = self.pos
        # leading zero count
        nz = int(np.argmax(bits[p:p + 64]))
        if bits[p + nz] == 0:  # all zeros in window (shouldn't happen)
            raise ValueError("bad ue code")
        self.pos = p + nz
        x = self.u(nz + 1)
        return x - 1

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k & 1 else -(k // 2)

    def ue_array(self, count: int) -> np.ndarray:
        out = np.empty(count, dtype=np.int64)
        for i in range(count):
            out[i] = self.ue()
        return out

    def se_array(self, count: int) -> np.ndarray:
        out = np.empty(count, dtype=np.int64)
        for i in range(count):
            out[i] = self.se()
        return out

    def byte_align(self):
        self.pos = (self.pos + 7) & ~7
