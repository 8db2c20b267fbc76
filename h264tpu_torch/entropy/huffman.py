"""Canonical Huffman coding over symbol histograms (the port's own copy of
``h264tpu/entropy/huffman.py``; host numpy, it imports nothing from
``h264tpu``).

Equivalent of the reference's per-frame Huffman layer
(``CreateHuffmanCodeBook`` / ``HuffmanEncoder`` / ``HuffmanDecoder``,
FR/src/huffman.c:5,:89,:156) and of the JPEG-style Huffman entropy stage of
the legacy still-image codec (``HufBlock``, FR/src/i_Decode.c:248).

Design: the histogram→codebook build and the (tiny) serialized codebook are
host-side numpy (they are O(#symbols), not O(#pixels)); the bulk
symbols→bits conversion is a vectorized table lookup packed with the shared
:class:`~h264tpu_torch.entropy.bitio.BitWriter`.  Codes are **canonical** — only
the code LENGTH per symbol is stored in the stream (the reference serializes
full codebooks; canonical lengths are strictly smaller and reconstruct the
same prefix code deterministically).
"""

from __future__ import annotations

import heapq

import numpy as np

from .bitio import BitReader, BitWriter

MAX_LEN = 24  # plenty for <= 2^16 symbols with clamped histograms


def code_lengths(freqs: np.ndarray) -> np.ndarray:
    """Huffman code length per symbol from a histogram.

    Zero-frequency symbols get length 0 (not in the code).  A single-symbol
    alphabet gets length 1.  Lengths exceeding MAX_LEN are flattened by
    histogram damping (rare; keeps the serialized length field fixed-width).
    """
    freqs = np.asarray(freqs, dtype=np.int64)
    n = len(freqs)
    lengths = np.zeros(n, dtype=np.int32)
    active = np.nonzero(freqs > 0)[0]
    if len(active) == 0:
        return lengths
    if len(active) == 1:
        lengths[active[0]] = 1
        return lengths
    f = freqs.copy()
    while True:
        # heap of (freq, tiebreak, leaf-set as list) — standard Huffman merge
        heap = [(int(f[i]), int(i), [int(i)]) for i in active]
        heapq.heapify(heap)
        cnt = n
        depth = np.zeros(n, dtype=np.int32)
        while len(heap) > 1:
            f1, _, s1 = heapq.heappop(heap)
            f2, _, s2 = heapq.heappop(heap)
            for i in s1 + s2:
                depth[i] += 1
            heapq.heappush(heap, (f1 + f2, cnt, s1 + s2))
            cnt += 1
        if depth.max() <= MAX_LEN:
            lengths[:] = depth
            return lengths
        f[active] = (f[active] + 1) >> 1  # damp and retry (flattens the tree)


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical prefix codes from lengths (shorter codes first, then symbol
    order).  Returns uint32 codes, MSB-first, valid where ``lengths > 0``."""
    lengths = np.asarray(lengths, dtype=np.int32)
    codes = np.zeros(len(lengths), dtype=np.uint32)
    order = np.argsort(lengths + (lengths == 0) * (MAX_LEN + 2), kind="stable")
    code = 0
    prev_len = 0
    for s in order:
        l = int(lengths[s])
        if l == 0:
            break
        code <<= (l - prev_len)
        codes[s] = code
        code += 1
        prev_len = l
    return codes


def write_codebook(w: BitWriter, lengths: np.ndarray):
    """Serialize: ue(n_symbols) then 5-bit length per symbol."""
    w.ue(np.asarray([len(lengths)], dtype=np.int64))
    w.u(np.asarray(lengths, dtype=np.int64), 5)


def read_codebook(r: BitReader) -> np.ndarray:
    n = r.ue()
    return r.u_array(n, 5).astype(np.int32)


def encode_symbols(w: BitWriter, symbols: np.ndarray, lengths: np.ndarray,
                   codes: np.ndarray | None = None):
    """Append Huffman bits for a symbol array (vectorized table lookup)."""
    if codes is None:
        codes = canonical_codes(lengths)
    sym = np.asarray(symbols, dtype=np.int64)
    w.raw(codes[sym].astype(np.int64), lengths[sym].astype(np.int64))


def decode_symbols(r: BitReader, lengths: np.ndarray, count: int) -> np.ndarray:
    """Read ``count`` symbols using the canonical code implied by lengths."""
    codes = canonical_codes(lengths)
    # first-code/first-symbol tables per length for canonical decode
    lengths = np.asarray(lengths, dtype=np.int32)
    order = np.argsort(lengths + (lengths == 0) * (MAX_LEN + 2), kind="stable")
    sym_by_rank = [int(s) for s in order if lengths[s] > 0]
    first_code = {}
    first_rank = {}
    rank = 0
    for s in sym_by_rank:
        l = int(lengths[s])
        if l not in first_code:
            first_code[l] = int(codes[s])
            first_rank[l] = rank
        rank += 1
    counts = {l: int((lengths == l).sum()) for l in first_code}
    out = np.empty(count, dtype=np.int64)
    for i in range(count):
        code = 0
        l = 0
        while True:
            code = (code << 1) | r.u(1)
            l += 1
            if l in first_code and code - first_code[l] < counts[l] \
                    and code >= first_code[l]:
                out[i] = sym_by_rank[first_rank[l] + code - first_code[l]]
                break
            if l > MAX_LEN:
                raise ValueError("corrupt Huffman stream")
    return out
