"""Legacy JPEG-like still-image I-frame codec (reference capability F22).

Port of ``h264tpu/models/legacy_icodec.py``, the re-design of the
reference's dormant still-image codec (``i_Frm_Encoder``
FR/src/i_Encode.c:531, ``i_Frm_Decoder`` FR/src/i_Decode.c:551, float 2-D
DCT ``FDCT_2D`` FR/src/DCT.c:40, quality scaling ``set_quant_table``
FR/src/i_Encode.c:43): 8x8 DCT + JPEG standard quantization tables scaled
by an ``I_Quality`` factor 1..100 + zigzag + DC-DPCM / AC-run-length
Huffman entropy coding.

The pixel path (blocking, the orthonormal 8x8 DCT-II as two 8x8 products
per block, quantization, zigzag) runs batched over every block of a plane
on the device; the entropy stage (sequential bit packing with per-image
adaptive canonical Huffman tables, ``entropy/huffman.py``) is a host copy.

The levels equal the JAX package's, not merely come close: each float32
product-sum adds in the order XLA's CPU backend adds an 8-long dot (four
fused multiply-add lanes, j and j + 4, then a pairwise sum), the
quantizer multiplies by the float32 reciprocal of the table as XLA
rewrites ``d / qt``, and ``torch.round`` rounds half to even like
``jnp.round``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device_const, resolve_device
from ..entropy import huffman as HUF
from ..entropy.bitio import BitReader, BitWriter

# JPEG Annex K standard base quantization tables (public spec constants; the
# reference embeds the same tables as std_{luminance,chrominance}_qt).
STD_LUMA_QT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], dtype=np.int64).reshape(8, 8)
STD_CHROMA_QT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99], dtype=np.int64).reshape(8, 8)


def scaled_qtable(base: np.ndarray, quality: int) -> np.ndarray:
    """JPEG quality 1..100 -> quant table (set_quant_table semantics,
    FR/src/i_Encode.c:43-66: sf = 5000/q below 50 else 200-2q;
    t = clip((base*sf+50)/100, 1, 255))."""
    q = int(np.clip(quality, 1, 100))
    sf = 5000 // q if q < 50 else 200 - q * 2
    t = (base * sf + 50) // 100
    return np.clip(t, 1, 255).astype(np.int64)


def _dct8_matrix() -> np.ndarray:
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    m[0] *= 1 / np.sqrt(2)
    return (m * 0.5).astype(np.float32)


_D8 = _dct8_matrix()


def _zigzag8() -> np.ndarray:
    """8x8 zigzag scan order (position i of the scan reads flat index
    ZZ8[i])."""
    order = sorted(((r + c, (c if (r + c) % 2 == 0 else r), r, c)
                    for r in range(8) for c in range(8)))
    return np.array([r * 8 + c for (_, _, r, c) in order], dtype=np.int64)


ZZ8 = _zigzag8()
ZZ8_INV = np.argsort(ZZ8)


def _table(name: str, value, device) -> torch.Tensor:
    return device_const(f"legacy_{name}", value, device)


def _dot8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last axis (8) of a*b (broadcast), added as
    XLA's CPU dot adds it: lane g in 0..3 holds a_g*b_g rounded, then
    fma(a_{g+4}, b_{g+4}, lane g); the result is (l0 + l1) + (l2 + l3).
    Each float32 product is exact in float64, so one float64 add and one
    narrowing give the fused lane."""
    p = a.to(torch.float64) * b.to(torch.float64)
    lane = [(p[..., g + 4] + p[..., g].to(torch.float32).to(torch.float64))
            .to(torch.float32) for g in range(4)]
    return (lane[0] + lane[1]) + (lane[2] + lane[3])


def _dct8(blocks: torch.Tensor, d8: torch.Tensor) -> torch.Tensor:
    """D @ X @ D^T of every block [B, 8, 8]: einsum("ij,bjk,lk->bil")
    contracted as jnp.einsum does, j first."""
    k = _dot8(blocks.transpose(1, 2)[:, :, None, :], d8)       # [b, k, i]
    return _dot8(k.transpose(1, 2)[:, :, None, :], d8)         # [b, i, l]


def _idct8(blocks: torch.Tensor, d8: torch.Tensor) -> torch.Tensor:
    """D^T @ X @ D of every block: einsum("ji,bjk,kl->bil"), j first."""
    dt = d8.t()
    n = _dot8(blocks.transpose(1, 2)[:, :, None, :], dt)       # [b, k, i]
    return _dot8(n.transpose(1, 2)[:, :, None, :], dt)         # [b, i, l]


def _blocks8(plane: torch.Tensor) -> torch.Tensor:
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(1, 2).reshape(
        -1, 8, 8)


def _unblocks8(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return blocks.reshape(h // 8, w // 8, 8, 8).transpose(1, 2).reshape(h, w)


def _qtable(quality: int, is_luma: bool) -> np.ndarray:
    return scaled_qtable(STD_LUMA_QT if is_luma else STD_CHROMA_QT,
                         quality).astype(np.float32)


def fdct_quant_plane(plane: torch.Tensor, quality: int, is_luma: bool):
    """Batched 8x8 FDCT + quantization + zigzag of a whole plane (a tensor
    on the device that computes it).  Returns [nblk, 64] int32 zigzagged
    levels.  Level-shift by 128 as in JPEG and the reference
    (fdct_and_quantization, FR/src/i_Encode.c:233)."""
    dev = plane.device
    qt = _qtable(quality, is_luma)
    recip = _table(f"recip{quality}{int(is_luma)}",
                   np.float32(1.0) / qt, dev)
    x = _blocks8(plane.to(torch.float32) - 128.0)
    d = _dct8(x, _table("d8", _D8, dev))
    lv = torch.round(d * recip).to(torch.int32)
    return lv.reshape(-1, 64)[:, _table("zz8", ZZ8, dev)]


def dequant_idct_plane(zz: torch.Tensor, quality: int, is_luma: bool,
                       h: int, w: int) -> torch.Tensor:
    """Inverse of :func:`fdct_quant_plane` -> uint8 plane [h, w]."""
    dev = zz.device
    qt = _table(f"qt{quality}{int(is_luma)}", _qtable(quality, is_luma), dev)
    lv = zz[:, _table("zz8_inv", ZZ8_INV, dev)].reshape(-1, 8, 8).to(
        torch.float32)
    x = _idct8(lv * qt, _table("d8", _D8, dev))
    out = torch.clamp(torch.round(x + 128.0), 0, 255).to(torch.uint8)
    return _unblocks8(out, h, w)


def _size_cat(v: np.ndarray) -> np.ndarray:
    """JPEG size category: bits needed for |v| (0 for v == 0)."""
    return np.where(v == 0, 0,
                    np.floor(np.log2(np.maximum(np.abs(v), 1))).astype(np.int64) + 1)


def _amp_bits(v: np.ndarray, size: np.ndarray):
    """JPEG amplitude coding: negative values stored as v + (2^size - 1)."""
    return np.where(v < 0, v + (1 << size) - 1, v).astype(np.int64)


def _amp_undo(bits: int, size: int) -> int:
    if size == 0:
        return 0
    if bits < (1 << (size - 1)):
        return bits - (1 << size) + 1
    return bits


def _entropy_encode_plane(w: BitWriter, zz: np.ndarray):
    """DC DPCM + AC (run,size) run-length symbols, adaptive canonical
    Huffman tables serialized in-stream (HufBlock syntax family,
    FR/src/i_Decode.c:248, with per-image tables instead of fixed ones)."""
    nblk = zz.shape[0]
    dc = zz[:, 0]
    dcd = np.diff(dc, prepend=0)
    dc_size = _size_cat(dcd)

    ac_syms = []          # (run<<4)|size, 0x00 = EOB, 0xF0 = ZRL
    ac_amp = []           # (value, size) pairs
    for b in range(nblk):
        run = 0
        row = zz[b]
        nz = np.nonzero(row[1:])[0]
        last = nz[-1] + 1 if len(nz) else 0
        for i in range(1, last + 1):
            v = int(row[i])
            if v == 0:
                run += 1
                if run == 16:
                    ac_syms.append(0xF0)
                    run = 0
                continue
            s = int(_size_cat(np.int64(v)))
            ac_syms.append((run << 4) | s)
            ac_amp.append((v, s))
            run = 0
        if last < 63:
            ac_syms.append(0x00)
    ac_syms = np.asarray(ac_syms, dtype=np.int64)

    dc_hist = np.bincount(dc_size, minlength=16)
    ac_hist = np.bincount(ac_syms, minlength=256)
    dc_len = HUF.code_lengths(dc_hist)
    ac_len = HUF.code_lengths(ac_hist)

    w.ue(np.asarray([nblk], dtype=np.int64))
    HUF.write_codebook(w, dc_len)
    HUF.write_codebook(w, ac_len)
    w.ue(np.asarray([len(ac_syms)], dtype=np.int64))

    dc_codes = HUF.canonical_codes(dc_len)
    HUF.encode_symbols(w, dc_size, dc_len, dc_codes)
    # DC amplitude bits interleaving is unnecessary for a grouped layout:
    # write all DC amplitudes, then AC symbols, then AC amplitudes (grouped
    # fields pack/unpack vectorized — same information, fewer host loops).
    nzdc = dc_size > 0
    w.raw(_amp_bits(dcd[nzdc], dc_size[nzdc]), dc_size[nzdc])
    HUF.encode_symbols(w, ac_syms, ac_len)
    if ac_amp:
        av = np.asarray([v for v, _ in ac_amp], dtype=np.int64)
        asz = np.asarray([s for _, s in ac_amp], dtype=np.int64)
        w.raw(_amp_bits(av, asz), asz)


def _entropy_decode_plane(r: BitReader) -> np.ndarray:
    nblk = r.ue()
    dc_len = HUF.read_codebook(r)
    ac_len = HUF.read_codebook(r)
    n_ac = r.ue()
    dc_size = HUF.decode_symbols(r, dc_len, nblk)
    dcd = np.zeros(nblk, dtype=np.int64)
    for i in range(nblk):
        s = int(dc_size[i])
        dcd[i] = _amp_undo(r.u(s), s) if s else 0
    ac_syms = HUF.decode_symbols(r, ac_len, n_ac)
    zz = np.zeros((nblk, 64), dtype=np.int64)
    zz[:, 0] = np.cumsum(dcd)
    # replay run-length symbols into positions, then read grouped amplitudes
    pos_list, size_list = [], []
    b, i = 0, 1
    for sym in ac_syms:
        sym = int(sym)
        if sym == 0x00:
            b += 1
            i = 1
            continue
        if sym == 0xF0:
            i += 16
            continue
        run, s = sym >> 4, sym & 15
        i += run
        pos_list.append((b, i))
        size_list.append(s)
        i += 1
        if i > 63:
            b += 1
            i = 1
    for (bb, ii), s in zip(pos_list, size_list):
        zz[bb, ii] = _amp_undo(r.u(s), s)
    return zz


MAGIC = b"LIC1"


def encode_image(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                 quality: int = 75, device=None) -> bytes:
    """Encode one YUV420 image with the legacy JPEG-like codec.
    ``device``: None is the CUDA card (raises without one)."""
    dev = resolve_device(device)
    w = BitWriter()
    for byte in MAGIC:
        w.u(np.asarray([byte], dtype=np.int64), 8)
    h, wd = y.shape
    w.u(np.asarray([h, wd, int(np.clip(quality, 1, 100))], dtype=np.int64), 16)
    levels = [fdct_quant_plane(torch.as_tensor(np.asarray(plane)).to(dev),
                               quality, is_luma)
              for plane, is_luma in ((y, True), (u, False), (v, False))]
    for zz in levels:
        _entropy_encode_plane(w, zz.cpu().numpy().astype(np.int64))
    return w.to_bytes()


def decode_image(stream: bytes, device=None):
    """Decode a legacy-codec image -> (y, u, v) uint8 numpy planes.
    ``device``: None is the CUDA card (raises without one)."""
    dev = resolve_device(device)
    r = BitReader(stream)
    magic = bytes(r.u(8) for _ in range(4))
    if magic != MAGIC:
        raise ValueError("not a legacy I-codec stream")
    h, wd, quality = (r.u(16) for _ in range(3))
    out = []
    for is_luma in (True, False, False):
        ph, pw = (h, wd) if is_luma else (h // 2, wd // 2)
        zz = torch.as_tensor(_entropy_decode_plane(r)).to(dev).to(torch.int32)
        out.append(dequant_idct_plane(zz, quality, is_luma, ph, pw))
    return tuple(pl.cpu().numpy() for pl in out)
