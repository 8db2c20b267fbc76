"""Input processing: chroma formats, bit depths, RGB, TIFF (SURVEY J15).

The reference encoder ingests more than 8-bit YUV 4:2:0 — 4:2:2 / 4:4:4
planar YUV, >8-bit sample depths, interleaved RGB, and TIFF stills
(``JM/lencod/src/{input.c, img_process.c, io_raw.c, io_tiff.c,
cconv_yuv2rgb.c}``).  The coding core here is 8-bit 4:2:0, so this
module normalizes every supported input to that, the way JM's input
stage feeds its internal picture buffers:

* :func:`read_yuv_frame` — planar YUV at 4:2:0/4:2:2/4:4:4, 8 or 16-bit
  little-endian samples (>8-bit scaled down by the excess bits with
  rounding, JM's bit-depth rescale shape).
* :func:`chroma_to_420` — 4:4:4 -> 4:2:2 horizontal and 4:2:2 -> 4:2:0
  vertical co-sited averaging downsample.
* :func:`rgb_to_yuv` / :func:`yuv_to_rgb` — BT.601 limited-range
  integer conversion (the matrix family of ``cconv_yuv2rgb.c`` with the
  Y offset of 16 / chroma offset of 128).
* :func:`read_tiff` — minimal baseline-TIFF reader (uncompressed strips,
  8-bit grayscale or RGB) sufficient for ``io_tiff.c``-style stills.

The port's own copy of ``h264tpu/utils/input.py`` (host numpy).
"""

from __future__ import annotations

import struct

import numpy as np

CHROMA_420, CHROMA_422, CHROMA_444 = 420, 422, 444

_CHROMA_DIV = {CHROMA_420: (2, 2), CHROMA_422: (2, 1), CHROMA_444: (1, 1)}


def frame_bytes(width: int, height: int, chroma: int = CHROMA_420,
                bit_depth: int = 8) -> int:
    dx, dy = _CHROMA_DIV[chroma]
    n = width * height + 2 * (width // dx) * (height // dy)
    return n * (1 if bit_depth <= 8 else 2)


def _rescale_depth(plane: np.ndarray, bit_depth: int) -> np.ndarray:
    """>8-bit -> 8-bit: round-shift by the excess bits (JM rescale)."""
    if bit_depth <= 8:
        return plane.astype(np.uint8)
    sh = bit_depth - 8
    return ((plane.astype(np.int64) + (1 << (sh - 1))) >> sh).clip(
        0, 255).astype(np.uint8)


def read_yuv_frame(path: str, width: int, height: int, index: int = 0,
                   chroma: int = CHROMA_420, bit_depth: int = 8):
    """One planar YUV frame -> 8-bit 4:2:0 (Y, U, V) uint8 planes."""
    dx, dy = _CHROMA_DIV[chroma]
    cw, ch = width // dx, height // dy
    dt = np.uint8 if bit_depth <= 8 else np.dtype("<u2")
    fsz = frame_bytes(width, height, chroma, bit_depth)
    with open(path, "rb") as f:
        f.seek(index * fsz)
        raw = np.frombuffer(f.read(fsz), dt)
    y = raw[:width * height].reshape(height, width)
    u = raw[width * height:width * height + cw * ch].reshape(ch, cw)
    v = raw[width * height + cw * ch:].reshape(ch, cw)
    y, u, v = (_rescale_depth(p, bit_depth) for p in (y, u, v))
    u, v = (chroma_to_420(p, chroma) for p in (u, v))
    return y, u, v


def chroma_to_420(plane: np.ndarray, chroma: int) -> np.ndarray:
    """Downsample one chroma plane from ``chroma`` format to 4:2:0."""
    p = plane.astype(np.int64)
    if chroma == CHROMA_444:                       # horizontal 2:1 first
        p = (p[:, 0::2] + p[:, 1::2] + 1) >> 1
        chroma = CHROMA_422
    if chroma == CHROMA_422:                       # vertical 2:1
        p = (p[0::2, :] + p[1::2, :] + 1) >> 1
    return p.astype(np.uint8)


def rgb_to_yuv(rgb: np.ndarray):
    """[H, W, 3] uint8 RGB -> limited-range BT.601 4:2:0 (Y, U, V)."""
    r = rgb[..., 0].astype(np.float64)
    g = rgb[..., 1].astype(np.float64)
    b = rgb[..., 2].astype(np.float64)
    y = 16 + (65.481 * r + 128.553 * g + 24.966 * b) / 255.0
    u = 128 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255.0
    v = 128 + (112.0 * r - 93.786 * g - 18.214 * b) / 255.0
    y = np.clip(np.rint(y), 0, 255).astype(np.uint8)
    u = np.clip(np.rint(u), 0, 255).astype(np.uint8)
    v = np.clip(np.rint(v), 0, 255).astype(np.uint8)
    return y, chroma_to_420(u, CHROMA_444), chroma_to_420(v, CHROMA_444)


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """8-bit 4:2:0 -> [H, W, 3] uint8 RGB (inverse of :func:`rgb_to_yuv`;
    chroma upsampled by sample-and-hold like ``cconv_yuv2rgb.c``)."""
    uu = np.repeat(np.repeat(u, 2, 0), 2, 1).astype(np.float64) - 128
    vv = np.repeat(np.repeat(v, 2, 0), 2, 1).astype(np.float64) - 128
    yy = y.astype(np.float64) - 16
    r = 1.164 * yy + 1.596 * vv
    g = 1.164 * yy - 0.391 * uu - 0.813 * vv
    b = 1.164 * yy + 2.018 * uu
    return np.clip(np.rint(np.stack([r, g, b], -1)), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Minimal baseline TIFF (uncompressed strips; io_tiff.c scope)
# ---------------------------------------------------------------------------

_TIFF_TAGS = {256: "width", 257: "height", 258: "bits", 259: "compression",
              273: "strip_offsets", 277: "spp", 278: "rows_per_strip",
              279: "strip_counts"}


def read_tiff(path: str) -> np.ndarray:
    """Uncompressed baseline TIFF -> [H, W] gray or [H, W, 3] RGB uint8."""
    data = open(path, "rb").read()
    if data[:2] == b"II":
        e = "<"
    elif data[:2] == b"MM":
        e = ">"
    else:
        raise ValueError("not a TIFF file")
    magic, ifd_off = struct.unpack(e + "HI", data[2:8])
    if magic != 42:
        raise ValueError("bad TIFF magic")
    n = struct.unpack(e + "H", data[ifd_off:ifd_off + 2])[0]
    tags = {}
    _SZ = {1: 1, 2: 1, 3: 2, 4: 4}
    for i in range(n):
        off = ifd_off + 2 + 12 * i
        tag, typ, cnt = struct.unpack(e + "HHI", data[off:off + 8])
        if tag not in _TIFF_TAGS or typ not in _SZ:
            continue
        fmt = {1: "B", 3: "H", 4: "I"}.get(typ, "B")
        total = _SZ[typ] * cnt
        if total <= 4:
            raw = data[off + 8:off + 8 + total]
        else:
            ptr = struct.unpack(e + "I", data[off + 8:off + 12])[0]
            raw = data[ptr:ptr + total]
        vals = struct.unpack(e + str(cnt) + fmt, raw)
        tags[_TIFF_TAGS[tag]] = vals if cnt > 1 else vals[0]
    if tags.get("compression", 1) != 1:
        raise NotImplementedError("compressed TIFF")
    w, h = tags["width"], tags["height"]
    spp = tags.get("spp", 1)
    offs = tags["strip_offsets"]
    cnts = tags["strip_counts"]
    if not isinstance(offs, tuple):
        offs, cnts = (offs,), (cnts,)
    raw = b"".join(data[o:o + c] for o, c in zip(offs, cnts))
    arr = np.frombuffer(raw, np.uint8)[:h * w * spp].reshape(h, w, spp)
    return arr[..., 0] if spp == 1 else arr[..., :3]


def write_tiff(path: str, img: np.ndarray):
    """Write an uncompressed baseline TIFF (round-trip twin)."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    spp = 1 if img.ndim == 2 else img.shape[2]
    payload = img.tobytes()
    entries = [(256, 3, 1, w), (257, 3, 1, h), (259, 3, 1, 1),
               (262, 3, 1, 1 if spp == 1 else 2), (273, 4, 1, 8),
               (277, 3, 1, spp), (278, 3, 1, h),
               (279, 4, 1, len(payload))]
    if spp == 3:
        entries.insert(2, (258, 3, 3, None))       # bits/sample offsets
    ifd_off = 8 + len(payload)
    with open(path, "wb") as f:
        f.write(struct.pack("<2sHI", b"II", 42, ifd_off))
        f.write(payload)
        ents = [en for en in entries if en[3] is not None or en[0] == 258]
        extra = b""
        extra_base = ifd_off + 2 + 12 * len(ents) + 4
        out = struct.pack("<H", len(ents))
        for tag, typ, cnt, val in ents:
            if tag == 258 and cnt == 3:
                out += struct.pack("<HHII", tag, typ, cnt,
                                   extra_base + len(extra))
                extra += struct.pack("<3H", 8, 8, 8)
            else:
                out += struct.pack("<HHII", tag, typ, cnt, val)
        out += struct.pack("<I", 0)
        f.write(out + extra)
