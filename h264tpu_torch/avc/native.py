"""ctypes bindings for the native AVC host stages (``csrc/avc_native.cpp``).

The two serial host stages of the conformant encoder, in C++:

* :func:`pack_slice` — CAVLC slice RBSP packing of the device symbol arrays,
  byte-identical to ``avc/pack.py`` ``pack_i_slice`` / ``pack_p_slice``
  (P8x8 sub-partitions excepted: the C packer has no ``sub_mb_type``);
* :func:`deblock_frame` — the spec 8.7 in-loop filter in MB-raster order,
  plane for plane ``avc/deblock.py`` ``deblock_frame``.

The numpy twins stay as the reference the tests hold these to.  The library
is built at first use with ``g++ -O2 -fPIC -shared -std=c++17`` into
``h264tpu_torch/_build/``, named by a hash of the source; a missing compiler
or a failed build raises with the compiler's log — nothing falls back to
numpy.  Every VLC and filter table comes from the port's Python modules
(``entropy/cavlc.py``, ``avc/tables.py``, ``ops/deblock.py``) in the layout
``load_tabs`` in the C++ reads.

Port of ``h264tpu/avc/native.py``; it imports nothing from ``h264tpu``.
"""

from __future__ import annotations

import ctypes
import hashlib

import numpy as np

from .. import kernels
from ..entropy.bitio import BitWriter
from ..entropy.cavlc import (COEFF_TOKEN_LEN, COEFF_TOKEN_CODE,
                             TOTAL_ZEROS_LEN, TOTAL_ZEROS_CODE,
                             RUN_BEFORE_LEN, RUN_BEFORE_CODE, INC_VLC)
from ..ops.deblock import ALPHA_TABLE, BETA_TABLE, CLIP_TAB
from . import tables as TBL
from .params import AVCParams, write_slice_header, SLICE_P

SOURCE = kernels.SRC_DIR / "avc_native.cpp"

_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_lib = None


def library_path():
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()
    return kernels.BUILD_DIR / f"libavc_native_{digest[:16]}.so"


def build() -> str:
    """Compile the library if it is missing; returns the compiler's log
    ("" when it was already built).  Raises when the build fails."""
    return kernels.build_host(SOURCE, library_path())


def _load():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(library_path()))
        lib.avc_pack_slice.restype = ctypes.c_int64
        lib.avc_pack_slice.argtypes = (
            [ctypes.c_int32] * 6 + [_U8P, ctypes.c_int64]
            + [_I32P] * 13 + [ctypes.c_int32]
            + [_I32P, _U8P, ctypes.c_int64])
        lib.avc_deblock_frame.restype = ctypes.c_int64
        lib.avc_deblock_frame.argtypes = (
            [_I32P] * 3 + [ctypes.c_int32] * 2
            + [_I32P, _U8P, _U8P, _I32P, _I32P, _I32P, _I32P, _I32P]
            + [ctypes.c_int32] * 3 + [_I32P] * 3)
        _lib = lib
    return _lib


def _i32(a):
    return np.ascontiguousarray(a, np.int32)


def _ptr(a):
    return a.ctypes.data_as(_I32P)


_TABLES = None


def _tables_buffer():
    """Table bundle; layout must match avc_native.cpp load_tabs."""
    global _TABLES
    if _TABLES is None:
        _TABLES = np.concatenate([_i32(t).ravel() for t in (
            COEFF_TOKEN_LEN, COEFF_TOKEN_CODE, TOTAL_ZEROS_LEN,
            TOTAL_ZEROS_CODE, RUN_BEFORE_LEN, RUN_BEFORE_CODE,
            TBL.CHROMA_DC_TOKEN_LEN, TBL.CHROMA_DC_TOKEN_CODE,
            TBL.CHROMA_DC_TZ_LEN, TBL.CHROMA_DC_TZ_CODE,
            TBL.CBP_TO_CODENUM_INTRA, TBL.CBP_TO_CODENUM_INTER, INC_VLC,
            np.asarray(TBL.BLOCK_SCAN)[:, 0], np.asarray(TBL.BLOCK_SCAN)[:, 1])])
    return _TABLES


def pack_slice(sym, p: AVCParams, slice_type: int, qp: int, frame_num: int,
               idr: bool, idr_pic_id: int, num_ref: int,
               row0: int = 0, n_rows: int = None, wp=None) -> bytes:
    """Native twin of ``pack.pack_i_slice`` / ``pack_p_slice``
    (byte-identical) for MB rows [row0, row0 + n_rows); ``wp`` is the
    explicit-WP table of a P slice's header."""
    lib = _load()
    mb_h, mb_w = p.mb_h, p.mb_w
    n_rows = mb_h - row0 if n_rows is None else n_rows
    hw = BitWriter()
    write_slice_header(hw, p, slice_type, frame_num, idr, qp,
                       idr_pic_id=idr_pic_id, first_mb=row0 * mb_w,
                       num_ref_idx_l0=num_ref if slice_type == SLICE_P else 1,
                       wp=wp)
    hdr = np.frombuffer(hw.to_bytes(), np.uint8)
    hdr_bits = hw.bit_length()
    arrs = [_i32(sym[k]) for k in
            ("win", "ri", "mvd", "i4flags", "i16mode", "i16dc", "cmode",
             "cbp_luma", "cbp_chroma", "zz", "cdc", "cac")]
    t8 = _i32(sym["t8"]) if "t8" in sym else np.zeros(mb_h * mb_w, np.int32)
    cap = 4 * 1024 * 1024 + hdr_bits // 8
    out = np.zeros(cap, np.uint8)
    n = lib.avc_pack_slice(
        slice_type, mb_w, mb_h, row0, n_rows, num_ref,
        hdr.ctypes.data_as(_U8P), hdr_bits,
        *[_ptr(a) for a in arrs], _ptr(t8),
        ctypes.c_int32(1 if p.transform_8x8 else 0),
        _ptr(_tables_buffer()), out.ctypes.data_as(_U8P), cap)
    if n <= 0:
        raise RuntimeError(f"avc_pack_slice overflowed its {cap}-byte buffer")
    return out[:n].tobytes()


def deblock_frame(rec_y, rec_u, rec_v, ctx):
    """Native twin of ``deblock.deblock_frame`` (bit-exact); returns int64
    planes like it."""
    lib = _load()
    y, u, v = (_i32(pl).copy() for pl in (rec_y, rec_u, rec_v))
    mb_intra = np.ascontiguousarray(ctx.mb_intra, np.uint8)
    t8 = np.ascontiguousarray(ctx.transform8, np.uint8)
    mb_qp, nnz, mv, ref = (_i32(a) for a in (ctx.mb_qp, ctx.nnz, ctx.mv,
                                               ctx.ref))
    two_list = ctx.ref1 is not None
    mv1 = _i32(ctx.mv1) if two_list else mv
    ref1 = _i32(ctx.ref1) if two_list else None
    tabs = [_i32(t) for t in (ALPHA_TABLE, BETA_TABLE, CLIP_TAB)]
    lib.avc_deblock_frame(
        _ptr(y), _ptr(u), _ptr(v), ctx.mb_w, ctx.mb_h,
        _ptr(mb_qp), mb_intra.ctypes.data_as(_U8P),
        t8.ctypes.data_as(_U8P), _ptr(nnz), _ptr(mv), _ptr(ref), _ptr(mv1),
        _ptr(ref1) if two_list else ctypes.cast(None, _I32P),
        ctx.chroma_qp_offset, ctx.alpha_off, ctx.beta_off, *map(_ptr, tabs))
    return y.astype(np.int64), u.astype(np.int64), v.astype(np.int64)
