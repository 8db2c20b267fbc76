"""ctypes bindings for the fractal codec's native host bit machinery
(``csrc/fvc_native.cpp``).

The C++ twins of the pure-Python coders: CAVLC and CABAC residual coding of
a plane of 4x4 level blocks (``entropy/cavlc.py`` ``encode_plane`` /
``decode_plane``, ``entropy/cabac_eng.py`` ``encode_plane`` /
``decode_plane``), MPM intra-mode resolution (``fractal_syntax``'s
``read_intra_modes`` loop) and Annex-B emulation prevention (``bitstream/
nal.py``).  The Python versions stay as the reference the tests hold these
to.  The library is built at first use with ``g++`` into
``h264tpu_torch/_build/``, named by a hash of the source
(``kernels.build_host``); a missing compiler or a failed build raises with
the compiler's log — nothing falls back to Python.  Every table comes from
the port's own ``entropy/cavlc.py`` and ``entropy/cabac_eng.py``.

Port of ``h264tpu/entropy/native.py``; it imports nothing from ``h264tpu``.
"""

from __future__ import annotations

import ctypes
import hashlib

import numpy as np

from .. import kernels
from . import cabac_eng, cavlc

SOURCE = kernels.SRC_DIR / "fvc_native.cpp"

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_I64, _INT = ctypes.c_int64, ctypes.c_int
# restype and argtypes of each exported function
_SIGNATURES = {
    "cavlc_decode_plane": (_I64, [ctypes.c_char_p, _I64, _I64, _INT, _INT,
                                  _U8P, _I32P, _U8P, _I32P, _U8P, _I32P,
                                  _I32P, _I32P]),
    "cavlc_encode_plane": (_I64, [_I32P, _INT, _INT, _U8P, _I32P, _U8P, _I32P,
                                  _U8P, _I32P, _I64P, _I64P, _I32P]),
    "cabac_encode_plane": (_I64, [_I32P, _INT, _INT, _U8P, _U8P, _U8P, _U8P,
                                  _I64, _U8P]),
    "cabac_decode_plane": (_I64, [ctypes.c_char_p, _I64, _INT, _INT, _U8P,
                                  _U8P, _U8P, _I32P, _U8P]),
    "resolve_intra_modes": (None, [_U8P, _U8P, _INT, _INT, _I32P]),
    "ep_insert": (_I64, [ctypes.c_char_p, _I64, _U8P]),
    "ep_strip": (_I64, [ctypes.c_char_p, _I64, _U8P]),
}
_lib = None


def library_path():
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()
    return kernels.BUILD_DIR / f"libfvc_native_{digest[:16]}.so"


def build() -> str:
    """Compile the library if it is missing; returns the compiler's log
    ("" when it was already built).  Raises when the build fails."""
    return kernels.build_host(SOURCE, library_path())


def _load():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(library_path()))
        for name, (res, args) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _lib = lib
    return _lib


def _u8(a):
    return a.ctypes.data_as(_U8P)


def _i32(a):
    return a.ctypes.data_as(_I32P)


def _tables(dtypes, arrays):
    return tuple(np.ascontiguousarray(a, d) for a, d in zip(arrays, dtypes))


_VLC = _tables((np.uint8, np.int32) * 3, (
    cavlc.COEFF_TOKEN_LEN, cavlc.COEFF_TOKEN_CODE, cavlc.TOTAL_ZEROS_LEN,
    cavlc.TOTAL_ZEROS_CODE, cavlc.RUN_BEFORE_LEN, cavlc.RUN_BEFORE_CODE))
_CABAC = _tables((np.uint8,) * 3, (cabac_eng.RLPS_64x4, cabac_eng.NEXT_MPS,
                                   cabac_eng.NEXT_LPS))


def _vlc_args():
    tl, tc, zl, zc, rl, rc = _VLC
    return [_u8(tl), _i32(tc), _u8(zl), _i32(zc), _u8(rl), _i32(rc)]


def _cabac_args():
    return [_u8(t) for t in _CABAC]


def cavlc_encode_plane(zz: np.ndarray, cy: int, cx: int):
    """Codes and lengths (int64 [cy*cx*36] each, zero-length slots
    included: the caller masks them) of a plane's CAVLC blocks, in the
    order ``cavlc.encode_plane`` writes them."""
    lib = _load()
    zz32 = np.ascontiguousarray(zz, np.int32)
    n = cy * cx
    codes = np.zeros(n * 36, np.int64)
    lens = np.zeros(n * 36, np.int64)
    scratch = np.zeros(n, np.int32)
    lib.cavlc_encode_plane(_i32(zz32), cy, cx, *_vlc_args(),
                           codes.ctypes.data_as(_I64P),
                           lens.ctypes.data_as(_I64P), _i32(scratch))
    return codes, lens


def cavlc_decode_plane(data: bytes, nbits: int, bitpos: int, cy: int, cx: int):
    """(zz [cy*cx, 16] int64, new bit position) of the CAVLC blocks at
    ``bitpos`` of ``data``; raises on a corrupt stream."""
    lib = _load()
    zz = np.zeros((cy * cx, 16), np.int32)
    scratch = np.zeros(cy * cx, np.int32)
    newpos = lib.cavlc_decode_plane(data, nbits, bitpos, cy, cx, *_vlc_args(),
                                    _i32(zz), _i32(scratch))
    if newpos < 0:
        raise ValueError("native CAVLC decode error")
    return zz.astype(np.int64), int(newpos)


def cabac_encode_plane(zz: np.ndarray, cy: int, cx: int) -> bytes:
    """The M-coder bytes of a plane, equal to ``cabac_eng.encode_plane``."""
    lib = _load()
    zz32 = np.ascontiguousarray(np.asarray(zz).reshape(-1), np.int32)
    cap = max(4096, zz32.size * 8)
    out = np.zeros(cap, np.uint8)
    scratch = np.zeros(cy * cx, np.uint8)
    n = lib.cabac_encode_plane(_i32(zz32), cy, cx, *_cabac_args(), _u8(out),
                               cap, _u8(scratch))
    if n < 0:
        raise ValueError("native CABAC encode overflow")
    return out[:n].tobytes()


def cabac_decode_plane(data: bytes, cy: int, cx: int) -> np.ndarray:
    """zz [cy*cx, 16] int64 of a plane's M-coder bytes."""
    lib = _load()
    zz = np.zeros(cy * cx * 16, np.int32)
    scratch = np.zeros(cy * cx, np.uint8)
    rc = lib.cabac_decode_plane(data, len(data), cy, cx, *_cabac_args(),
                                _i32(zz), _u8(scratch))
    if rc < 0:
        raise ValueError("native CABAC decode error")
    return zz.reshape(cy * cx, 16).astype(np.int64)


def resolve_intra_modes(flags: np.ndarray, rem: np.ndarray, cy: int, cx: int):
    """Intra modes [cy, cx] int64 from the MPM flags and the remaining
    modes, which are consumed in raster order."""
    lib = _load()
    modes = np.zeros(cy * cx, np.int32)
    flags8 = np.ascontiguousarray(np.asarray(flags).reshape(-1), np.uint8)
    rem8 = np.ascontiguousarray(rem, np.uint8)
    lib.resolve_intra_modes(_u8(flags8), _u8(rem8), cy, cx, _i32(modes))
    return modes.reshape(cy, cx).astype(np.int64)


def ep_insert(rbsp: bytes) -> bytes:
    """RBSP -> EBSP: an emulation-prevention 0x03 after every 00 00 that
    precedes a byte <= 0x03."""
    out = np.zeros(len(rbsp) + len(rbsp) // 2 + 16, np.uint8)
    n = _load().ep_insert(rbsp, len(rbsp), _u8(out))
    return out[:n].tobytes()


def ep_strip(ebsp: bytes) -> bytes:
    """EBSP -> RBSP: drops each 0x03 that follows 00 00."""
    out = np.zeros(len(ebsp) + 1, np.uint8)
    n = _load().ep_strip(ebsp, len(ebsp), _u8(out))
    return out[:n].tobytes()
