"""Planar YUV 4:2:0 frame I/O and PSNR (the port's own copy of
``h264tpu/utils/yuv.py``)."""

from __future__ import annotations

import numpy as np


class YUVReader:
    """Reads 8-bit planar YUV420 frames from a raw file."""

    def __init__(self, path: str, width: int, height: int):
        self.path = path
        self.width = width
        self.height = height
        self.frame_bytes = width * height * 3 // 2
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        self.num_frames = self._mm.size // self.frame_bytes

    def read(self, idx: int):
        """Return (Y [H,W], U [H/2,W/2], V [H/2,W/2]) uint8 arrays for frame idx."""
        w, h = self.width, self.height
        cw, ch = w // 2, h // 2
        base = idx * self.frame_bytes
        y = self._mm[base: base + w * h].reshape(h, w)
        u = self._mm[base + w * h: base + w * h + cw * ch].reshape(ch, cw)
        v = self._mm[base + w * h + cw * ch: base + self.frame_bytes].reshape(ch, cw)
        return np.asarray(y), np.asarray(u), np.asarray(v)

    def __len__(self):
        return self.num_frames


class YUVWriter:
    """Appends 8-bit planar YUV420 frames to a raw file."""

    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, y: np.ndarray, u: np.ndarray, v: np.ndarray):
        self._f.write(np.ascontiguousarray(y, dtype=np.uint8).tobytes())
        self._f.write(np.ascontiguousarray(u, dtype=np.uint8).tobytes())
        self._f.write(np.ascontiguousarray(v, dtype=np.uint8).tobytes())

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def pad_to_mb(plane: np.ndarray, mb: int = 16) -> np.ndarray:
    """Edge-pad a plane so both dims are multiples of ``mb``."""
    h, w = plane.shape
    ph = (-h) % mb
    pw = (-w) % mb
    if ph == 0 and pw == 0:
        return plane
    return np.pad(plane, ((0, ph), (0, pw)), mode="edge")


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR between two uint8 planes (cf. ``FR/src/code.c:514`` PSNR())."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return 99.99
    return 10.0 * np.log10(255.0 * 255.0 / mse)
