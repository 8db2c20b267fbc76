"""Planar YUV 4:2:0 frame input and PSNR (the port's own copy of the parts of
``h264tpu/utils/yuv.py`` it needs)."""

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


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR between two uint8 planes (cf. ``FR/src/code.c:514`` PSNR())."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return 99.99
    return 10.0 * np.log10(255.0 * 255.0 / mse)
