"""The ``pan`` traffic generator: camera pans over a smooth textured scene.

Generalised from ``chip_smoke.py``'s ``smooth_frames`` (a smoothed-noise
texture moving a fixed (2, 3) pels a frame, with noise): each clip of the
pool pans the texture by a global motion drawn for the clip, a textured
square moves against it with a motion of its own, sensor noise is added to
luma, and chroma is derived from luma plus noise.  Every number comes from
the traffic file (``traffic/<name>.json``) and the seed.

Frames are host numpy ``uint8`` (Y, U, V) 4:2:0 planes, as a YUV reader
hands them to an encoder.
"""

from __future__ import annotations

import numpy as np


def _rng(seed: int, *keys: int) -> np.random.Generator:
    """A generator for one part of one seed's traffic; any whole seed."""
    return np.random.default_rng(
        np.random.SeedSequence([seed % (1 << 64), *keys]))


def _texture(rng, h: int, w: int, passes: int, contrast: float):
    """Smoothed Gaussian noise with mean 128 and the given spread."""
    t = rng.normal(0.0, 1.0, (h, w))
    for _ in range(passes):
        t = (t + np.roll(t, 1, 0) + np.roll(t, -1, 0) + np.roll(t, 1, 1)
             + np.roll(t, -1, 1)) / 5
    return 128.0 + t / t.std() * contrast


def clip(params: dict, height: int, width: int, seed: int, index: int):
    """Clip ``index`` of seed ``seed``: a list of (Y, U, V) uint8 frames."""
    n = int(params["clip_frames"])
    m = int(params["max_motion"])
    size = int(params["square_size"])
    rng = _rng(seed, index)
    # global pan and the square's own motion, pels per frame per axis
    gx, gy, sx, sy = (int(v) for v in rng.integers(-m, m + 1, 4))
    span_y, span_x = abs(gy) * (n - 1), abs(gx) * (n - 1)
    scene = _texture(rng, height + span_y, width + span_x,
                     int(params["texture_passes"]),
                     float(params["texture_contrast"]))
    square = _texture(rng, size, size, int(params["texture_passes"]),
                      1.2 * float(params["texture_contrast"]))
    oy = span_y if gy < 0 else 0
    ox = span_x if gx < 0 else 0
    room_y, room_x = max(height - size, 0), max(width - size, 0)
    qy = int(rng.integers(0, room_y + 1))
    qx = int(rng.integers(0, room_x + 1))
    sigma = float(params["noise_sigma"])
    csig = float(params["chroma_noise_sigma"])
    frames = []
    for i in range(n):
        y = scene[oy + gy * i:oy + gy * i + height,
                  ox + gx * i:ox + gx * i + width].copy()
        py = int(np.clip(qy + sy * i, 0, room_y))
        px = int(np.clip(qx + sx * i, 0, room_x))
        y[py:py + size, px:px + size] = square[:height - py, :width - px]
        y = np.clip(y + rng.normal(0.0, sigma, y.shape), 0, 255)
        y8 = y.astype(np.uint8)
        hc, wc = height // 2, width // 2
        u = np.clip(y8[::2, ::2] * 0.5 + 60 + rng.normal(0.0, csig, (hc, wc)),
                    0, 255).astype(np.uint8)
        v = np.clip(255 - y8[1::2, 1::2] * 0.6
                    + rng.normal(0.0, csig, (hc, wc)), 0, 255).astype(np.uint8)
        frames.append((y8, u, v))
    return frames


def make_pool(params: dict, height: int, width: int, seed: int):
    """The pool of ``pool_clips`` distinct clips that a run cycles through."""
    return [clip(params, height, width, seed, i)
            for i in range(int(params["pool_clips"]))]
