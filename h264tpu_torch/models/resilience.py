"""Error-resilience toolbox: FMO slice groups, random intra refresh, HRD
leaky-bucket parameters.

The port's own copy of ``h264tpu/models/resilience.py`` (host numpy, as
there); the decoder builds its FMO maps from it.  The components:

* FMO slice-group maps — FR/src/fmo.c:233 `FmoInit` /
  `FmoGenerateMapUnitToSliceGroupMap`, implementing the seven
  slice_group_map_type algorithms of H.264 8.2.2.1-8.2.2.8 (interleaved,
  dispersed, foreground+leftover, box-out, raster wipe, wipe, explicit).
  Map generation is one-time host-side setup (the reference computes it once
  per PPS), so it runs in NumPy.
* MB scan order per group — FR/src/fmo.c:625 `FmoGetNextMBNr` (raster order
  within each slice group).
* Random intra refresh — FR/src/intrarefresh.c: a fixed pseudo-random
  permutation of all MBs walked `refresh` MBs per picture
  (`RandomIntraInit`/`RandomIntraNewPicture`/`RandomIntra`).  The reference
  seeds C `rand()` with 1; we use a seeded NumPy permutation — same
  contract (reproducible full-coverage walk), different constant pattern.
* Leaky bucket — FR/src/leaky_bucket.c `calc_buffer`: minimal buffer size B
  and initial fullness F per channel rate R from the per-frame bit trace,
  exactly the reference's two-pass algorithm.
"""

import numpy as np


# ---------------------------------------------------------------------------
# FMO slice-group maps (H.264 8.2.2; FR/src/fmo.c FmoGenerateType0..6)
# ---------------------------------------------------------------------------

def slice_group_map(map_type: int, num_groups: int, width_mbs: int,
                    height_mbs: int, *, run_lengths=None, top_left=None,
                    bottom_right=None, change_direction: int = 0,
                    change_rate: int = 1, change_cycle: int = 0,
                    explicit_map=None) -> np.ndarray:
    """[height_mbs, width_mbs] int32 map unit -> slice group id."""
    W, H = width_mbs, height_mbs
    size = W * H
    flat = np.zeros(size, np.int32)

    if map_type == 0:                       # interleaved (8.2.2.1)
        rl = list(run_lengths or [1] * num_groups)
        i = 0
        while i < size:
            for g in range(num_groups):
                take = min(rl[g], size - i)
                flat[i:i + take] = g
                i += take
                if i >= size:
                    break

    elif map_type == 1:                     # dispersed (8.2.2.2)
        idx = np.arange(size)
        flat = (((idx % W) + (((idx // W) * num_groups) // 2)) %
                num_groups).astype(np.int32)

    elif map_type == 2:                     # foreground + leftover (8.2.2.3)
        flat[:] = num_groups - 1
        m = flat.reshape(H, W)
        for g in range(num_groups - 2, -1, -1):
            y0, x0 = divmod(int(top_left[g]), W)
            y1, x1 = divmod(int(bottom_right[g]), W)
            m[y0:y1 + 1, x0:x1 + 1] = g
        flat = m.reshape(-1)

    elif map_type == 3:                     # box-out (8.2.2.4)
        n0 = min(change_cycle * change_rate, size)
        flat[:] = 1
        m = flat.reshape(H, W)
        x = (W - change_direction) // 2
        y = (H - change_direction) // 2
        xmin = xmax = x
        ymin = ymax = y
        xdir = change_direction - 1
        ydir = change_direction
        mapped_count = 0
        guard = 0
        while mapped_count < n0 and guard < 8 * size:
            guard += 1
            if 0 <= y < H and 0 <= x < W and m[y, x] == 1:
                m[y, x] = 0
                mapped_count += 1
            if xdir == -1 and x == xmin:
                xmin = max(xmin - 1, 0)
                x = xmin
                xdir = 0
                ydir = 2 * change_direction - 1
            elif xdir == 1 and x == xmax:
                xmax = min(xmax + 1, W - 1)
                x = xmax
                xdir = 0
                ydir = 1 - 2 * change_direction
            elif ydir == -1 and y == ymin:
                ymin = max(ymin - 1, 0)
                y = ymin
                xdir = 1 - 2 * change_direction
                ydir = 0
            elif ydir == 1 and y == ymax:
                ymax = min(ymax + 1, H - 1)
                y = ymax
                xdir = 2 * change_direction - 1
                ydir = 0
            else:
                x, y = x + xdir, y + ydir
        flat = m.reshape(-1)

    elif map_type == 4:                     # raster wipe (8.2.2.5)
        n0 = min(change_cycle * change_rate, size)
        sizeUL = n0 if change_direction == 0 else size - n0
        idx = np.arange(size)
        if change_direction == 0:
            flat = np.where(idx < sizeUL, 0, 1).astype(np.int32)
        else:
            flat = np.where(idx < sizeUL, 1, 0).astype(np.int32)

    elif map_type == 5:                     # wipe (column-major) (8.2.2.6)
        n0 = min(change_cycle * change_rate, size)
        order = (np.arange(size).reshape(H, W).T.reshape(-1)
                 if change_direction == 0
                 else np.arange(size).reshape(H, W).T.reshape(-1)[::-1])
        flat[:] = 1
        flat[order[:n0]] = 0

    elif map_type == 6:                     # explicit (8.2.2.7)
        flat = np.asarray(explicit_map, np.int32).reshape(-1).copy()
        assert flat.size == size

    else:
        raise ValueError(f"slice_group_map_type {map_type}")

    return flat.reshape(H, W)


def mb_scan_order(group_map: np.ndarray):
    """Per-group raster MB order (FmoGetNextMBNr semantics, fmo.c:625):
    list of int arrays, one per slice group, covering all MBs exactly once."""
    flat = np.asarray(group_map).reshape(-1)
    return [np.flatnonzero(flat == g) for g in range(int(flat.max()) + 1)]


# ---------------------------------------------------------------------------
# Random intra refresh (FR/src/intrarefresh.c)
# ---------------------------------------------------------------------------

class RandomIntraRefresh:
    """Fixed pseudo-random MB permutation walked `refresh` MBs per picture.

    Contract of RandomIntraInit/RandomIntraNewPicture/RandomIntra: every MB
    is force-intra'd exactly once per ceil(N/refresh)-picture cycle, pattern
    fixed at init (reproducible), window advances per picture.
    """

    def __init__(self, width_mbs: int, height_mbs: int, refresh: int,
                 seed: int = 1):
        self.n = width_mbs * height_mbs
        self.refresh = min(refresh, self.n)
        rng = np.random.default_rng(seed)
        self.pattern = rng.permutation(self.n)
        self.walk = 0
        self.current = np.empty(0, np.int64)

    def new_picture(self):
        """Advance the walk; returns the MB numbers forced intra this
        picture (RandomIntraNewPicture)."""
        idx = (self.walk + np.arange(self.refresh)) % self.n
        self.walk += self.refresh
        self.current = self.pattern[idx]
        return self.current

    def is_intra(self, mb: int) -> bool:
        """RandomIntra(mb) for the current picture."""
        return bool(np.isin(mb, self.current))

    def intra_mask(self, height_mbs: int, width_mbs: int) -> np.ndarray:
        """[H_mb, W_mb] bool mask of force-intra MBs for the current picture
        — the batched form the device pipeline consumes."""
        m = np.zeros(self.n, bool)
        m[self.current] = True
        return m.reshape(height_mbs, width_mbs)


# ---------------------------------------------------------------------------
# HRD leaky bucket (FR/src/leaky_bucket.c calc_buffer)
# ---------------------------------------------------------------------------

def leaky_bucket_params(frame_bits, num_buckets: int, frame_rate: float,
                        jumpd: int = 0, rates=None):
    """(R, B, F) triplets: for each channel rate R (bits/s), the minimal
    decoder buffer size B and initial fullness F (bits) such that decoding
    the given per-frame bit trace never underflows.  Exact two-pass
    algorithm of `calc_buffer` (leaky_bucket.c), including the default rate
    ladder R_0 = avg, R_k = R_{k-1} + avg/4 when no rate file is given."""
    bits = np.asarray(frame_bits, np.int64)
    nfr = len(bits)
    avg = int(bits.sum() / nfr)
    if rates is None:
        r0 = avg * frame_rate / (jumpd + 1)
        rates = [int(r0 + k * (avg // 4) * frame_rate / (jumpd + 1))
                 for k in range(num_buckets)]
    rates = sorted(int(r) for r in rates)

    max_buffer = avg * 20
    out = []
    for R in rates:
        per_frame = int(R * (jumpd + 1) / frame_rate)
        # pass 1: min fullness with a full huge buffer -> actual size
        level = max_buffer
        minB, min_idx = max_buffer, 0
        for i in range(nfr):
            level -= int(bits[i])
            if level < minB:
                minB, min_idx = level, i
            level = min(level + per_frame, max_buffer)
        B = max_buffer - minB
        # pass 2: minimal initial fullness
        F = int(bits[0])
        level = F
        for i in range(min_idx + 1):
            level -= int(bits[i])
            if level < 0:
                F -= level
                level = 0
            level += per_frame
            if level > B:
                break
        out.append((int(R), int(B), int(F)))
    return out


def verify_leaky_bucket(frame_bits, R: int, B: int, F: int,
                        frame_rate: float, jumpd: int = 0) -> bool:
    """Feasibility check: with buffer B starting at fullness F and fill rate
    R, removing each frame's bits never underflows (HRD containment)."""
    per_frame = int(R * (jumpd + 1) / frame_rate)
    level = F
    for b in np.asarray(frame_bits, np.int64):
        level -= int(b)
        if level < 0:
            return False
        level = min(level + per_frame, B)
    return True
