"""The arithmetic that turns a run's record into numbers."""

from __future__ import annotations

import numpy as np


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of all ``values``, linear between order
    statistics (numpy's default)."""
    v = np.asarray(values, np.float64)
    if v.size == 0:
        raise ValueError("percentile of no values")
    return float(np.percentile(v, q))


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals, overlaps counted
    once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, start: float, end: float):
    """[(gap start, gap end)] of [start, end] that no interval covers."""
    gaps, cur = [], start
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, min(s, end)))
        cur = max(cur, e)
        if cur >= end:
            break
    if cur < end:
        gaps.append((cur, end))
    return [(s, e) for s, e in gaps if e > s]


def frame_times_ms(takes, returns):
    """Per-frame service times in ms of one window.

    ``takes``: per clip, the host-clock times at which the encoder took each
    of its frames from the source; ``returns``: per clip, the time its
    ``encode_sequence`` returned.  A frame's time runs from its take to the
    next take of the same clip, and the clip's last frame's to the return."""
    out = []
    for t, r in zip(takes, returns):
        ends = list(t[1:]) + [r]
        out.extend((e - s) * 1e3 for s, e in zip(t, ends))
    return out
