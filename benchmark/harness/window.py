"""The measured window: clips fed back to back through the encoder's own
sequence entry, one closed-loop client."""

from __future__ import annotations

import time


def feed(frames, takes: list, deadline: float, on_take=None):
    """Yield ``frames`` while the window is open, recording the host-clock
    time at which the encoder takes each one; ``on_take(i)`` runs just
    before frame ``i`` is handed over."""
    for i, f in enumerate(frames):
        now = time.perf_counter()
        if now >= deadline:
            return
        if on_take is not None:
            on_take(i)
            now = time.perf_counter()
        takes.append(now)
        yield f


def run_window(system, codec, pool, seconds: float, sync):
    """Encode clips of ``pool`` in turn, each with its own ``encode`` call
    on a fresh iterator, until ``seconds`` have passed; the call that holds
    the deadline finishes what it took.  Returns the window's record."""
    takes, returns, clips, sources = [], [], [], []
    t_start = time.perf_counter()
    deadline = t_start + seconds
    i = 0
    while time.perf_counter() < deadline:
        frames = pool[i % len(pool)]
        t = []
        results, stream = system.encode(codec, feed(frames, t, deadline))
        r = time.perf_counter()
        if t:
            if len(results) != len(t):
                raise RuntimeError(f"the encoder returned {len(results)} "
                                   f"frames of the {len(t)} it took")
            takes.append(t)
            returns.append(r)
            clips.append(system.output(results, stream))
            sources.append(frames[:len(t)])
        i += 1
    sync()
    t_end = time.perf_counter()
    return dict(t_start=t_start, t_end=t_end, takes=takes, returns=returns,
                clips=clips, sources=sources)


def sample_frames(clips, n_frames: int, rng):
    """(clip, frame) pairs that the check reads: the first clip's first
    frame, where every chain starts, then ``n_frames - 1`` later frames
    drawn from the whole window."""
    later = [(c, k) for c, clip in enumerate(clips)
             for k in range(1, len(clip["types"]))]
    take = min(n_frames - 1, len(later))
    idx = rng.choice(len(later), size=take, replace=False) if take else []
    return [(0, 0)] + sorted(later[i] for i in idx)
