"""Named spans of the port's layers, recorded by the program itself.

Tracing is off by default and process-global; :func:`enable` turns it on.
Off, :func:`span` returns one shared no-op context manager and the frame
calls return at once: a flag test is all a disabled span costs.

On, a span records its name, the id of the span it opened inside (a
thread-local stack, so GOP worker threads keep their own parents), the
``(sequence, frame)`` it belongs to, host start and end on
``time.time_ns()`` (the clock ``torch.profiler``'s timeline is aligned
with), and, where ``device`` is a CUDA device, a CUDA event pair on that
device's current stream.  Every ``encode_sequence`` call takes the next
sequence number (:func:`sequence`); :func:`frame_taken` makes its frame the
thread's current one, which a span without ``frame=`` takes from its parent
or, at the top, from the thread.  :func:`frame_taken` and :func:`frame_done`
also bound a frame record: from the encoder taking the frame to its result
and payload existing on the host.

Records stay in memory.  :func:`records` resolves the CUDA events after one
synchronise; :func:`intervals` gives the host intervals in the form
``benchmark/harness/profile.py`` names idle gaps by.  No span sits inside a
per-edge, per-step or per-macroblock loop.
"""

from __future__ import annotations

import itertools
import threading
import time

import torch

_on = False
_lock = threading.Lock()
_local = threading.local()
_spans: list = []
_frames: dict = {}          # (seq, idx) -> [taken ns, done ns, type]
_ids = itertools.count(1)
_seqs = itertools.count()


class _Noop:
    """The span a disabled tracer hands out: one object, doing nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset():
    """Drop every record and restart the span ids and sequence numbers."""
    global _ids, _seqs
    with _lock:
        _spans.clear()
        _frames.clear()
        _ids = itertools.count(1)
        _seqs = itertools.count()
    _local.__dict__.clear()


def sequence() -> int:
    """The next sequence number (one per ``encode_sequence`` call)."""
    with _lock:
        return next(_seqs)


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    __slots__ = ("name", "id", "parent", "frame", "t0", "t1", "events",
                 "stream", "device_ms")

    def __init__(self, name: str, device, frame):
        self.name = name
        self.frame = frame
        self.events = None
        self.device_ms = None
        self.stream = None
        if device is not None and torch.device(device).type == "cuda":
            self.stream = torch.cuda.current_stream(device)

    def __enter__(self):
        st = _stack()
        self.parent = st[-1].id if st else None
        if self.frame is None:
            self.frame = st[-1].frame if st else \
                getattr(_local, "frame", None)
        self.id = next(_ids)
        if self.stream is not None:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(self.stream)
        st.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        if self.events is not None:
            self.events[1].record(self.stream)
        _stack().pop()
        with _lock:
            _spans.append(self)
        return False


def span(name: str, device=None, frame=None):
    """A context manager around one layer's work.  ``device``: where it
    runs (a CUDA device adds a CUDA event pair); ``frame``: the (sequence,
    frame) pair it belongs to, by default its parent's or the thread's."""
    if not _on:
        return NOOP
    return _Span(name, device, frame)


def frame_taken(seq: int, idx: int):
    """The encoder took frame ``idx`` of sequence ``seq`` from its source."""
    if not _on:
        return
    _local.frame = (seq, idx)
    with _lock:
        _frames[(seq, idx)] = [time.time_ns(), None, None]


def frame_done(seq: int, idx: int, ftype: str):
    """Frame ``idx``'s result (type ``ftype``) and payload exist on the
    host."""
    if not _on:
        return
    if getattr(_local, "frame", None) == (seq, idx):
        _local.frame = None
    with _lock:
        rec = _frames.get((seq, idx))
        if rec is not None:
            rec[1], rec[2] = time.time_ns(), ftype


def _resolve(spans):
    """Device ms of every span with events, after one synchronise of each
    card they were recorded on."""
    todo = [s for s in spans if s.events is not None]
    for dev in {s.stream.device for s in todo}:
        torch.cuda.synchronize(dev)
    for s in todo:
        s.device_ms = s.events[0].elapsed_time(s.events[1])
        s.events = s.stream = None


def records() -> list:
    """Every closed span, in the order it closed, then every frame:
    dicts with ``kind`` ("span" or "frame"), ``name``, ``id``, ``parent``,
    ``seq``, ``frame``, ``start_ns``, ``end_ns``, ``device_ms`` (None
    without a CUDA device) and, for frames, ``type`` (None, and
    ``end_ns`` None, until the frame is done)."""
    with _lock:
        spans = list(_spans)
        frames = sorted(_frames.items())
    _resolve(spans)
    out = []
    for s in spans:
        seq, idx = s.frame if s.frame is not None else (None, None)
        out.append(dict(kind="span", name=s.name, id=s.id, parent=s.parent,
                        seq=seq, frame=idx, start_ns=s.t0, end_ns=s.t1,
                        device_ms=s.device_ms))
    for (seq, idx), (t0, t1, ftype) in frames:
        out.append(dict(kind="frame", name="frame", id=None, parent=None,
                        seq=seq, frame=idx, start_ns=t0, end_ns=t1,
                        device_ms=None, type=ftype))
    return out


def intervals() -> list:
    """[(name, start ns, end ns)] of every closed span on the host clock,
    the ``spans`` argument of ``benchmark.harness.profile.Profile
    .summary``."""
    with _lock:
        return [(s.name, s.t0, s.t1) for s in _spans]
