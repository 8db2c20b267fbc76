"""Spans around the program's layer entry points, recorded from the
benchmark's side.

A traced run replaces a layer's entry function, as a module attribute that
the program looks up when it calls it, by a wrapper.  A device span is a
pair of CUDA events on the current stream around the call, so it includes
the card's idle time while the host enqueues; a host span is the host clock
around the call.  Where ``intervals`` is a list, every wrapped call also
appends (label, start, end) in ``time.time_ns`` there, so that a profile
can name what the host was doing in an idle gap.  Spans stay in memory and
are read once the window has closed.
"""

from __future__ import annotations

import importlib
import time

import torch


def span_label(module: str, attr: str) -> str:
    return f"{module}.{attr}"


class Spans:
    def __init__(self):
        self._device = {}
        self._host = {}
        self._undo = []
        self.intervals = None

    def install(self, kind: str, module: str, attr: str):
        """Wrap ``module.attr``; ``kind`` is "device" or "host"."""
        label = span_label(module, attr)
        if label in self._device or label in self._host:
            return
        mod = importlib.import_module(module)
        orig = getattr(mod, attr)

        def timed(*args, **kwargs):
            if self.intervals is None:
                return orig(*args, **kwargs)
            t0 = time.time_ns()
            out = orig(*args, **kwargs)
            self.intervals.append((label, t0, time.time_ns()))
            return out

        if kind == "device":
            calls = self._device.setdefault(label, [])

            def wrapped(*args, **kwargs):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = timed(*args, **kwargs)
                end.record()
                calls.append((start, end))
                return out
        elif kind == "host":
            calls = self._host.setdefault(label, [])

            def wrapped(*args, **kwargs):
                t0 = time.perf_counter()
                out = timed(*args, **kwargs)
                calls.append(time.perf_counter() - t0)
                return out
        else:
            raise ValueError(f"span kind {kind!r}")
        wrapped.__wrapped__ = orig
        setattr(mod, attr, wrapped)
        self._undo.append((mod, attr, orig))

    def clear(self):
        for calls in (*self._device.values(), *self._host.values()):
            calls.clear()

    def remove(self):
        for mod, attr, orig in reversed(self._undo):
            setattr(mod, attr, orig)
        self._undo.clear()

    def totals(self) -> dict:
        """{label: (total ms, calls)}; synchronises the card first."""
        if self._device:
            torch.cuda.synchronize()
        out = {k: (sum(s.elapsed_time(e) for s, e in v), len(v))
               for k, v in self._device.items()}
        out.update({k: (sum(v) * 1e3, len(v)) for k, v in self._host.items()})
        return out
