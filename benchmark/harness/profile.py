"""A short profiled sub-window: device busy time, launches and the longest
idle gaps, from ``torch.profiler``'s kernel intervals on one timeline.

The profiler traces the card alone (no host operators), so that a frame of
hundreds of thousands of launches is not slowed by recording each one on
the host.  An idle gap is named by the benchmark's own layer spans that
cover it (host clock, the profiler's clock) and the CUDA runtime call in
progress, where the trace holds one."""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch

from .stats import idle_gaps, union_length

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_ACTIVITIES = ("cuda_runtime",)
NAME_CHARS = 120


class Profile:
    """Profile from :meth:`start` to :meth:`stop`; both synchronise the card
    so that the window holds exactly the device work queued inside it."""

    def __init__(self):
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.window_ns = None

    def start(self):
        torch.cuda.synchronize()
        self._prof.start()
        self._t0 = time.time_ns()

    def stop(self):
        torch.cuda.synchronize()
        t1 = time.time_ns()
        self._prof.stop()
        self.window_ns = (self._t0, t1)

    def summary(self, frames: int, spans=()) -> dict:
        """Busy and window seconds, launches per frame, top device ops and
        longest idle gaps (named by what the host was doing).  ``spans``:
        [(label, start ns, end ns)] of the layers' calls on the host."""
        t0, t1 = self.window_ns
        dev = []
        host = [("user_annotation", label, s, e) for label, s, e in spans]
        for e in self._prof.profiler.kineto_results.events():
            kind = activity(e)
            if kind in DEVICE_ACTIVITIES:
                dev.append((kind, e.name(), e.start_ns(), e.end_ns()))
            elif kind in HOST_ACTIVITIES:
                host.append((kind, e.name(), e.start_ns(), e.end_ns()))
        return summarise(dev, host, t0, t1, frames)


def activity(e) -> str:
    """The kineto activity of a profiler event: "kernel", "gpu_memcpy",
    "gpu_memset", "gpu_user_annotation", "cpu_op", "user_annotation" or
    "cuda_runtime".  Older torch builds lack ``activity_type``; there the
    kind follows from the device, the annotation flag and the name."""
    get = getattr(e, "activity_type", None)
    if get is not None:
        return get()
    name = e.name()
    on_card = str(e.device_type()).endswith("CUDA")
    annotation = getattr(e, "is_user_annotation", None)
    if annotation is not None and annotation():
        return "gpu_user_annotation" if on_card else "user_annotation"
    if on_card:
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if name.startswith(("cuda", "cu")) and not name.startswith("cudnn"):
        return "cuda_runtime"
    return "cpu_op"


def summarise(dev, host, t0: int, t1: int, frames: int) -> dict:
    """The profile's numbers from raw intervals (ns): ``dev`` and ``host``
    are [(activity, name, start, end)]."""
    spans = [(max(s, t0), min(e, t1)) for _, _, s, e in dev if e > t0 and s < t1]
    busy_ns = union_length(spans)
    by_name = defaultdict(int)
    for _, name, s, e in dev:
        by_name[name[:NAME_CHARS]] += e - s
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle_gaps(spans, t0, t1), key=lambda g: g[0] - g[1])[:10]
    if host:
        hk = np.array([k == "user_annotation" for k, _, _, _ in host])
        hs = np.array([s for _, _, s, _ in host], np.int64)
        he = np.array([e for _, _, _, e in host], np.int64)
    named = []
    for s, e in gaps:
        mid = (s + e) // 2
        label = "host outside any op"
        if host:
            cover = (hs <= mid) & (he >= mid)
            parts = []
            for want in (True, False):
                idx = np.flatnonzero(cover & (hk == want))
                if idx.size:
                    parts.append(host[idx[np.argmax(hs[idx])]][1][:NAME_CHARS])
            if parts:
                label = " / ".join(parts)
        named.append([label, (e - s) / 1e9])
    launches = sum(1 for k, _, _, _ in dev if k == "kernel")
    return dict(busy_s=busy_ns / 1e9, window_s=(t1 - t0) / 1e9,
                launches=launches, frames=frames,
                device_ops=[[n, ns / 1e9] for n, ns in top_ops],
                idle_gaps=named)
