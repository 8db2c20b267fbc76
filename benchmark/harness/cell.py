"""One run of one cell: set-up, the measured window, the traced readings,
the check of what the window produced, and the result line."""

from __future__ import annotations

import gc
import json
import os
import resource
import sys
import time

import numpy as np
import torch

from . import guard
from .profile import Profile
from .registry import Registry
from .spans import Spans
from .stats import frame_times_ms
from .window import feed, run_window


def seconds_since_process_start() -> float:
    """Host seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def _sync_for(device: torch.device):
    if device.type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             device="cuda", chips: int = 1, registry: Registry = None,
             log=sys.stderr, controls: bool = False) -> dict:
    """Run cell ``name`` once; returns the result dict (``correct``,
    ``metrics``, ... and ``checks`` last).  ``controls`` also reads the
    cell's control on the same sample (``control_checks``); the
    benchmark's own runs never do."""
    reg = registry or Registry()
    device = torch.device(device)
    sync = _sync_for(device)
    cell = reg.cell(name)
    config = reg.config(cell["config"])
    traffic = reg.traffic(cell["traffic"])
    system = reg.system(config["system"])
    settings = config["settings"]
    metrics = reg.cell_metrics(name, traced)

    # -- set-up: traffic, codec, warm-up of this cell's shapes --------------
    pool = reg.generator(traffic["generator"]).make_pool(
        traffic, settings["height"], settings["width"], seed)
    codec = system.build(settings, device)
    system.encode(codec, iter(pool[0][:int(cell["warm_frames"])]))
    sync()
    spans = Spans()
    if traced:
        for _, _, reader in metrics:
            for kind, module, attr in getattr(reader, "SPANS", ()):
                spans.install(kind, module, attr)
    system.reset_counters(codec)
    setup_s = seconds_since_process_start()

    # -- the window -----------------------------------------------------------
    host = HostProbe()
    win = run_window(system, codec, pool, seconds, sync)
    host.stop(log)
    times = frame_times_ms(win["takes"], win["returns"])
    types = [t for clip in win["clips"] for t in clip["types"]]
    rec = dict(cell=cell, settings=settings, setup_s=setup_s,
               window_s=win["t_end"] - win["t_start"], frame_ms=times,
               types=types, counters=system.counters(codec), spans={},
               profile=None)
    print(f"[bench] {name} seed {seed}: {len(times)} frames in "
          f"{len(win['clips'])} clips, window {rec['window_s']:.3f} s, "
          f"set-up {setup_s:.3f} s", file=log, flush=True)
    _log_content(win, log)
    if traced:
        rec["spans"] = spans.totals()
        spans.clear()
        rec["profile"] = _profiled_frames(system, codec, pool, cell, spans)
        spans.remove()
        p = rec["profile"]
        print(f"[bench] profiled sub-window: {p['frames']} frames, "
              f"{1e3 * p['window_s'] / p['frames']:.3f} ms a frame "
              f"(window median {np.median(times):.3f} ms a frame)",
              file=log, flush=True)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    del codec
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # -- metrics ----------------------------------------------------------------
    values = {}
    for mname, entry, reader in metrics:
        v = reader.read(rec)
        if v is not None:
            values[mname] = {"value": float(v), "unit": entry["unit"]}

    # -- the check of what the window produced ----------------------------------
    checks, correct = check_window(system, settings, cell, win, seed, log)

    result = dict(correct=correct, attempted=sum(len(t) for t in win["takes"]),
                  failed=0, metrics=values,
                  device=_device_info(device, chips, memory_peak, rec))
    if traced and rec["profile"] is not None:
        p = rec["profile"]
        result["breakdown"] = dict(device_ops=p["device_ops"],
                                   idle_gaps=p["idle_gaps"])
    if controls:
        result["control_checks"], result["control_correct"] = check_window(
            system, settings, cell, win, seed, log, control=True)
    result["checks"] = checks
    return result


def check_window(system, settings, cell, win, seed: int, log, control=False):
    """({name: {"value", "limit"}}, correct) of the cell's check; a check
    that raises is not correct."""
    spec = cell["check"]
    rng = np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), 1]))
    t0 = time.perf_counter()
    try:
        readings = system.check(settings, spec, win["clips"], win["sources"],
                                rng, control=control)
        error = None
    except Exception as exc:  # a stream the reference cannot read is wrong
        readings, error = {}, f"{type(exc).__name__}: {exc}"
    checks, correct = {}, error is None
    for key, limit in spec["limits"].items():
        v = readings.get(key)
        ok = v is not None and v <= limit
        correct &= ok
        checks[key] = {"value": v if v is None else float(v), "limit": limit}
    what = "control" if control else "check"
    print(f"[bench] {what} took {time.perf_counter() - t0:.3f} s", file=log)
    if error:
        print(f"[bench] {what} failed: {error}", file=log)
    for key, c in checks.items():
        print(f"{what} {key} = {c['value']} (limit {c['limit']})", file=log)
    log.flush()
    return checks, correct


class HostProbe:
    """What the host did to the window, for finding the cause of a slow
    run: a fixed Python loop timed before and after, the process's seconds
    on a core and its involuntary context switches (``getrusage``), and the
    garbage collector's passes and seconds."""

    def __init__(self):
        self.gc_s, self.gc_passes, self._gc_t = 0.0, [0, 0, 0], None
        gc.callbacks.append(self._on_gc)
        self.cal0 = self.calibrate()
        self.use0, self.t0 = resource.getrusage(resource.RUSAGE_SELF), \
            time.perf_counter()

    @staticmethod
    def calibrate() -> float:
        t0 = time.perf_counter()
        sum(i * i for i in range(200_000))
        return (time.perf_counter() - t0) * 1e3

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t = time.perf_counter()
        elif self._gc_t is not None:
            self.gc_s += time.perf_counter() - self._gc_t
            self.gc_passes[info["generation"]] += 1
            self._gc_t = None

    def stop(self, log):
        use1, wall = resource.getrusage(resource.RUSAGE_SELF), \
            time.perf_counter() - self.t0
        gc.callbacks.remove(self._on_gc)
        cpu = (use1.ru_utime + use1.ru_stime
               - self.use0.ru_utime - self.use0.ru_stime)
        print(f"[bench] host: loop {self.cal0:.2f} / {self.calibrate():.2f} "
              f"ms before / after, {cpu:.3f} s on a core in {wall:.3f} s, "
              f"{use1.ru_nivcsw - self.use0.ru_nivcsw} involuntary switches, "
              f"gc {self.gc_s:.3f} s in {self.gc_passes} passes",
              file=log, flush=True)


def _log_content(win, log):
    """What the window's clips cost and how close they came: mean bits of
    the I and the P frames and the mean luma PSNR, beside the source's
    statistics in ``PERF.md``."""
    bits = {"I": [], "P": []}
    psnr = []
    for clip, frames in zip(win["clips"], win["sources"]):
        for t, b, rec, src in zip(clip["types"], clip["bits"], clip["recon"],
                                  frames):
            bits["I" if t in ("I", "IDR") else "P"].append(b)
            err = np.asarray(rec[0], np.float64) - src[0]
            mse = max(float(np.mean(err * err)), 1e-10)
            psnr.append(10.0 * np.log10(255.0 ** 2 / mse))
    print(f"[bench] content: I {np.mean(bits['I'] or [0]):.0f} bits, "
          f"P {np.mean(bits['P'] or [0]):.0f} bits a frame, "
          f"PSNR-Y {np.mean(psnr):.3f} dB over {len(psnr)} frames",
          file=log, flush=True)


def _profiled_frames(system, codec, pool, cell, spans):
    """Profile ``profile_frames`` steady frames after the window: a clip's
    first two frames, then the profiler from the take of its third frame to
    the return; the layer spans' host intervals name the idle gaps."""
    n = int(cell["profile_frames"])
    prof = Profile()

    def on_take(i):
        if i == 2:
            spans.intervals = []
            prof.start()

    system.encode(codec, feed(pool[0][:2 + n], [], float("inf"), on_take))
    prof.stop()
    intervals, spans.intervals = spans.intervals, None
    return prof.summary(n, intervals)


def _device_info(device, chips, memory_peak, rec) -> dict:
    info = dict(platform="gpu" if device.type == "cuda" else device.type,
                kind=(torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
                count=chips, memory_peak_bytes=int(memory_peak))
    if rec["profile"] is not None:
        info["busy_s"] = rec["profile"]["busy_s"]
        info["window_s"] = rec["profile"]["window_s"]
    return info


def emit(result: dict, out=sys.stdout):
    print(json.dumps(result), file=out, flush=True)


def guarded_exit_code(log=sys.stderr) -> int:
    found = guard.forbidden_loaded()
    if found:
        print("[bench] forbidden modules loaded: " + ", ".join(found),
              file=log, flush=True)
        return 3
    return 0
