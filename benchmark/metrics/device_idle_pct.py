"""device_idle_pct: the share of the window's wall time in which no kernel,
copy or fill runs on the card: one minus the device's busy time per frame in
the profiled sub-window (the union of the operations' intervals on the
profiler's timeline) over the window's time per frame.

The busy time is the card's own, which tracing each launch does not
lengthen; the profiled frames themselves last about twice as long as the
window's (a CUPTI record per launch), so their own idle share would read
the profiler's cost (the run prints both lengths)."""

SOURCE = "device_trace"
LAYER = "device"
MOVES = "fps"


def read(rec):
    p = rec["profile"]
    if p is None or p["busy_s"] <= 0 or not p["frames"] or not rec["frame_ms"]:
        return None
    frame_s = rec["window_s"] / len(rec["frame_ms"])
    return 100.0 * (1.0 - p["busy_s"] / p["frames"] / frame_s)
