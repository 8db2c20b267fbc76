"""launches_per_frame: kernel launches in the profiled sub-window over the
frames it holds."""

SOURCE = "device_trace"
LAYER = "device"
MOVES = "fps"


def read(rec):
    p = rec["profile"]
    if p is None or not p["frames"] or not p["launches"]:
        return None
    return p["launches"] / p["frames"]
