"""fps: every frame completed in the window over the window's whole time,
from the first clip's call to the last call's return after a synchronise."""

SOURCE = "host_clock"
LAYER = None
MOVES = "fps"


def read(rec):
    return len(rec["frame_ms"]) / rec["window_s"]
