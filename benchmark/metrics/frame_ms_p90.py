"""frame_ms_p90: the 90th percentile, over every frame of the window, of the
time from the encoder taking the frame from its source to its taking the
next one (for a clip's last frame, to the clip's call returning)."""

from benchmark.harness.stats import percentile

SOURCE = "host_clock"
LAYER = None
MOVES = "frame_ms_p90"


def read(rec):
    return percentile(rec["frame_ms"], 90)
