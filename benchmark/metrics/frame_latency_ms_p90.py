"""frame_latency_ms_p90: the 90th percentile, over every frame of the
window, of the program's own host time from ``encode_sequence`` taking the
frame to its result and payload existing on the host (``trace.frame_taken``
to ``trace.frame_done``): in the fractal pipeline a frame is done only after
the next one has been dispatched."""

from benchmark.harness import program_trace as PT
from benchmark.harness.stats import percentile

SOURCE = "program_span"
LAYER = "frame pipeline"
MOVES = "frame_ms_p90"


def read(rec):
    ms = PT.frame_latency_ms(rec)
    return percentile(ms, 90) if ms else None
