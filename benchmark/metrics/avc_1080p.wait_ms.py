"""avc_1080p.wait_ms: the program's host span ``avc.wait`` (the blocking
downloads of a frame's symbols, deblocking context and coded
reconstruction, which wait for its device work), per frame of the
window."""

from benchmark.harness import program_trace as PT

SOURCE = "program_span"
LAYER = "AVC host wait"
MOVES = "fps"


def read(rec):
    return PT.span_ms(rec, ("avc.wait",), False)
