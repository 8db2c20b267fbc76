"""avc.b_wait_ms: the program's host span ``avc.b.wait`` (the blocking
downloads of a B picture's symbols, deblocking context and reconstruction,
which wait for its device work), per B picture of the window."""

from benchmark.harness import program_trace as PT

SOURCE = "program_span"
LAYER = "AVC host wait"
MOVES = "fps"


def read(rec):
    return PT.span_ms(rec, ("avc.b.wait",), False, per=("B",))
