"""avc.b_frame_ms: the program's device span ``avc.b.frame`` (a B picture's
device encode: upload, both lists' Stages A and B and the B decision scan),
per B picture of the window."""

from benchmark.harness import program_trace as PT

SOURCE = "program_span"
LAYER = "AVC B picture encode"
MOVES = "fps"


def read(rec):
    return PT.span_ms(rec, ("avc.b.frame",), True, per=("B",))
