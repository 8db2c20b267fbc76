"""avc_1080p.upload_ms: the program's device span ``avc.upload`` (a
picture's source planes copied to the card and padded there to the coded
size), per frame of the window."""

from benchmark.harness import program_trace as PT

SOURCE = "program_span"
LAYER = "AVC picture upload"
MOVES = "fps"


def read(rec):
    return PT.span_ms(rec, ("avc.upload",), True)
