"""avc_1080p.host_deblock_ms: the program's host span ``avc.host_deblock``
(the native spec deblocking filter of the coded picture with its context),
per frame of the window."""

from benchmark.harness import program_trace as PT

SOURCE = "program_span"
LAYER = "AVC host deblock"
MOVES = "fps"


def read(rec):
    return PT.span_ms(rec, ("avc.host_deblock",), False)
