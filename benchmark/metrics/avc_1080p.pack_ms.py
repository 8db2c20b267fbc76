"""avc_1080p.pack_ms: the program's host span ``avc.pack`` (the native
CAVLC slice packer over a picture's 17 slices), per frame of the
window."""

from benchmark.harness import program_trace as PT

SOURCE = "program_span"
LAYER = "AVC host pack"
MOVES = "fps"


def read(rec):
    return PT.span_ms(rec, ("avc.pack",), False)
