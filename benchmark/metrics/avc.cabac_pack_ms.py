"""avc.cabac_pack_ms: the program's host span ``avc.pack`` (the Python CABAC
slice packer of every I, P and B picture), per picture of the window."""

from benchmark.harness import program_trace as PT

SOURCE = "program_span"
LAYER = "AVC host pack"
MOVES = "fps"


def read(rec):
    return PT.span_ms(rec, ("avc.pack",), False)
