"""fractal.intra_ms: the program's device span ``fractal.intra`` (the I
step: the 4x4 intra wavefront and loop filter of the three planes), per I
frame of the window."""

from benchmark.harness import program_trace as PT

SOURCE = "program_span"
LAYER = "fractal intra"
MOVES = "fps"


def read(rec):
    return PT.span_ms(rec, ("fractal.intra",), True, per=PT.INTRA)
