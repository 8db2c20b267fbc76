"""fractal.residual_ms: the program's device span ``fractal.residual`` (the
residual transform, quantiser and reconstruction of each P plane), per P
frame of the window."""

from benchmark.harness import program_trace as PT

SOURCE = "program_span"
LAYER = "fractal residual"
MOVES = "fps"


def read(rec):
    return PT.span_ms(rec, ("fractal.residual",), True, per=("P",))
