"""fractal.wait_ms: the program's host span ``fractal.wait`` (the host
waiting for a frame's outputs to reach pinned memory before its entropy
coding), per frame of the window."""

from benchmark.harness import program_trace as PT

SOURCE = "program_span"
LAYER = "fractal host wait"
MOVES = "fps"


def read(rec):
    return PT.span_ms(rec, ("fractal.wait",), False)
