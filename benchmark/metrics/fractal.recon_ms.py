"""fractal.recon_ms: the program's device span ``fractal.recon`` (leaf maps
and the fractal reconstruction of each P plane), per P frame of the
window."""

from benchmark.harness import program_trace as PT

SOURCE = "program_span"
LAYER = "fractal recon"
MOVES = "fps"


def read(rec):
    return PT.span_ms(rec, ("fractal.recon",), True, per=("P",))
