"""avc.capture_ms: the program's device spans ``avc.scan.eager`` and
``avc.scan.capture`` (the decision scan's eager first step and its CUDA
graph capture, during which the card waits: what a capture once per shape
removes), per frame of the window."""

from benchmark.harness import program_trace as PT

SOURCE = "program_span"
LAYER = "AVC decision scan"
MOVES = "fps"


def read(rec):
    return PT.span_ms(rec, ("avc.scan.eager", "avc.scan.capture"), True)
