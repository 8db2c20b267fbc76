"""avc.replay_ms: the program's device span ``avc.scan.replay`` (the
decision scan's graph replays with their output clones), per frame of the
window."""

from benchmark.harness import program_trace as PT

SOURCE = "program_span"
LAYER = "AVC decision scan"
MOVES = "fps"


def read(rec):
    return PT.span_ms(rec, ("avc.scan.replay",), True)
