"""avc_1080p.search_ms: the program's device span ``avc.search`` (Stage A
integer search and Stage B sub-pel refinement), per P frame of the
window."""

from benchmark.harness import program_trace as PT

SOURCE = "program_span"
LAYER = "AVC motion search"
MOVES = "fps"


def read(rec):
    return PT.span_ms(rec, ("avc.search",), True, per=("P",))
