"""fractal.search_roofline_pct: the least time one P frame's search work
takes on the card, over the search's device span per P frame.

The work is counted from shapes, whatever implements it
(``harness/roofline.py``): the original and reference planes read once,
the leaf parameters written once, the Sigma r.d multiply-adds of every 4x4
cell at every offset and half-pel plane, and the alpha/beta fit of every
block of every shape at every candidate."""

from benchmark.harness import roofline

SOURCE = "program_span"
LAYER = "fractal search"
MOVES = "fps"
SPANS = (("device", "h264tpu_torch.ops.fractal", "search_plane"),)
LABEL = "h264tpu_torch.ops.fractal.search_plane"


def read(rec):
    p_frames = rec["types"].count("P")
    ms, calls = rec["spans"].get(LABEL, (0.0, 0))
    if not p_frames or not calls or ms <= 0:
        return None
    bound_ms, _ = roofline.fractal_search_bound_ms(rec["settings"])
    return 100.0 * bound_ms / (ms / p_frames)
