"""fractal.deblock_ms: device span of every ``ops.deblock.
deblock_plane_grouped`` call in the window (the loop filter of I and P
planes), per frame."""

SOURCE = "program_span"
LAYER = "fractal loop filter"
MOVES = "fps"
SPANS = (("device", "h264tpu_torch.ops.deblock", "deblock_plane_grouped"),)
LABEL = "h264tpu_torch.ops.deblock.deblock_plane_grouped"


def read(rec):
    ms, calls = rec["spans"].get(LABEL, (0.0, 0))
    if not rec["types"] or not calls:
        return None
    return ms / len(rec["types"])
