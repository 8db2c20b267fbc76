"""fractal.search_ms: device span of every ``ops.fractal.search_plane``
call in the window (Y, U and V), per P frame."""

SOURCE = "program_span"
LAYER = "fractal search"
MOVES = "fps"
SPANS = (("device", "h264tpu_torch.ops.fractal", "search_plane"),)
LABEL = "h264tpu_torch.ops.fractal.search_plane"


def read(rec):
    p_frames = rec["types"].count("P")
    ms, calls = rec["spans"].get(LABEL, (0.0, 0))
    if not p_frames or not calls:
        return None
    return ms / p_frames
