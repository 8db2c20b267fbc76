"""avc.search_ms: device span of every ``avc.device_enc.search`` call in the
window (Stage A integer search and Stage B sub-pel refinement), per P
frame."""

SOURCE = "program_span"
LAYER = "AVC motion search"
MOVES = "fps"
SPANS = (("device", "h264tpu_torch.avc.device_enc", "search"),)
LABEL = "h264tpu_torch.avc.device_enc.search"


def read(rec):
    p_frames = rec["types"].count("P")
    ms, calls = rec["spans"].get(LABEL, (0.0, 0))
    if not p_frames or not calls:
        return None
    return ms / p_frames
