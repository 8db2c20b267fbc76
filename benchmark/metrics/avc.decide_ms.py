"""avc.decide_ms: device span of every ``avc.device_enc.decide`` call in the
window (the decision scan: eager first step, graph capture and replays), per
frame."""

SOURCE = "program_span"
LAYER = "AVC decision scan"
MOVES = "fps"
SPANS = (("device", "h264tpu_torch.avc.device_enc", "decide"),)
LABEL = "h264tpu_torch.avc.device_enc.decide"


def read(rec):
    ms, calls = rec["spans"].get(LABEL, (0.0, 0))
    if not rec["types"] or not calls:
        return None
    return ms / len(rec["types"])
