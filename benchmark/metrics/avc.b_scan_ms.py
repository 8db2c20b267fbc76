"""avc.b_scan_ms: the program's device spans ``avc.scan.eager``,
``avc.scan.capture`` and ``avc.scan.replay`` whose parent is an
``avc.b.frame`` (the B decision scan: eager first step, graph capture and
replays), per B picture of the window."""

from benchmark.harness import program_trace as PT

SOURCE = "program_span"
LAYER = "AVC decision scan"
MOVES = "fps"
SCAN = ("avc.scan.eager", "avc.scan.capture", "avc.scan.replay")


def read(rec):
    recs = PT.window_records(rec)
    b_pictures = rec["types"].count("B")
    if recs is None or not b_pictures:
        return None
    frames = {r["id"] for r in recs
              if r["kind"] == "span" and r["name"] == "avc.b.frame"}
    ms = [r["device_ms"] for r in recs if r["kind"] == "span"
          and r["name"] in SCAN and r["parent"] in frames]
    if not ms or None in ms:
        return None
    return sum(ms) / b_pictures
