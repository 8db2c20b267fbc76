"""avc.scan_hit_pct: the share of the window's decision scans that reused
a plan, 100 * (1 - ``avc.scan.capture`` spans / ``avc.scan.load`` spans).
Every scan opens one ``avc.scan.load``; a capture opens only on a plan
miss.  A program without the load span reads nothing."""

from benchmark.harness import program_trace as PT

SOURCE = "program_span"
LAYER = "AVC decision scan"
MOVES = "fps"


def read(rec):
    recs = PT.window_records(rec)
    if recs is None:
        return None
    names = [r["name"] for r in recs if r["kind"] == "span"]
    loads = names.count("avc.scan.load")
    if not loads:
        return None
    return 100.0 * (1 - names.count("avc.scan.capture") / loads)
