"""The program's own spans (``h264tpu_torch.trace``), as the per-layer
metrics read them.

The registry loads the per-layer readers only for ``--trace 1`` runs, and
before the codec is built; so importing this module switches the program's
tracer on, and untraced runs, which give the end-to-end metrics, never do.
A program without the tracer gives no records, and every reader of them
returns None.

A traced run encodes the warm clip, the window's clips and then the
profiled clip, each in one ``encode_sequence`` call and so in one trace
sequence.  :func:`window` skips the first sequence and takes the following
ones until their frames number as many as the window's and their types
equal the window's; the profiled clip, last, stays out.
"""

from __future__ import annotations

try:
    from h264tpu_torch import trace as _trace
except ImportError:
    _trace = None
else:
    _trace.enable()

INTRA = ("I", "IDR")


def records() -> list:
    """Every record of the program's tracer ([] without one)."""
    return [] if _trace is None else _trace.records()


def window(rec, recs) -> set | None:
    """The sequence numbers of the window's clips among ``recs``, or None
    where no run of sequences after the first matches ``rec["types"]``."""
    frames = {}
    for r in recs:
        if r["kind"] == "frame":
            frames.setdefault(r["seq"], []).append(r)
    want = list(rec["types"])
    got, seqs = [], set()
    for seq in sorted(frames)[1:]:
        if len(got) >= len(want):
            break
        got += [r["type"]
                for r in sorted(frames[seq], key=lambda r: r["frame"])]
        seqs.add(seq)
    return seqs if want and got == want else None


def window_records(rec) -> list | None:
    """The records of the window's sequences, or None."""
    recs = records()
    seqs = window(rec, recs)
    if seqs is None:
        return None
    return [r for r in recs if r["seq"] in seqs]


def span_ms(rec, names, device: bool, per=None) -> float | None:
    """The window's spans named in ``names``, in total ms (device ms with
    ``device``, else host), over its frames whose type is in ``per`` (None:
    every frame); None without such a span or frame, or where a span has
    no device time."""
    recs = window_records(rec)
    if recs is None:
        return None
    spans = [r for r in recs if r["kind"] == "span" and r["name"] in names]
    frames = sum(1 for t in rec["types"] if per is None or t in per)
    if not spans or not frames:
        return None
    if device:
        ms = [r["device_ms"] for r in spans]
        if None in ms:
            return None
    else:
        ms = [(r["end_ns"] - r["start_ns"]) / 1e6 for r in spans]
    return sum(ms) / frames


def frame_latency_ms(rec) -> list | None:
    """Host ms from the encoder taking each frame of the window to its
    result and payload existing on the host, or None."""
    recs = window_records(rec)
    if recs is None:
        return None
    return [(r["end_ns"] - r["start_ns"]) / 1e6 for r in recs
            if r["kind"] == "frame"]
