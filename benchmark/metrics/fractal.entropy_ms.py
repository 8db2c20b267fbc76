"""fractal.entropy_ms: host span of every ``entropy.fractal_syntax``
``write_tree``, ``write_residual`` and ``write_intra_modes`` call in the
window, per frame."""

SOURCE = "program_span"
LAYER = "fractal host entropy"
MOVES = "fps"
_MODULE = "h264tpu_torch.entropy.fractal_syntax"
_NAMES = ("write_tree", "write_residual", "write_intra_modes")
SPANS = tuple(("host", _MODULE, n) for n in _NAMES)


def read(rec):
    got = [rec["spans"][f"{_MODULE}.{n}"] for n in _NAMES
           if f"{_MODULE}.{n}" in rec["spans"]]
    if not rec["types"] or not sum(c for _, c in got):
        return None
    return sum(ms for ms, _ in got) / len(rec["types"])
