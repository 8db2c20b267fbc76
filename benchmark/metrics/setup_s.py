"""setup_s: process start to the first frame of the window: interpreter and
imports, clip pool, library builds or loads, codec construction and the
warm clip."""

SOURCE = "host_clock"
LAYER = None
MOVES = "setup_s"


def read(rec):
    return rec["setup_s"]
