"""avc.pack_ms: the codec's own host clock of its slice packer
(``DeviceAVCCodec.host_ms["pack"]``), mean per frame of the window."""

SOURCE = "program_counter"
LAYER = "AVC host pack"
MOVES = "fps"


def read(rec):
    ms = rec["counters"].get("host_ms.pack")
    if not ms:
        return None
    return sum(ms) / len(ms)
