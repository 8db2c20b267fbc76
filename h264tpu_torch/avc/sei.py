"""SEI message syntax (spec 7.3.2.3 / D.1; J14).

The reference twins are ``FR/src/sei.c`` (1644 LoC) and
``JM/lencod/src/sei.c`` (3065 LoC).  Implemented messages: recovery_point
(D.1.8 — the random-access aid that pairs with intra refresh, F21) and
user_data_unregistered (D.1.7).  The byte-oriented ff-escape coding of
payloadType/payloadSize and payload-bit alignment follow the spec exactly,
so JM's decoder parses (and skips) our SEI NALUs cleanly.

The port's own copy of ``h264tpu/avc/sei.py``; it imports nothing from
``h264tpu``.
"""

from __future__ import annotations

import uuid

from ..entropy.bitio import BitWriter, BitReader
from ..bitstream.nal import NALU, NAL_SEI

RECOVERY_POINT = 6
USER_DATA_UNREGISTERED = 5


def _payload_header(out: bytearray, ptype: int, size: int):
    while ptype >= 255:
        out.append(255)
        ptype -= 255
    out.append(ptype)
    while size >= 255:
        out.append(255)
        size -= 255
    out.append(size)


def recovery_point_payload(recovery_frame_cnt: int, exact_match: bool = True,
                           broken_link: bool = False,
                           changing_slice_group_idc: int = 0) -> bytes:
    w = BitWriter()
    w.ue(recovery_frame_cnt)
    w.u(int(exact_match), 1)
    w.u(int(broken_link), 1)
    w.u(changing_slice_group_idc, 2)
    w.u(1, 1)                       # payload_bit_equal_to_one + zero pad
    return w.to_bytes()


def user_data_payload(data: bytes, guid: bytes = None) -> bytes:
    guid = guid or uuid.UUID("68323634-7470-7521-b055-4549757564ef").bytes
    assert len(guid) == 16
    return guid + data


def sei_rbsp(messages) -> bytes:
    """messages: list of (payload_type, payload_bytes) -> sei_rbsp bytes."""
    out = bytearray()
    for ptype, payload in messages:
        _payload_header(out, ptype, len(payload))
        out += payload
    out.append(0x80)                # rbsp_trailing_bits
    return bytes(out)


def sei_nalu(messages) -> NALU:
    return NALU(NAL_SEI, 0, sei_rbsp(messages))


def parse_sei_rbsp(rbsp: bytes):
    """-> list of (payload_type, payload_bytes)."""
    out = []
    i = 0
    # rbsp_trailing_bits is only the FINAL 0x80 byte; a 0x80 mid-stream is a
    # valid payloadType byte (e.g. payload type 128), so stop only at the end.
    while i < len(rbsp) and not (i == len(rbsp) - 1 and rbsp[i] == 0x80):
        ptype = 0
        while rbsp[i] == 255:
            ptype += 255
            i += 1
        ptype += rbsp[i]
        i += 1
        size = 0
        while rbsp[i] == 255:
            size += 255
            i += 1
        size += rbsp[i]
        i += 1
        out.append((ptype, rbsp[i:i + size]))
        i += size
    return out


def parse_recovery_point(payload: bytes) -> dict:
    r = BitReader(payload)
    return dict(recovery_frame_cnt=r.ue(), exact_match=bool(r.u(1)),
                broken_link=bool(r.u(1)),
                changing_slice_group_idc=r.u(2))


# ---------------------------------------------------------------------------
# HRD: buffering_period (D.1.2) + pic_timing (D.1.3)
# JM twin: JM/lencod/src/sei.c UpdateBufferingPeriod/UpdatePicTiming shapes
# ---------------------------------------------------------------------------

BUFFERING_PERIOD = 0
PIC_TIMING = 1


def buffering_period_payload(sps_id: int, initial_cpb_removal_delay: int,
                             initial_cpb_removal_delay_offset: int,
                             delay_bits: int = 24,
                             nal_hrd: bool = True) -> bytes:
    """buffering_period SEI (spec D.1.2): one CPB per HRD (SchedSelIdx 0).
    ``delay_bits`` = initial_cpb_removal_delay_length (VUI HRD field)."""
    w = BitWriter()
    w.ue(sps_id)
    if nal_hrd:
        w.u(initial_cpb_removal_delay, delay_bits)
        w.u(initial_cpb_removal_delay_offset, delay_bits)
    w.u(1, 1)                       # payload trailing one + alignment
    return w.to_bytes()


def parse_buffering_period(payload: bytes, delay_bits: int = 24,
                           nal_hrd: bool = True) -> dict:
    r = BitReader(payload)
    out = dict(sps_id=r.ue())
    if nal_hrd:
        out["initial_cpb_removal_delay"] = r.u(delay_bits)
        out["initial_cpb_removal_delay_offset"] = r.u(delay_bits)
    return out


def pic_timing_payload(cpb_removal_delay: int, dpb_output_delay: int,
                       cpb_removal_delay_bits: int = 24,
                       dpb_output_delay_bits: int = 24,
                       pic_struct: int = None) -> bytes:
    """pic_timing SEI (spec D.1.3) with CpbDpbDelaysPresentFlag = 1.
    ``pic_struct`` emitted only when VUI pic_struct_present_flag is set
    (None = absent; 0 = frame)."""
    w = BitWriter()
    w.u(cpb_removal_delay, cpb_removal_delay_bits)
    w.u(dpb_output_delay, dpb_output_delay_bits)
    if pic_struct is not None:
        w.u(pic_struct, 4)          # frame: no clock timestamps follow
        w.u(0, 1)                   # clock_timestamp_flag (NumClockTS=1)
    w.u(1, 1)
    return w.to_bytes()


def parse_pic_timing(payload: bytes, cpb_removal_delay_bits: int = 24,
                     dpb_output_delay_bits: int = 24,
                     pic_struct_present: bool = False) -> dict:
    r = BitReader(payload)
    out = dict(cpb_removal_delay=r.u(cpb_removal_delay_bits),
               dpb_output_delay=r.u(dpb_output_delay_bits))
    if pic_struct_present:
        out["pic_struct"] = r.u(4)
    return out


def hrd_sei_for_sequence(n_frames: int, bitrate_bps: float, cpb_bits: float,
                         fps: float, frame_bits):
    """Per-picture HRD SEI messages for a coded sequence: one
    buffering_period at the IDR + a pic_timing per picture, with delays
    from the leaky-bucket CPB model (90 kHz clock).  ``frame_bits``:
    per-frame coded sizes in bits.  Returns [(ptype, payload), ...] per
    frame (list of per-frame message lists)."""
    t90 = 90000.0
    init_delay = int(t90 * cpb_bits / max(bitrate_bps, 1.0))
    out = []
    for i in range(n_frames):
        msgs = []
        if i == 0:
            msgs.append((BUFFERING_PERIOD,
                         buffering_period_payload(0, init_delay, 0)))
        # tc = 90000 / fps ticks per frame; removal at one frame cadence
        msgs.append((PIC_TIMING,
                     pic_timing_payload(int(i * t90 / fps) if i else 0,
                                        int(t90 / fps))))
        out.append(msgs)
    return out

# ---------------------------------------------------------------------------
# tone_mapping_info (D.1.24) + frame_packing_arrangement (D.1.25)
# JM twins: JM/lencod/src/sei.c UpdateToneMapping (encoder_tonemapping.cfg
# drives it) and the frame-packing SEI writer; these close the J14
# "tone-mapping/frame-packing set" gap.
# ---------------------------------------------------------------------------

TONE_MAPPING = 23
FRAME_PACKING = 45


def tone_mapping_payload(tone_map_id: int = 0, cancel: bool = False,
                         repetition_period: int = 0,
                         coded_data_bit_depth: int = 8,
                         target_bit_depth: int = 8, model_id: int = 0,
                         min_value: int = 0, max_value: int = 255,
                         sigmoid_midpoint: int = 128, sigmoid_width: int = 64,
                         coded_intervals=None, pivots=None) -> bytes:
    """tone_mapping_info SEI (spec D.1.24), models 0..3:
    0 = linear (min/max), 1 = sigmoid (midpoint/width), 2 = user lookup
    (``coded_intervals``: start_of_coded_interval per target code, length
    (1 << target_bit_depth) + 1), 3 = piecewise linear (``pivots``: list of
    (coded_value, target_value))."""
    w = BitWriter()
    w.ue(tone_map_id)
    w.u(int(cancel), 1)
    if not cancel:
        w.ue(repetition_period)
        w.u(coded_data_bit_depth, 8)
        w.u(target_bit_depth, 8)
        w.ue(model_id)
        cbits = ((coded_data_bit_depth + 7) >> 3) << 3
        tbits = ((target_bit_depth + 7) >> 3) << 3
        if model_id == 0:
            w.u(min_value, 32)
            w.u(max_value, 32)
        elif model_id == 1:
            w.u(sigmoid_midpoint, 32)
            w.u(sigmoid_width, 32)
        elif model_id == 2:
            n = (1 << target_bit_depth) + 1
            if coded_intervals is None or len(coded_intervals) != n:
                raise ValueError(f"model 2 needs {n} coded_intervals")
            for v in coded_intervals:
                w.u(v, cbits)
        elif model_id == 3:
            w.u(len(pivots), 16)    # num_pivots
            for cv, tv in pivots:
                w.u(cv, cbits)
                w.u(tv, tbits)
        else:
            raise ValueError(f"tone map model_id {model_id}")
    w.u(1, 1)                       # payload_bit_equal_to_one + pad
    return w.to_bytes()


def parse_tone_mapping(payload: bytes) -> dict:
    r = BitReader(payload)
    out = dict(tone_map_id=r.ue(), cancel=bool(r.u(1)))
    if out["cancel"]:
        return out
    out["repetition_period"] = r.ue()
    out["coded_data_bit_depth"] = r.u(8)
    out["target_bit_depth"] = r.u(8)
    out["model_id"] = r.ue()
    cbits = ((out["coded_data_bit_depth"] + 7) >> 3) << 3
    tbits = ((out["target_bit_depth"] + 7) >> 3) << 3
    m = out["model_id"]
    if m == 0:
        out["min_value"] = r.u(32)
        out["max_value"] = r.u(32)
    elif m == 1:
        out["sigmoid_midpoint"] = r.u(32)
        out["sigmoid_width"] = r.u(32)
    elif m == 2:
        n = (1 << out["target_bit_depth"]) + 1
        out["coded_intervals"] = [r.u(cbits) for _ in range(n)]
    elif m == 3:
        n = r.u(16)
        out["pivots"] = [(r.u(cbits), r.u(tbits)) for _ in range(n)]
    else:
        raise ValueError(f"tone map model_id {m}")
    return out


def frame_packing_payload(arrangement_id: int = 0, cancel: bool = False,
                          arrangement_type: int = 3, quincunx: bool = False,
                          content_interpretation_type: int = 1,
                          spatial_flipping: bool = False,
                          frame0_flipped: bool = False,
                          field_views: bool = False,
                          current_frame_is_frame0: bool = False,
                          frame0_self_contained: bool = True,
                          frame1_self_contained: bool = True,
                          frame0_grid=(0, 0), frame1_grid=(0, 0),
                          repetition_period: int = 0) -> bytes:
    """frame_packing_arrangement SEI (spec D.1.25) — signals how a
    stereo pair is packed in each decoded frame (type 3 = side-by-side,
    4 = top-bottom, 5 = temporal interleave); the SEI companion of the
    MVC/stereo surface (avc/mvc.py, F25)."""
    w = BitWriter()
    w.ue(arrangement_id)
    w.u(int(cancel), 1)
    if not cancel:
        w.u(arrangement_type, 7)
        w.u(int(quincunx), 1)
        w.u(content_interpretation_type, 6)
        w.u(int(spatial_flipping), 1)
        w.u(int(frame0_flipped), 1)
        w.u(int(field_views), 1)
        w.u(int(current_frame_is_frame0), 1)
        w.u(int(frame0_self_contained), 1)
        w.u(int(frame1_self_contained), 1)
        if not quincunx and arrangement_type != 5:
            w.u(frame0_grid[0], 4)
            w.u(frame0_grid[1], 4)
            w.u(frame1_grid[0], 4)
            w.u(frame1_grid[1], 4)
        w.u(0, 8)                   # frame_packing_arrangement_reserved_byte
        w.ue(repetition_period)
    w.u(0, 1)                       # frame_packing_arrangement_extension_flag
    w.u(1, 1)                       # payload_bit_equal_to_one + pad
    return w.to_bytes()


def parse_frame_packing(payload: bytes) -> dict:
    r = BitReader(payload)
    out = dict(arrangement_id=r.ue(), cancel=bool(r.u(1)))
    if out["cancel"]:
        return out
    out["arrangement_type"] = r.u(7)
    out["quincunx"] = bool(r.u(1))
    out["content_interpretation_type"] = r.u(6)
    out["spatial_flipping"] = bool(r.u(1))
    out["frame0_flipped"] = bool(r.u(1))
    out["field_views"] = bool(r.u(1))
    out["current_frame_is_frame0"] = bool(r.u(1))
    out["frame0_self_contained"] = bool(r.u(1))
    out["frame1_self_contained"] = bool(r.u(1))
    if not out["quincunx"] and out["arrangement_type"] != 5:
        out["frame0_grid"] = (r.u(4), r.u(4))
        out["frame1_grid"] = (r.u(4), r.u(4))
    r.u(8)                          # reserved byte
    out["repetition_period"] = r.ue()
    return out
