"""The PyTorch port's SEI messages (``h264tpu_torch.avc.sei``) and explicit
coding-order sequences (``h264tpu_torch.avc.explicit_seq``) against the JAX
package's, on the CPU: equal payload and NAL bytes, parsers that read back
what the payload writers wrote, and byte-identical explicit-sequence streams."""

import dataclasses

import numpy as np
import pytest

from h264tpu.avc import explicit_seq as JE
from h264tpu.avc import sei as JSEI
from h264tpu.avc.params import AVCParams as JParams
from h264tpu.avc.slice_dec import AVCDecoder as JDecoder
from h264tpu.bitstream.nal import nalu_to_bytes as j_nalu_to_bytes
from h264tpu_torch.avc import explicit_seq as TE
from h264tpu_torch.avc import sei as TSEI
from h264tpu_torch.avc.params import params_from_dict
from h264tpu_torch.avc.slice_dec import AVCDecoder as TDecoder
from h264tpu_torch.bitstream.nal import nalu_to_bytes as t_nalu_to_bytes

# name: (payload writer, its arguments, parser, the parser's arguments,
# the fields the parse must give back)
PAYLOADS = {
    "recovery_point": (
        "recovery_point_payload", dict(recovery_frame_cnt=5,
                                       exact_match=False, broken_link=True,
                                       changing_slice_group_idc=2),
        "parse_recovery_point", {},
        dict(recovery_frame_cnt=5, exact_match=False, broken_link=True,
             changing_slice_group_idc=2)),
    "buffering_period": (
        "buffering_period_payload", dict(sps_id=1,
                                         initial_cpb_removal_delay=90000,
                                         initial_cpb_removal_delay_offset=7),
        "parse_buffering_period", {},
        dict(sps_id=1, initial_cpb_removal_delay=90000,
             initial_cpb_removal_delay_offset=7)),
    "buffering_period_no_hrd": (
        "buffering_period_payload", dict(sps_id=3,
                                         initial_cpb_removal_delay=1,
                                         initial_cpb_removal_delay_offset=2,
                                         nal_hrd=False),
        "parse_buffering_period", dict(nal_hrd=False), dict(sps_id=3)),
    "pic_timing": (
        "pic_timing_payload", dict(cpb_removal_delay=6000,
                                   dpb_output_delay=3000),
        "parse_pic_timing", {},
        dict(cpb_removal_delay=6000, dpb_output_delay=3000)),
    "pic_timing_struct": (
        "pic_timing_payload", dict(cpb_removal_delay=12,
                                   dpb_output_delay=4,
                                   cpb_removal_delay_bits=16,
                                   dpb_output_delay_bits=8, pic_struct=0),
        "parse_pic_timing", dict(cpb_removal_delay_bits=16,
                                 dpb_output_delay_bits=8,
                                 pic_struct_present=True),
        dict(cpb_removal_delay=12, dpb_output_delay=4, pic_struct=0)),
    "tone_mapping_linear": (
        "tone_mapping_payload", dict(tone_map_id=2, coded_data_bit_depth=10,
                                     min_value=64, max_value=940),
        "parse_tone_mapping", {},
        dict(tone_map_id=2, cancel=False, coded_data_bit_depth=10,
             target_bit_depth=8, model_id=0, min_value=64, max_value=940)),
    "tone_mapping_sigmoid": (
        "tone_mapping_payload", dict(model_id=1, sigmoid_midpoint=100,
                                     sigmoid_width=30,
                                     repetition_period=4),
        "parse_tone_mapping", {},
        dict(model_id=1, sigmoid_midpoint=100, sigmoid_width=30,
             repetition_period=4)),
    "tone_mapping_lookup": (
        "tone_mapping_payload", dict(model_id=2, target_bit_depth=4,
                                     coded_intervals=list(range(0, 256, 16))
                                     + [255]),
        "parse_tone_mapping", {},
        dict(model_id=2, target_bit_depth=4,
             coded_intervals=list(range(0, 256, 16)) + [255])),
    "tone_mapping_pivots": (
        "tone_mapping_payload", dict(model_id=3, coded_data_bit_depth=12,
                                     pivots=[(0, 0), (2048, 200),
                                             (4095, 255)]),
        "parse_tone_mapping", {},
        dict(model_id=3, pivots=[(0, 0), (2048, 200), (4095, 255)])),
    "tone_mapping_cancel": (
        "tone_mapping_payload", dict(tone_map_id=9, cancel=True),
        "parse_tone_mapping", {}, dict(tone_map_id=9, cancel=True)),
    "frame_packing_side_by_side": (
        "frame_packing_payload", dict(arrangement_id=1, frame0_flipped=True,
                                      repetition_period=1),
        "parse_frame_packing", {},
        dict(arrangement_id=1, cancel=False, arrangement_type=3)),
    "frame_packing_quincunx": (
        "frame_packing_payload", dict(arrangement_type=0, quincunx=True),
        "parse_frame_packing", {}, dict(arrangement_type=0, quincunx=True)),
    "frame_packing_grid": (
        "frame_packing_payload", dict(arrangement_type=4,
                                      frame0_grid=(3, 5),
                                      frame1_grid=(7, 9)),
        "parse_frame_packing", {}, dict(arrangement_type=4)),
    "frame_packing_cancel": (
        "frame_packing_payload", dict(arrangement_id=4, cancel=True),
        "parse_frame_packing", {}, dict(arrangement_id=4, cancel=True)),
}


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_sei_payload_equals_jax_and_round_trips(name):
    build, kw, parse, pkw, want = PAYLOADS[name]
    got = getattr(TSEI, build)(**kw)
    assert got == getattr(JSEI, build)(**kw)
    parsed = getattr(TSEI, parse)(got, **pkw)
    assert parsed == getattr(JSEI, parse)(got, **pkw)
    for key, val in want.items():
        assert parsed[key] == val, key


def test_sei_rbsp_nalu_and_parse_equal_jax():
    """Several messages in one SEI, with a payload type and a size past the
    255 escape and a payload byte of 0x80."""
    msgs = [(TSEI.RECOVERY_POINT, TSEI.recovery_point_payload(0)),
            (TSEI.USER_DATA_UNREGISTERED,
             TSEI.user_data_payload(bytes(range(256)) * 2)),
            (300, b"\x80\x01\x02"),
            (TSEI.USER_DATA_UNREGISTERED,
             TSEI.user_data_payload(b"x", guid=bytes(range(16))))]
    rbsp = TSEI.sei_rbsp(msgs)
    assert rbsp == JSEI.sei_rbsp(msgs)
    assert TSEI.parse_sei_rbsp(rbsp) == JSEI.parse_sei_rbsp(rbsp) == msgs
    assert t_nalu_to_bytes(TSEI.sei_nalu(msgs)) == \
        j_nalu_to_bytes(JSEI.sei_nalu(msgs))


def test_hrd_sei_for_sequence_equals_jax():
    bits = [41000, 9000, 11500, 8000, 12345]
    kw = dict(n_frames=5, bitrate_bps=1.5e6, cpb_bits=3e6, fps=29.97,
              frame_bits=bits)
    got = TSEI.hrd_sei_for_sequence(**kw)
    assert got == JSEI.hrd_sei_for_sequence(**kw)
    assert [len(m) for m in got] == [2, 1, 1, 1, 1]
    assert TSEI.parse_buffering_period(got[0][0][1])[
        "initial_cpb_removal_delay"] == 180000


# JM explicit_seq.cfg layout: a sequence block of frames in coding order
EXPLICIT_SEQ = """\
Sequence {
FrameCount : 5
Frame
{
SeqNumber : 0
SliceType : I
IDRPicture : 1
Reference : 1
}
Frame
{
SeqNumber : 2
SliceType : P
IDRPicture : 0
Reference : 1
}
Frame
{
SeqNumber : 1
SliceType : B
IDRPicture : 0
Reference : 0
}
Frame
{
SeqNumber : 4
SliceType : I
IDRPicture : 0
Reference : 1
}
Frame
{
SeqNumber : 3
SliceType : B
IDRPicture : 0
Reference : 0
}
Frame
{
SeqNumber : 5
SliceType : P
IDRPicture : 0
Reference : 1
}
}
"""


def test_parse_explicit_seq_equals_jax(tmp_path):
    got = TE.parse_explicit_seq(EXPLICIT_SEQ)
    assert got == JE.parse_explicit_seq(EXPLICIT_SEQ)
    assert [e["seq_number"] for e in got] == [0, 2, 1, 4, 3]  # FrameCount
    path = tmp_path / "explicit_seq.cfg"
    path.write_text(EXPLICIT_SEQ)
    assert TE.parse_explicit_seq_file(str(path)) == got
    for mod in (TE, JE):
        with pytest.raises(ValueError):
            mod.parse_explicit_seq(EXPLICIT_SEQ.replace("SliceType : I",
                                                        "SliceType : P", 1))


def test_encode_explicit_seq_equals_jax():
    rng = np.random.default_rng(3)
    H, W = 32, 48
    base = [np.kron(rng.integers(30, 230, (h // 8, w // 8)), np.ones((8, 8)))
            for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    frames = [tuple(np.clip(np.roll(b, (i, -i), (0, 1))
                            + rng.integers(-3, 4, b.shape), 0, 255)
                    .astype(np.uint8) for b in base) for i in range(5)]
    jp = JParams(width=W, height=H, qp=30, profile_idc=77, poc_type=0,
                 num_ref_frames=2)
    tp = params_from_dict(dataclasses.asdict(jp))
    seq = TE.parse_explicit_seq(EXPLICIT_SEQ)
    t_res, t_stream = TE.encode_explicit_seq(frames, tp, seq, search_range=4)
    j_res, j_stream = JE.encode_explicit_seq(frames, jp, seq, search_range=4)
    assert t_stream == j_stream
    assert [r.frame_type for r in t_res] == ["IDR", "B", "P", "B", "I"]
    assert [r.bits for r in t_res] == [r.bits for r in j_res]
    t_dec = TDecoder().decode(j_stream)
    j_dec = JDecoder().decode(t_stream)
    for i, r in enumerate(t_res):
        for c in range(3):
            np.testing.assert_array_equal(r.recon[c], j_res[i].recon[c])
            np.testing.assert_array_equal(t_dec[i][c], r.recon[c])
            np.testing.assert_array_equal(j_dec[i][c], r.recon[c])
