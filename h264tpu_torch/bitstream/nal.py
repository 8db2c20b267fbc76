"""NAL units, emulation prevention, Annex-B byte streams, SPS/PPS.

TPU-framework equivalent of the reference's bitstream/NAL layer (SURVEY F17):
``FR/src/nalu.c`` (RBSPtoNALU), ``FR/src/nal.c`` (RBSPtoEBSP emulation
prevention), ``FR/src/annexb.c:51`` (WriteAnnexbNALU start codes),
``FR/src/parset.c`` (GenerateParameterSets / SPS / PPS).

The SPS and PPS are real H.264 spec syntax (7.3.2.1/7.3.2.2) generated from
the codec config.  Frame payloads are the framework's FVC syntax carried in
NAL unit types from the UNSPECIFIED range (24/25), since the fractal P-frame
engine is not standard H.264 slice syntax (the reference stream is equally
non-conformant — it writes fractal TRANS_NODE syntax into its slices,
``FR/src/macroblock.c:3786``).  Parameter-set round-tripping is still checked
against the spec syntax, and the classic-inter path can migrate its payloads
to real slice NALUs without touching this layer.

Host-side work only; the emulation-prevention scan is the Python path.

The port's own copy of ``h264tpu/bitstream/nal.py``; it imports nothing from ``h264tpu``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..entropy.bitio import BitWriter, BitReader

# NAL unit types
NAL_SLICE = 1          # (classic-path roadmap: real coded slices)
NAL_IDR = 5
NAL_SEI = 6
NAL_SPS = 7
NAL_PPS = 8
NAL_FVC_HEADER = 24    # unspecified range: FVC stream header
NAL_FVC_FRAME = 25     # unspecified range: FVC frame payload


@dataclasses.dataclass
class NALU:
    nal_type: int
    ref_idc: int
    rbsp: bytes          # raw byte sequence payload (no EP bytes)


# ---------------------------------------------------------------------------
# Emulation prevention (00 00 0[0-3] -> 00 00 03 0[0-3])
# ---------------------------------------------------------------------------

def ep_insert(rbsp: bytes) -> bytes:
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros == 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def ep_strip(ebsp: bytes) -> bytes:
    out = bytearray()
    zeros = 0
    for b in ebsp:
        if zeros == 2 and b == 3:
            zeros = 0
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


# ---------------------------------------------------------------------------
# NALU <-> bytes
# ---------------------------------------------------------------------------

def nalu_to_bytes(n: NALU) -> bytes:
    """NAL header byte + EBSP payload (no start code)."""
    hdr = ((n.ref_idc & 3) << 5) | (n.nal_type & 0x1F)
    return bytes([hdr]) + ep_insert(n.rbsp)


def nalu_from_bytes(data: bytes) -> NALU:
    hdr = data[0]
    if hdr & 0x80:
        raise ValueError("forbidden_zero_bit set")
    return NALU(nal_type=hdr & 0x1F, ref_idc=(hdr >> 5) & 3,
                rbsp=ep_strip(data[1:]))


def annexb_write(nalus) -> bytes:
    """Annex-B byte stream: 4-byte start code before parameter sets and the
    first NALU, 3-byte elsewhere (WriteAnnexbNALU, FR/src/annexb.c:51)."""
    out = bytearray()
    for i, n in enumerate(nalus):
        long_sc = i == 0 or n.nal_type in (NAL_SPS, NAL_PPS)
        out += b"\x00\x00\x00\x01" if long_sc else b"\x00\x00\x01"
        out += nalu_to_bytes(n)
    return bytes(out)


def annexb_parse(data: bytes):
    """Split an Annex-B stream into NALUs (GetAnnexbNALU semantics)."""
    buf = np.frombuffer(data, np.uint8)
    # start-code positions: 00 00 01
    sc = np.flatnonzero((buf[:-2] == 0) & (buf[1:-1] == 0) & (buf[2:] == 1))
    # drop overlapping matches (00 00 00 01 yields hits at i-1 and i)
    keep = []
    last_end = -1
    for p in sc.tolist():
        if p >= last_end:
            keep.append(p)
            last_end = p + 3
    nalus = []
    for i, p in enumerate(keep):
        start = p + 3
        end = keep[i + 1] if i + 1 < len(keep) else len(data)
        # strip trailing zero bytes that belong to the next 4-byte start code
        while end > start and data[end - 1] == 0 and i + 1 < len(keep):
            end -= 1
        nalus.append(nalu_from_bytes(data[start:end]))
    return nalus


# ---------------------------------------------------------------------------
# SPS / PPS (spec 7.3.2.1 / 7.3.2.2, subset used by the framework)
# ---------------------------------------------------------------------------

def write_sps(cfg) -> bytes:
    """seq_parameter_set_rbsp from the codec config (GenerateParameterSets
    equivalent, FR/src/parset.c)."""
    w = BitWriter()
    w.u(int(cfg.profile), 8)
    w.u(0, 8)                      # constraint flags + reserved
    w.u(cfg.level_idc, 8)
    w.ue(0)                        # seq_parameter_set_id
    w.ue(4)                        # log2_max_frame_num_minus4 -> 8 bit
    w.ue(2)                        # pic_order_cnt_type = 2 (no B reorder yet)
    w.ue(max(cfg.num_ref_frames, 1))
    w.u(0, 1)                      # gaps_in_frame_num_value_allowed
    w.ue(cfg.width // 16 - 1)      # pic_width_in_mbs_minus1
    w.ue(cfg.height // 16 - 1)     # pic_height_in_map_units_minus1
    w.u(1, 1)                      # frame_mbs_only_flag
    w.u(1, 1)                      # direct_8x8_inference_flag
    w.u(0, 1)                      # frame_cropping_flag
    w.u(0, 1)                      # vui_parameters_present_flag
    return _rbsp_trailing(w)


def read_sps(rbsp: bytes) -> dict:
    r = BitReader(rbsp)
    out = dict(profile_idc=r.u(8))
    r.u(8)
    out["level_idc"] = r.u(8)
    out["sps_id"] = r.ue()
    out["log2_max_frame_num"] = r.ue() + 4
    out["poc_type"] = r.ue()
    out["num_ref_frames"] = r.ue()
    r.u(1)
    out["width"] = (r.ue() + 1) * 16
    out["height"] = (r.ue() + 1) * 16
    out["frame_mbs_only"] = r.u(1)
    return out


def write_pps(cfg) -> bytes:
    """pic_parameter_set_rbsp (subset)."""
    w = BitWriter()
    w.ue(0)                        # pic_parameter_set_id
    w.ue(0)                        # seq_parameter_set_id
    w.u(int(cfg.entropy) == 1, 1)  # entropy_coding_mode_flag (CABAC)
    w.u(0, 1)                      # bottom_field_pic_order_in_frame_present
    w.ue(0)                        # num_slice_groups_minus1 (FMO off here)
    w.ue(0)                        # num_ref_idx_l0_default_active_minus1
    w.ue(0)                        # num_ref_idx_l1_default_active_minus1
    w.u(0, 1)                      # weighted_pred_flag
    w.u(0, 2)                      # weighted_bipred_idc
    w.se(np.array([cfg.qp - 26]))  # pic_init_qp_minus26
    w.se(np.array([0]))            # pic_init_qs_minus26
    w.se(np.array([0]))            # chroma_qp_index_offset
    w.u(int(cfg.deblock), 1)       # deblocking_filter_control_present
    w.u(0, 1)                      # constrained_intra_pred_flag
    w.u(0, 1)                      # redundant_pic_cnt_present_flag
    return _rbsp_trailing(w)


def read_pps(rbsp: bytes) -> dict:
    r = BitReader(rbsp)
    out = dict(pps_id=r.ue(), sps_id=r.ue(), cabac=r.u(1))
    r.u(1)
    out["num_slice_groups"] = r.ue() + 1
    r.ue(), r.ue(), r.u(1), r.u(2)
    out["pic_init_qp"] = r.se() + 26
    return out


def _rbsp_trailing(w: BitWriter) -> bytes:
    w.u(1, 1)                      # rbsp_stop_one_bit; to_bytes zero-pads
    return w.to_bytes()


# ---------------------------------------------------------------------------
# Stream-level assembly for the codec
# ---------------------------------------------------------------------------

def wrap_stream(cfg, header_bytes: bytes, frame_payloads) -> bytes:
    """FVC stream -> Annex-B: SPS, PPS, FVC header NALU, frame NALUs.

    ``frame_payloads``: list of per-(frame,view) payload bytes in stream
    order.  Each frame NALU's RBSP is ``u16 index | payload`` so a receiver
    can detect losses (the index is container-level, like RTP seq numbers).
    """
    nalus = [NALU(NAL_SPS, 3, write_sps(cfg)), NALU(NAL_PPS, 3, write_pps(cfg)),
             NALU(NAL_FVC_HEADER, 3, header_bytes + b"\x80")]
    for i, payload in enumerate(frame_payloads):
        idx = bytes([(i >> 8) & 0xFF, i & 0xFF])
        ref_idc = 2 if payload and payload[0] != 0 else 3  # I frames: 3
        # 0x80 trailer = rbsp_trailing_bits analogue: FVC payloads may end in
        # 0x00, which would be eaten by the next start code's zero prefix
        nalus.append(NALU(NAL_FVC_FRAME, ref_idc, idx + payload + b"\x80"))
    return annexb_write(nalus)


def unwrap_stream(data: bytes):
    """Annex-B -> (sps dict, pps dict, header bytes, {index: payload}).

    Missing indices (lost NALUs) are simply absent from the dict; the
    decoder's concealment handles them.
    """
    sps = pps = None
    header = None
    payloads = {}
    for n in annexb_parse(data):
        if n.nal_type == NAL_SPS:
            sps = read_sps(n.rbsp)
        elif n.nal_type == NAL_PPS:
            pps = read_pps(n.rbsp)
        elif n.nal_type == NAL_FVC_HEADER:
            header = n.rbsp[:-1]            # strip the 0x80 trailer
        elif n.nal_type == NAL_FVC_FRAME:
            idx = (n.rbsp[0] << 8) | n.rbsp[1]
            payloads[idx] = n.rbsp[2:-1]    # strip the 0x80 trailer
    if header is None:
        raise ValueError("no FVC header NALU in stream")
    return sps, pps, header, payloads
