"""SPS / PPS / slice headers for the conformant AVC path (spec 7.3.2/7.3.3).

Generates exactly the syntax ldecod needs for Baseline-profile progressive
CAVLC streams (reference: ``JM/lencod/src/parset.c`` GenerateParameterSets,
``JM/lencod/src/header.c`` SliceHeader).

The port's own copy of ``h264tpu/avc/params.py``; it imports nothing from ``h264tpu``.
"""

from __future__ import annotations

import dataclasses

from ..entropy.bitio import BitWriter
from ..bitstream.nal import NALU, NAL_SPS, NAL_PPS, NAL_IDR, NAL_SLICE, annexb_write

# slice_type codes (Table 7-6); +5 variants mean "all slices in pic same type"
SLICE_P, SLICE_B, SLICE_I = 0, 1, 2


@dataclasses.dataclass
class AVCParams:
    width: int = 176
    height: int = 144
    qp: int = 28
    profile_idc: int = 66          # Baseline (66) / Main (77, CABAC)
    level_idc: int = 30
    cabac: bool = False            # entropy_coding_mode_flag (needs Main)
    weighted_pred: bool = False    # PPS weighted_pred_flag (explicit P WP)
    log2_max_frame_num: int = 8
    # POC: type 2 (decode order; IPPP only) or type 0 (explicit lsb, needed
    # once B pictures reorder display vs decode; spec 8.2.1)
    poc_type: int = 2
    log2_max_poc_lsb: int = 8
    num_ref_frames: int = 1
    deblock: bool = True           # in-loop filter on (disable_idc = 0/1)
    chroma_qp_offset: int = 0
    # FMO (spec 7.3.2.2 / 8.2.2): >1 slice groups, one slice per group.
    # map_type 0 = interleaved (equal run lengths), 1 = dispersed.
    slice_groups: int = 1
    slice_group_map_type: int = 1
    # VUI (spec E.1.1): (num_units_in_tick, time_scale) emits timing
    # info (frame rate = time_scale / (2 * num_units_in_tick)); None =
    # no VUI.  aspect_ratio_idc 0 = unspecified/omitted.
    vui_timing: tuple = None
    aspect_ratio_idc: int = 0
    # High profile (profile_idc 100): enable the per-MB 8x8 luma
    # transform choice (PPS transform_8x8_mode_flag; spec 7.4.2.2)
    transform_8x8: bool = False
    # High-profile scaling lists: None (flat) or "default" — emit
    # seq_scaling_matrix signalling the spec default matrices
    # (Tables 7-3/7-4) and quantize/reconstruct with them
    scaling_matrix: str = None
    # HRD (spec E.1.2 / Annex C): (bit_rate_bps, cpb_size_bits) emits
    # nal_hrd_parameters in the VUI (one CPB schedule, 24-bit delay
    # fields) so buffering_period/pic_timing SEI can reference it
    hrd: tuple = None
    # Redundant coded slices (spec 7.4.3 redundant_pic_cnt; JM
    # RedundantPicture/RedundantQPOffset): the PPS signals
    # redundant_pic_cnt_present_flag and every P picture is followed by
    # a coarser re-encode (qp + redundant_qp_offset) marked
    # redundant_pic_cnt=1 that a decoder uses only when the primary
    # slice is lost
    redundant_slices: bool = False
    redundant_qp_offset: int = 4

    @property
    def mb_w(self):
        return self.width // 16

    @property
    def mb_h(self):
        return self.height // 16


def params_from_dict(d: dict) -> AVCParams:
    """An :class:`AVCParams` from ``dataclasses.asdict`` of a parameter set
    of the same fields (for example the JAX package's ``AVCParams``)."""
    names = {f.name for f in dataclasses.fields(AVCParams)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown AVCParams fields {sorted(unknown)}")
    return AVCParams(**d)


def _trail(w: BitWriter) -> bytes:
    w.u(1, 1)
    return w.to_bytes()


def write_sps(p: AVCParams) -> bytes:
    w = BitWriter()
    w.u(p.profile_idc, 8)
    w.u(0, 8)                      # constraint flags + reserved zero
    w.u(p.level_idc, 8)
    w.ue(0)                        # sps_id
    if p.profile_idc >= 100:       # High-profile SPS extension (7.3.2.1.1)
        w.ue(1)                    # chroma_format_idc 4:2:0
        w.ue(0)                    # bit_depth_luma_minus8
        w.ue(0)                    # bit_depth_chroma_minus8
        w.u(0, 1)                  # qpprime_y_zero_transform_bypass_flag
        if p.scaling_matrix == "default":
            # seq_scaling_matrix with all 8 lists signalling
            # UseDefaultScalingMatrix (7.3.2.1.1.1: first delta_scale
            # = -8 makes nextScale 0 at scan 0)
            w.u(1, 1)              # seq_scaling_matrix_present_flag
            for _ in range(8):
                w.u(1, 1)          # seq_scaling_list_present_flag[i]
                w.se(-8)           # delta_scale -> use_default
        else:
            w.u(0, 1)              # seq_scaling_matrix_present_flag
    w.ue(p.log2_max_frame_num - 4)
    w.ue(p.poc_type)
    if p.poc_type == 0:
        w.ue(p.log2_max_poc_lsb - 4)
    w.ue(p.num_ref_frames)
    w.u(0, 1)                      # gaps_in_frame_num_value_allowed_flag
    w.ue(p.mb_w - 1)
    w.ue(p.mb_h - 1)
    w.u(1, 1)                      # frame_mbs_only_flag
    w.u(1, 1)                      # direct_8x8_inference_flag
    w.u(0, 1)                      # frame_cropping_flag
    has_vui = (p.vui_timing is not None or p.aspect_ratio_idc
               or p.hrd is not None)
    w.u(1 if has_vui else 0, 1)    # vui_parameters_present_flag
    if has_vui:
        w.u(1 if p.aspect_ratio_idc else 0, 1)
        if p.aspect_ratio_idc:
            w.u(p.aspect_ratio_idc, 8)
        w.u(0, 1)                  # overscan_info_present_flag
        w.u(0, 1)                  # video_signal_type_present_flag
        w.u(0, 1)                  # chroma_loc_info_present_flag
        if p.vui_timing is not None:
            w.u(1, 1)              # timing_info_present_flag
            w.u(p.vui_timing[0], 32)
            w.u(p.vui_timing[1], 32)
            w.u(1, 1)              # fixed_frame_rate_flag
        else:
            w.u(0, 1)
        if p.hrd is not None:      # nal_hrd_parameters (spec E.1.2)
            bitrate, cpb_bits = p.hrd
            w.u(1, 1)              # nal_hrd_parameters_present_flag
            w.ue(0)                # cpb_cnt_minus1
            scale_br, scale_cpb = 6, 4   # BitRate/CpbSize scales
            w.u(scale_br - 6, 4)   # bit_rate_scale
            w.u(scale_cpb - 4, 4)  # cpb_size_scale
            w.ue(max(int(bitrate) >> scale_br, 1) - 1)  # bit_rate_value
            w.ue(max(int(cpb_bits) >> scale_cpb, 1) - 1)
            w.u(0, 1)              # cbr_flag
            w.u(23, 5)             # initial_cpb_removal_delay_length-1
            w.u(23, 5)             # cpb_removal_delay_length_minus1
            w.u(23, 5)             # dpb_output_delay_length_minus1
            w.u(24, 5)             # time_offset_length
            w.u(0, 1)              # vcl_hrd_parameters_present_flag
            w.u(0, 1)              # low_delay_hrd_flag
        else:
            w.u(0, 1)              # nal_hrd_parameters_present_flag
            w.u(0, 1)              # vcl_hrd_parameters_present_flag
        w.u(0, 1)                  # pic_struct_present_flag
        w.u(0, 1)                  # bitstream_restriction_flag
    return _trail(w)


def write_pps(p: AVCParams) -> bytes:
    w = BitWriter()
    w.ue(0)                        # pps_id
    w.ue(0)                        # sps_id
    w.u(1 if p.cabac else 0, 1)    # entropy_coding_mode_flag
    w.u(0, 1)                      # bottom_field_pic_order_in_frame_present
    w.ue(p.slice_groups - 1)       # num_slice_groups_minus1
    if p.slice_groups > 1:
        w.ue(p.slice_group_map_type)
        if p.slice_group_map_type == 0:
            # interleaved: equal run lengths of one MB row each
            for _ in range(p.slice_groups):
                w.ue(p.mb_w - 1)   # run_length_minus1
        elif p.slice_group_map_type != 1:
            raise NotImplementedError("slice_group_map_type 2..6 syntax")
    w.ue(0)                        # num_ref_idx_l0_default_active_minus1
    w.ue(0)                        # num_ref_idx_l1_default_active_minus1
    w.u(1 if p.weighted_pred else 0, 1)  # weighted_pred_flag
    w.u(0, 2)                      # weighted_bipred_idc
    w.se(p.qp - 26)                # pic_init_qp_minus26
    w.se(0)                        # pic_init_qs_minus26
    w.se(p.chroma_qp_offset)       # chroma_qp_index_offset
    w.u(1, 1)                      # deblocking_filter_control_present_flag
    w.u(0, 1)                      # constrained_intra_pred_flag
    w.u(1 if p.redundant_slices else 0, 1)  # redundant_pic_cnt_present_flag
    if p.transform_8x8:            # High-profile PPS extension
        w.u(1, 1)                  # transform_8x8_mode_flag
        w.u(0, 1)                  # pic_scaling_matrix_present_flag
        w.se(p.chroma_qp_offset)   # second_chroma_qp_index_offset
    return _trail(w)


def write_slice_header(w: BitWriter, p: AVCParams, slice_type: int,
                       frame_num: int, idr: bool, slice_qp: int,
                       first_mb: int = 0, idr_pic_id: int = 0,
                       num_ref_idx_l0: int = 1, poc_lsb: int = 0,
                       num_ref_idx_l1: int = 1, ref_pic: bool = True,
                       mmco=None, reorder_l0=None, wp=None,
                       long_term_idr: bool = False,
                       redundant_pic_cnt: int = 0):
    """Slice header bits into ``w`` (spec 7.3.3; frame coding)."""
    w.ue(first_mb)
    w.ue(slice_type + 5)           # all slices of the picture share the type
    w.ue(0)                        # pps_id
    w.u(frame_num % (1 << p.log2_max_frame_num), p.log2_max_frame_num)
    if idr:
        w.ue(idr_pic_id)
    if p.poc_type == 0:
        w.u(poc_lsb % (1 << p.log2_max_poc_lsb), p.log2_max_poc_lsb)
    if p.redundant_slices:
        w.ue(redundant_pic_cnt)
    if slice_type == SLICE_B:
        w.u(1, 1)                  # direct_spatial_mv_pred_flag
    if slice_type in (SLICE_P, SLICE_B):
        override = (num_ref_idx_l0 != 1
                    or (slice_type == SLICE_B and num_ref_idx_l1 != 1))
        w.u(1 if override else 0, 1)  # num_ref_idx_active_override_flag
        if override:
            w.ue(num_ref_idx_l0 - 1)
            if slice_type == SLICE_B:
                w.ue(num_ref_idx_l1 - 1)
        if reorder_l0:
            w.u(1, 1)              # ref_pic_list_modification_flag_l0
            for op, val in reorder_l0:   # (0/1, abs_diff_pic_num_minus1)
                w.ue(op)
                w.ue(val)
            w.ue(3)                # end of modification ops
        else:
            w.u(0, 1)              # ref_pic_list_modification_flag_l0
        if slice_type == SLICE_B:
            w.u(0, 1)              # ref_pic_list_modification_flag_l1
        if slice_type == SLICE_P and p.weighted_pred:
            # pred_weight_table (spec 7.3.3.2), explicit P WP.
            # wp: dict(d_l, d_c, l0=[(wy, oy, wu, ou, wv, ov), ...])
            w.ue(wp["d_l"])
            w.ue(wp["d_c"])
            for (wy, oy, wu, ou, wv, ov) in wp["l0"][:num_ref_idx_l0]:
                dflt_y = wy == (1 << wp["d_l"]) and oy == 0
                w.u(0 if dflt_y else 1, 1)
                if not dflt_y:
                    w.se(wy)
                    w.se(oy)
                dflt_c = (wu == (1 << wp["d_c"]) and ou == 0
                          and wv == (1 << wp["d_c"]) and ov == 0)
                w.u(0 if dflt_c else 1, 1)
                if not dflt_c:
                    w.se(wu)
                    w.se(ou)
                    w.se(wv)
                    w.se(ov)
    if ref_pic:
        if idr:
            w.u(0, 1)              # no_output_of_prior_pics_flag
            w.u(1 if long_term_idr else 0, 1)  # long_term_reference_flag
        elif mmco:
            w.u(1, 1)              # adaptive_ref_pic_marking_mode_flag
            for op in mmco:        # (1, diff) short-term -> unused, etc.
                w.ue(op[0])
                for v in op[1:]:
                    w.ue(v)
            w.ue(0)                # end of ops
        else:
            w.u(0, 1)              # adaptive_ref_pic_marking_mode_flag
    if p.cabac and slice_type != SLICE_I:
        w.ue(0)                    # cabac_init_idc
    w.se(slice_qp - p.qp)          # slice_qp_delta
    w.ue(0 if p.deblock else 1)    # disable_deblocking_filter_idc
    if p.deblock:
        w.se(0)                    # slice_alpha_c0_offset_div2
        w.se(0)                    # slice_beta_offset_div2


def assemble_stream(p: AVCParams, slices) -> bytes:
    """Annex-B byte stream: SPS, PPS, then coded slices.

    ``slices``: list of (idr: bool, rbsp: bytes) or (idr, rbsp, ref_idc)
    — ref_idc 0 marks non-reference pictures (disposable B).
    """
    nalus = [NALU(NAL_SPS, 3, write_sps(p)), NALU(NAL_PPS, 3, write_pps(p))]
    for entry in slices:
        idr, rbsp = entry[0], entry[1]
        ref_idc = entry[2] if len(entry) > 2 else 3
        if isinstance(rbsp, tuple):
            # data-partitioned slice (spec 7.4.1): A/B/C -> NAL 2/3/4
            a, b, c = rbsp
            nalus.append(NALU(2, ref_idc, a))
            nalus.append(NALU(3, ref_idc, b))
            nalus.append(NALU(4, ref_idc, c))
        else:
            nalus.append(NALU(NAL_IDR if idr else NAL_SLICE, ref_idc, rbsp))
    return annexb_write(nalus)
