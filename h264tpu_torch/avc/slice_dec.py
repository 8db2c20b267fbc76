"""Standard H.264 decoder, progressive (host model).

Decodes H.264 Annex-B streams bit-exactly: I/IDR, P and B slices (every P
partition and sub-partition type, every B mb_type and B_8x8 sub type),
spatial and temporal direct (8.4.1.2.2/8.4.1.2.3), CAVLC and CABAC entropy
for all three slice types (``avc/cabac.py``), High profile's 8x8 transform
of inter MBs and scaling lists (SPS/PPS, spec fall-back rules and default
matrices), intra 4x4/16x16 and I_PCM (CAVLC), P_Skip/B_Skip, explicit
weighted prediction, multi-ref sliding-window DPB with long-term reference
pictures (MMCO ops 1-6) and reference list modification, POC types 0/1/2
with display-order output keyed by (idr_epoch, poc), multi-slice pictures
(spec 6.4.11 slice-restricted availability), mb_qp_delta, data
partitioning (NAL 2/3/4), HRD VUI, in-loop deblocking (with the two-list B
bS derivation), and per-syntax-element bit statistics (``bit_statistics``,
the dec_statistics.c analogue).  The JM counterpart is
``JM/ldecod/src/{image.c:809 decode_one_frame, mb_read.c:1139,
read_comp_cavlc.c, mb_prediction.c, mc_direct.c}``.

MVC 2-view stereo (``decode_mvc``): view 1's coded-slice extensions with
the co-temporal base picture as an inter-view reference.

FMO slice groups take their map from ``models/resilience.py``; a picture
whose slices did not cover every MB (lost NAL units) is concealed MB by MB
with ``avc/erc.py`` (``AVCDecoder.concealed_mbs`` counts the MBs of each
picture).

Intra 8x8 (I_NxN with transform_size_8x8_flag, CAVLC or CABAC) decodes
as in the reference.  Raise ``NotImplementedError``: I_PCM under CABAC (as
in the reference), fields/MBAFF, 4:2:2/4:4:4/>8-bit.

The port's own copy of ``h264tpu/avc/slice_dec.py``; it imports nothing
from ``h264tpu``.
"""

from __future__ import annotations

import numpy as np

from ..entropy.bitio import BitReader
from ..bitstream.nal import annexb_parse, NAL_SPS, NAL_PPS, NAL_IDR, NAL_SLICE
from . import quant as Q
from . import intra_pred as IP
from . import cavlc as CV
from . import inter as INTER
from .tables import BLOCK_SCAN, BLOCK_SCAN_INV, CODENUM_TO_CBP_INTRA, \
    CODENUM_TO_CBP_INTER, mb_type_i16_parse
from . import cabac as CB
from . import native as AN
from . import quant8 as Q8
from . import qmatrix as QM
from .deblock import DeblockContext
from . import erc as ERC
from ..models.resilience import slice_group_map
from .params import crop_window


def parse_sps(rbsp: bytes) -> dict:
    r = BitReader(rbsp)
    s = dict(profile_idc=r.u(8))
    r.u(8)
    s["level_idc"] = r.u(8)
    s["sps_id"] = r.ue()
    s["chroma_format_idc"] = 1
    if s["profile_idc"] in (100, 110, 122, 244, 44, 83, 86, 118, 128):
        # High-profile SPS extension (spec 7.3.2.1.1)
        s["chroma_format_idc"] = r.ue()
        if s["chroma_format_idc"] != 1:
            raise NotImplementedError("chroma_format_idc != 4:2:0")
        if r.ue() or r.ue():                # bit_depth_{luma,chroma}_minus8
            raise NotImplementedError(">8-bit coding")
        r.u(1)                              # qpprime_y_zero_transform_bypass
        if r.u(1):                          # seq_scaling_matrix_present
            s["seq_scaling"] = QM.parse_scaling_block(r, 8)
    s["log2_max_frame_num"] = r.ue() + 4
    s["poc_type"] = r.ue()
    if s["poc_type"] == 0:
        s["log2_max_poc_lsb"] = r.ue() + 4
    elif s["poc_type"] == 1:                # spec 8.2.1.2 cycle offsets
        s["delta_poc_always_zero"] = r.u(1)
        s["offset_for_non_ref_pic"] = r.se()
        s["offset_for_top_to_bottom_field"] = r.se()
        n = r.ue()
        s["offsets_for_ref_frame"] = [r.se() for _ in range(n)]
    s["num_ref_frames"] = r.ue()
    r.u(1)
    s["width"] = (r.ue() + 1) * 16
    s["height_map_units"] = r.ue() + 1
    s["frame_mbs_only"] = r.u(1)
    if not s["frame_mbs_only"]:
        raise NotImplementedError("interlace")
    s["height"] = s["height_map_units"] * 16
    s["direct_8x8_inference"] = r.u(1)
    if r.u(1):                              # frame_cropping
        s["crop"] = (r.ue(), r.ue(), r.ue(), r.ue())
    else:
        s["crop"] = None
    s["vui"] = None
    if r.u(1):                              # vui_parameters_present_flag
        s["vui"] = _parse_vui(r)
    return s


def _parse_vui(r: BitReader) -> dict:
    """VUI parameters (spec E.1.1) — the subset the reference emits:
    aspect ratio, video signal type, timing, + skip-parsing of the
    optional leaves we don't interpret."""
    v = {}
    if r.u(1):                              # aspect_ratio_info_present
        idc = r.u(8)
        v["aspect_ratio_idc"] = idc
        if idc == 255:                      # Extended_SAR
            v["sar"] = (r.u(16), r.u(16))
    if r.u(1):                              # overscan_info_present
        v["overscan_appropriate"] = r.u(1)
    if r.u(1):                              # video_signal_type_present
        v["video_format"] = r.u(3)
        v["video_full_range"] = r.u(1)
        if r.u(1):                          # colour_description_present
            v["colour_primaries"] = r.u(8)
            v["transfer_characteristics"] = r.u(8)
            v["matrix_coefficients"] = r.u(8)
    if r.u(1):                              # chroma_loc_info_present
        v["chroma_loc_top"] = r.ue()
        v["chroma_loc_bottom"] = r.ue()
    if r.u(1):                              # timing_info_present
        v["num_units_in_tick"] = r.u(32)
        v["time_scale"] = r.u(32)
        v["fixed_frame_rate"] = r.u(1)
    def hrd_params():
        h = {}
        cpb_cnt = r.ue() + 1
        h["bit_rate_scale"] = r.u(4) + 6
        h["cpb_size_scale"] = r.u(4) + 4
        h["schedules"] = []
        for _ in range(cpb_cnt):
            h["schedules"].append(
                dict(bit_rate=(r.ue() + 1) << h["bit_rate_scale"],
                     cpb_size=(r.ue() + 1) << h["cpb_size_scale"],
                     cbr=bool(r.u(1))))
        h["initial_cpb_removal_delay_length"] = r.u(5) + 1
        h["cpb_removal_delay_length"] = r.u(5) + 1
        h["dpb_output_delay_length"] = r.u(5) + 1
        h["time_offset_length"] = r.u(5)
        return h

    nal_hrd = r.u(1)                        # nal_hrd_parameters_present
    if nal_hrd:
        v["nal_hrd"] = hrd_params()
    vcl_hrd = r.u(1)                        # vcl_hrd_parameters_present
    if vcl_hrd:
        v["vcl_hrd"] = hrd_params()
    if nal_hrd or vcl_hrd:
        v["low_delay_hrd"] = r.u(1)
    v["pic_struct_present"] = r.u(1)
    if r.u(1):                              # bitstream_restriction
        v["motion_vectors_over_pic_boundaries"] = r.u(1)
        v["max_bytes_per_pic_denom"] = r.ue()
        v["max_bits_per_mb_denom"] = r.ue()
        v["log2_max_mv_length_horizontal"] = r.ue()
        v["log2_max_mv_length_vertical"] = r.ue()
        v["num_reorder_frames"] = r.ue()
        v["max_dec_frame_buffering"] = r.ue()
    return v


def parse_pps(rbsp: bytes) -> dict:
    r = BitReader(rbsp)
    p = dict(pps_id=r.ue(), sps_id=r.ue())
    p["cabac"] = r.u(1)
    p["pic_order_present"] = r.u(1)
    p["slice_groups"] = r.ue() + 1          # FMO (spec 7.3.2.2 / 8.2.2)
    if p["slice_groups"] > 1:
        t = r.ue()
        p["sg_map_type"] = t
        G = p["slice_groups"]
        if t == 0:
            p["sg_runs"] = [r.ue() + 1 for _ in range(G)]
        elif t == 2:                        # foreground + leftover
            p["sg_tl"] = []
            p["sg_br"] = []
            for _ in range(G - 1):
                p["sg_tl"].append(r.ue())
                p["sg_br"].append(r.ue())
        elif t in (3, 4, 5):                # changing slice groups
            p["sg_change_dir"] = r.u(1)
            p["sg_change_rate"] = r.ue() + 1
        elif t == 6:                        # explicit
            n = r.ue() + 1
            bits = max((G - 1).bit_length(), 1)
            p["sg_explicit"] = [r.u(bits) for _ in range(n)]
        elif t != 1:
            raise ValueError(f"slice_group_map_type {t}")
    p["num_ref_idx_l0"] = r.ue() + 1
    p["num_ref_idx_l1"] = r.ue() + 1
    p["weighted_pred"] = r.u(1)
    p["weighted_bipred_idc"] = r.u(2)       # 0 default, 1 explicit B
    p["pic_init_qp"] = r.se() + 26
    r.se()                                  # pic_init_qs
    p["chroma_qp_offset"] = r.se()
    p["deblock_ctrl"] = r.u(1)
    p["constrained_intra"] = r.u(1)
    if p["constrained_intra"]:
        raise NotImplementedError("constrained intra pred")
    p["redundant_pic_cnt"] = r.u(1)
    p["transform_8x8"] = 0
    p["second_chroma_qp_offset"] = p["chroma_qp_offset"]
    # more_rbsp_data: bits remain before the rbsp_stop_one_bit
    stop = int(np.flatnonzero(r._bits)[-1])
    if r.pos < stop:                        # High-profile PPS extension
        p["transform_8x8"] = r.u(1)
        if r.u(1):                          # pic_scaling_matrix_present
            p["pic_scaling"] = QM.parse_scaling_block(
                r, 6 + 2 * p["transform_8x8"])
        p["second_chroma_qp_offset"] = r.se()
        if p["second_chroma_qp_offset"] != p["chroma_qp_offset"]:
            raise NotImplementedError("separate Cr QP offset")
    return p


def _slice_group_map(pps: dict, mb_w: int, mb_h: int,
                     change_cycle: int = 0) -> np.ndarray:
    """mapUnitToSliceGroupMap (spec 8.2.2.1-8.2.2.8) -> flat [n_mb];
    the full 7-type generator lives in models/resilience.py.  For types
    3..5 ``change_cycle`` is the slice-header slice_group_change_cycle."""
    t = pps["sg_map_type"]
    m = slice_group_map(t, pps["slice_groups"], mb_w, mb_h,
                        run_lengths=pps.get("sg_runs"),
                        top_left=pps.get("sg_tl"),
                        bottom_right=pps.get("sg_br"),
                        change_direction=pps.get("sg_change_dir", 0),
                        change_rate=pps.get("sg_change_rate", 1),
                        change_cycle=change_cycle,
                        explicit_map=pps.get("sg_explicit"))
    return m.reshape(-1).astype(np.int64)


def _te(r: BitReader, max_val: int) -> int:
    """te(v): truncated Exp-Golomb (spec 9.1.1); max_val = syntax range max."""
    if max_val == 1:
        return 1 - r.u(1)
    return r.ue()


class AVCDecoder:
    """Sequential H.264 decoder over an Annex-B byte stream.

    ``trace=True`` records every parsed syntax element as (bit_position,
    name, value) — the JM ``TraceFile`` analogue (``trace2out``,
    FR/src/vlc.c:1176; SURVEY §4.3: the entropy-coder conformance oracle).
    Dump with :meth:`write_trace`."""

    def __init__(self, trace: bool = False):
        self.sps = {}
        self.pps = {}
        # DPB entries: dict(fn, poc, frame, rp, mv, ref) — mv/ref are the
        # stored picture's motion (colocated data for B spatial direct)
        self.dpb = []
        self._max_lt_idx = -1
        self._prev_poc_lsb = 0
        self._prev_poc_msb = 0
        self.trace = [] if trace else None
        # MBs concealed in each finished picture, in decode order
        self.concealed_mbs = []
        # MVC view 1: the co-temporal base picture (``decode_mvc``)
        self._inter_view_entry = None

    def _tr(self, r, name, value):
        if self.trace is not None:
            self.trace.append((r.pos, name, int(value)))
        return value

    def write_trace(self, path: str):
        """trace_dec.txt-style dump: @bitpos  element  value."""
        with open(path, "w") as f:
            for pos, name, val in (self.trace or []):
                f.write(f"@{pos:<10d} {name:<28s} {val}\n")

    def bit_statistics(self) -> dict:
        """Per-syntax-element bit accounting from the decode trace —
        the ``JM/ldecod/src/dec_statistics.c`` analogue.  Requires
        AVCDecoder(trace=True); returns {element: (count, bits)} where
        an element's bits run to the next traced element in the same
        NAL (the final element of each NAL is bounded by its end)."""
        out = {}
        tr = self.trace or []
        for i, (pos, name, _val) in enumerate(tr):
            if i + 1 < len(tr) and tr[i + 1][0] >= pos:
                bits = tr[i + 1][0] - pos
            else:
                bits = 0
            c, b = out.get(name, (0, 0))
            out[name] = (c + 1, b + bits)
        return out

    def write_statistics(self, path: str):
        """dec_statistics-style report: element, count, total bits."""
        stats = self.bit_statistics()
        with open(path, "w") as f:
            f.write(f"{'syntax element':<30s} {'count':>8s} {'bits':>10s}\n")
            for name, (c, b) in sorted(stats.items(),
                                       key=lambda kv: -kv[1][1]):
                f.write(f"{name:<30s} {c:>8d} {b:>10d}\n")

    def decode(self, stream: bytes, max_frames: int = None):
        """Decode all coded pictures; returns list of (y, u, v) uint8, each
        the SPS's crop window of the coded picture that the DPB keeps.

        Multi-slice pictures are supported for contiguous (non-FMO)
        slices: a new picture starts at each slice with
        first_mb_in_slice == 0; all slices until the next such slice
        share the picture's reconstruction while every prediction /
        entropy context is restricted to the current slice (spec 6.4.11
        availability)."""
        out = []
        self._order = []       # (idr_epoch, poc) per output frame
        self._idr_epoch = 0
        self._pic = None
        self.concealed_mbs = []
        poc_reorder = False
        nals = list(annexb_parse(stream))
        i = 0
        while i < len(nals):
            n = nals[i]
            i += 1
            if n.nal_type == NAL_SPS:
                s = parse_sps(n.rbsp)
                self.sps[s["sps_id"]] = s
                poc_reorder |= s["poc_type"] in (0, 1)
            elif n.nal_type == NAL_PPS:
                p = parse_pps(n.rbsp)
                self.pps[p["pps_id"]] = p
            elif n.nal_type in (NAL_IDR, NAL_SLICE, 2):
                if n.nal_type != 2:
                    fmb, red, fn = self._peek_redundant(
                        n.rbsp, n.nal_type == NAL_IDR)
                    if (red and fn == getattr(self, "_cov_fn", None)
                            and fmb in getattr(self, "_cov", set())):
                        # redundant coded slice whose primary (same
                        # frame_num + first_mb) arrived: discard (spec
                        # 7.4.3 redundant_pic_cnt; a decoder uses
                        # redundancy only on loss)
                        continue
                dp = None
                if n.nal_type == 2:          # DP partition A (7.4.1)
                    rb = rc = None
                    while i < len(nals) and nals[i].nal_type in (3, 4):
                        if nals[i].nal_type == 3:
                            rb = nals[i].rbsp
                        else:
                            rc = nals[i].rbsp
                        i += 1
                    dp = (rb, rc)
                fr = self._decode_slice(n.rbsp, n.nal_type == NAL_IDR,
                                        n.ref_idc, dp=dp)
                if fr is not None:
                    out.append(fr)
                    if max_frames and len(out) >= max_frames:
                        self._pic = None
                        return self._display_order(out, poc_reorder)
        fr = self._finish_picture()
        if fr is not None:
            out.append(fr)
        return self._display_order(out, poc_reorder)

    def decode_mvc(self, stream: bytes):
        """Decode a 2-view MVC stereo stream (base AVC NALs + subset
        SPS type 15 + coded-slice-extension type 20 with
        nal_unit_header_mvc_extension).  View-1 pictures may predict
        from the co-temporal base picture via the appended inter-view
        reference (H.8.2.1).  Returns (view0_frames, view1_frames)."""
        from .mvc import parse_subset_sps, NAL_SUBSET_SPS, NAL_SLICE_EXT
        out0 = []
        self._order = []
        self._idr_epoch = 0
        self._pic = None
        child = AVCDecoder(trace=self.trace)
        child.sps = self.sps
        child.pps = self.pps
        child_out = []
        child._order = []
        child._idr_epoch = 0
        child._pic = None
        base_done = 0
        for n in annexb_parse(stream):
            if n.nal_type == NAL_SPS:
                s = parse_sps(n.rbsp)
                if s["crop"] is not None:
                    raise NotImplementedError("MVC with a cropped SPS")
                self.sps[s["sps_id"]] = s
            elif n.nal_type == NAL_SUBSET_SPS:
                parse_subset_sps(n.rbsp)     # structural validation
            elif n.nal_type == NAL_PPS:
                p = parse_pps(n.rbsp)
                self.pps[p["pps_id"]] = p
            elif n.nal_type in (NAL_IDR, NAL_SLICE):
                fr = self._decode_slice(n.rbsp, n.nal_type == NAL_IDR,
                                        n.ref_idc)
                if fr is not None:
                    out0.append(fr)
            elif n.nal_type == NAL_SLICE_EXT:
                # the co-temporal base picture must be complete: flush it
                fr = self._finish_picture()
                if fr is not None:
                    out0.append(fr)
                if len(out0) > base_done:
                    base_done = len(out0)
                    child._inter_view_entry = self._inter_view(
                        out0[-1], base_done)
                fr1 = child._decode_slice(n.rbsp[3:], False, n.ref_idc)
                if fr1 is not None:
                    child_out.append(fr1)
        fr = self._finish_picture()
        if fr is not None:
            out0.append(fr)
        fr1 = child._finish_picture()
        if fr1 is not None:
            child_out.append(fr1)
        return out0, child_out

    def _inter_view(self, base_fr, n_base: int) -> dict:
        """The DPB-style entry of a base-view picture as view 1's
        inter-view reference: int64 RefPlanes, no motion (mv 0, ref -1 on
        the 4x4 grid)."""
        h, w = self.sps[0]["height"], self.sps[0]["width"]
        planes = tuple(pl.astype(np.int64) for pl in base_fr)
        return dict(fn=-1, poc=-1000 - n_base, frame=base_fr,
                    rp=INTER.RefPlanes(*planes),
                    mv=np.zeros((h // 4, w // 4, 2), np.int64),
                    ref=np.full((h // 4, w // 4), -1, np.int64),
                    ref_poc=None, long=False, lt_idx=-1)

    def _display_order(self, out, poc_reorder):
        """Ascending-POC display reorder per 8.2.1; POC resets at each
        IDR, so the sort key is (idr_epoch, poc)."""
        if poc_reorder and len(self._order) == len(out):
            order = sorted(range(len(out)), key=lambda i: self._order[i])
            out = [out[i] for i in order]
        return out

    # ------------------------------------------------------------------
    def _finish_picture(self):
        """Deblock + output + DPB-store the accumulated picture."""
        pic = self._pic
        if pic is None:
            return None
        self._pic = None
        sps, pps = pic["sps"], pic["pps"]
        # lost slices: MB-level concealment (erc_do_i/erc_do_p shape)
        self.concealed_mbs.append(ERC.conceal_picture(pic))
        rec = pic["rec"]
        ctx = DeblockContext(pic["mb_w"], pic["mb_h"], pic["qp"],
                             pps["chroma_qp_offset"])
        ctx.mb_qp = pic["mb_qp"]
        ctx.mb_intra = pic["mb_intra"]
        ctx.nnz = pic["nnz"]
        t8 = pic["transform8"]
        if t8.any():
            # 8x8-transform MBs: bS tests the 8x8 TRANSFORM block's coded
            # status (spec 8.7.2.1), so spread each 8x8's aggregate over
            # its four 4x4 cells (JM cbp_blk semantics; the per-4x4
            # values stay as-read for CAVLC nC only)
            nnz = pic["nnz"]
            q = nnz.reshape(pic["mb_h"] * 2, 2,
                            pic["mb_w"] * 2, 2).sum(axis=(1, 3))
            q = np.repeat(np.repeat(q, 2, 0), 2, 1)
            m8 = np.repeat(np.repeat(t8, 4, 0), 4, 1)
            ctx.nnz = np.where(m8, q, nnz)
        ctx.transform8 = t8
        ctx.mv = pic["mv"]
        ctx.ref = pic["ref"]
        ctx.alpha_off, ctx.beta_off = pic["a_off"], pic["b_off"]
        if pic["is_b"]:
            ctx.mv1 = pic["mv1"]
            ctx.ref1 = pic["ref1"]
        if pic["disable_dbl"] != 1:
            rec = AN.deblock_frame(*rec, ctx)
        frame = tuple(np.asarray(pl, np.uint8) for pl in rec)
        self._order.append((pic.get("epoch", 0), pic["poc"]))
        if pic["ref_idc"] != 0:
            frame_num = pic["frame_num"]
            max_fn = 1 << sps["log2_max_frame_num"]

            def picnum(fn):
                return fn if fn <= frame_num else fn - max_fn

            entry = dict(fn=frame_num, poc=pic["poc"], frame=frame,
                         rp=INTER.RefPlanes(*rec), mv=pic["mv"],
                         ref=pic.get("col_ref", pic["ref"]),
                         ref_poc=pic.get("ref_poc"))
            entry["long"] = False
            entry["lt_idx"] = -1
            if pic.get("idr_lt"):
                entry["long"] = True
                entry["lt_idx"] = 0
                self._max_lt_idx = 0
            if pic.get("mmco"):
                # spec 8.2.5.4 adaptive marking (ops 1..6)
                for op in pic["mmco"]:
                    if op[0] == 1:
                        pic_num_x = frame_num - (op[1] + 1)
                        self.dpb = [e for e in self.dpb
                                    if e["long"] or
                                    picnum(e["fn"]) != pic_num_x]
                    elif op[0] == 2:        # unmark LongTermPicNum
                        self.dpb = [e for e in self.dpb
                                    if not (e["long"]
                                            and e["lt_idx"] == op[1])]
                    elif op[0] == 3:        # short-term -> long-term
                        pic_num_x = frame_num - (op[1] + 1)
                        self.dpb = [e for e in self.dpb
                                    if not (e["long"]
                                            and e["lt_idx"] == op[2])]
                        for e in self.dpb:
                            if not e["long"] and picnum(e["fn"]) == pic_num_x:
                                e["long"] = True
                                e["lt_idx"] = op[2]
                    elif op[0] == 4:        # MaxLongTermFrameIdx = val - 1
                        self._max_lt_idx = op[1] - 1
                        self.dpb = [e for e in self.dpb
                                    if not e["long"]
                                    or e["lt_idx"] <= self._max_lt_idx]
                    elif op[0] == 6:        # current -> long-term
                        self.dpb = [e for e in self.dpb
                                    if not (e["long"]
                                            and e["lt_idx"] == op[1])]
                        entry["long"] = True
                        entry["lt_idx"] = op[1]
                    elif op[0] == 5:
                        self.dpb = []
                        self._max_lt_idx = -1
                self.dpb.append(entry)
            else:
                self.dpb.append(entry)
                max_refs = max(sps["num_ref_frames"], 1)
                if len(self.dpb) > max_refs:
                    # evict smallest-FrameNumWrap SHORT-TERM picture
                    # (8.2.5.3; long-term pictures are never aged out)
                    st = [e for e in self.dpb if not e["long"]]
                    if st:
                        st.sort(key=lambda e: picnum(e["fn"]))
                        self.dpb.remove(st[0])
                    else:
                        self.dpb.pop(0)
        return crop_window(frame, sps["crop"])

    def _peek_redundant(self, rbsp: bytes, idr: bool):
        """Parse just enough of a slice header to learn
        (first_mb_in_slice, redundant_pic_cnt) without touching decoder
        state (spec 7.3.3 field order up to redundant_pic_cnt)."""
        r = BitReader(rbsp)
        first_mb = r.ue()
        r.ue()                              # slice_type
        pps = self.pps[r.ue()]
        sps = self.sps[pps["sps_id"]]
        fn = r.u(sps["log2_max_frame_num"])
        if not pps["redundant_pic_cnt"]:
            return first_mb, 0, fn
        if idr:
            r.ue()                          # idr_pic_id
        if sps["poc_type"] == 0:
            r.u(sps["log2_max_poc_lsb"])
            if pps["pic_order_present"]:
                r.se()
        elif sps["poc_type"] == 1 and not sps["delta_poc_always_zero"]:
            r.se()
            if pps["pic_order_present"]:
                r.se()
        return first_mb, r.ue(), fn

    def _decode_slice(self, rbsp: bytes, idr: bool, ref_idc: int,
                      dp=None):
        """Decode one slice; returns a finished frame when this slice
        starts a new picture (the previous picture completes), else None.

        ``dp``: (rbsp_b, rbsp_c) when ``rbsp`` is a partition-A NAL
        (type 2, spec 7.4.1) — the slice header + category-2 syntax read
        from A, intra residual from B (type 3), inter residual from C
        (type 4); each of B/C opens with its own slice_id (JM ldecod
        image.c:1634 read_new_slice DP handling)."""
        r = BitReader(rbsp)
        first_mb = self._tr(r, "first_mb_in_slice", r.ue())
        slice_type = self._tr(r, "slice_type", r.ue()) % 5
        if slice_type not in (0, 1, 2):
            raise NotImplementedError(f"slice_type {slice_type}")
        pps = self.pps[r.ue()]
        sps = self.sps[pps["sps_id"]]
        W, H = sps["width"], sps["height"]
        mb_w, mb_h = W // 16, H // 16
        frame_num = r.u(sps["log2_max_frame_num"])

        done = None
        if first_mb == 0:
            done = self._finish_picture()
            self._cov = set()               # slice coverage of this picture
            self._cov_fn = frame_num
        self._cov = getattr(self, "_cov", set())
        self._cov.add(first_mb)
        if idr:
            r.ue()                          # idr_pic_id
            if first_mb == 0:
                self.dpb = []
                self._idr_epoch = getattr(self, "_idr_epoch", 0) + 1
        poc = 2 * frame_num                 # poc_type 2 approximation
        if sps["poc_type"] == 0:
            lsb = r.u(sps["log2_max_poc_lsb"])
            if pps["pic_order_present"]:
                r.se()
            # spec 8.2.1.1 PicOrderCntMsb tracking
            max_lsb = 1 << sps["log2_max_poc_lsb"]
            if idr and first_mb == 0:
                self._prev_poc_lsb = self._prev_poc_msb = 0
                msb = 0
            else:
                if (lsb < self._prev_poc_lsb
                        and self._prev_poc_lsb - lsb >= max_lsb // 2):
                    msb = self._prev_poc_msb + max_lsb
                elif (lsb > self._prev_poc_lsb
                      and lsb - self._prev_poc_lsb > max_lsb // 2):
                    msb = self._prev_poc_msb - max_lsb
                else:
                    msb = self._prev_poc_msb
            poc = msb + lsb
            if ref_idc != 0:
                self._prev_poc_lsb, self._prev_poc_msb = lsb, msb
        elif sps["poc_type"] == 1:          # spec 8.2.1.2 (frame coding)
            d0 = d1 = 0
            if not sps["delta_poc_always_zero"]:
                d0 = r.se()
                if pps["pic_order_present"]:
                    d1 = r.se()
            max_fn = 1 << sps["log2_max_frame_num"]
            if idr and first_mb == 0:
                fno = 0
            elif getattr(self, "_prev_frame_num1", 0) > frame_num:
                fno = getattr(self, "_prev_fno", 0) + max_fn
            else:
                fno = getattr(self, "_prev_fno", 0)
            if first_mb == 0:
                self._prev_fno = fno
                self._prev_frame_num1 = frame_num
            offs = sps["offsets_for_ref_frame"]
            ncyc = len(offs)
            abs_fn = fno + frame_num if ncyc else 0
            if ref_idc == 0 and abs_fn > 0:
                abs_fn -= 1
            if abs_fn > 0:
                cyc, inc = divmod(abs_fn - 1, ncyc)
                expected = cyc * sum(offs) + sum(offs[:inc + 1])
            else:
                expected = 0
            if ref_idc == 0:
                expected += sps["offset_for_non_ref_pic"]
            top = expected + d0
            bottom = top + sps["offset_for_top_to_bottom_field"] + d1
            poc = min(top, bottom)
        if pps["redundant_pic_cnt"]:
            self._tr(r, "redundant_pic_cnt", r.ue())
        direct_spatial = True
        if slice_type == 1:
            direct_spatial = bool(r.u(1))   # else temporal (8.4.1.2.3)
        num_ref = pps["num_ref_idx_l0"]
        num_ref_l1 = pps["num_ref_idx_l1"]
        reorder_ops = []
        reorder_ops_l1 = []
        if slice_type in (0, 1):
            if r.u(1):                      # override flag
                num_ref = r.ue() + 1
                if slice_type == 1:
                    num_ref_l1 = r.ue() + 1
            if r.u(1):                      # ref_pic_list_modification_l0
                while True:
                    op = self._tr(r, "modification_of_pic_nums_idc", r.ue())
                    if op == 3:
                        break
                    if op in (0, 1, 2, 4, 5):
                        # 0/1 picNum, 2 LongTermPicNum, 4/5 inter-view
                        # (MVC H.7.3.3.1.1 abs_diff_view_idx)
                        reorder_ops.append((op, r.ue()))
                    else:
                        raise ValueError(f"modification idc {op}")
            if slice_type == 1 and r.u(1):
                while True:                 # ref_pic_list_modification_l1
                    op = self._tr(r, "modification_of_pic_nums_idc_l1",
                                  r.ue())
                    if op == 3:
                        break
                    if op in (0, 1, 2):
                        reorder_ops_l1.append((op, r.ue()))
                    else:
                        raise ValueError(f"modification idc {op}")
        wp = None
        if (slice_type == 0 and pps["weighted_pred"]) or \
                (slice_type == 1 and pps["weighted_bipred_idc"] == 1):
            # pred_weight_table (spec 7.3.3.2, explicit WP)
            d_l = self._tr(r, "luma_log2_weight_denom", r.ue())
            d_c = self._tr(r, "chroma_log2_weight_denom", r.ue())
            wp = dict(d_l=d_l, d_c=d_c, l0=[], l1=[])
            for key, count in (("l0", num_ref),
                               ("l1", num_ref_l1 if slice_type == 1 else 0)):
                for _ in range(count):
                    wy, oy = 1 << d_l, 0
                    if r.u(1):                       # luma_weight_flag
                        wy = r.se()
                        oy = r.se()
                    wu = wv = 1 << d_c
                    ou = ov = 0
                    if r.u(1):                       # chroma_weight_flag
                        wu, ou = r.se(), r.se()
                        wv, ov = r.se(), r.se()
                    wp[key].append((wy, oy, wu, ou, wv, ov))
        elif slice_type == 1 and pps["weighted_bipred_idc"] == 2:
            # implicit weighted bipred: weights derived per ref pair
            # from POC distances at MC time (spec 8.4.2.3.1)
            wp = dict(implicit=True, poc=poc)
        mmco_ops = []
        idr_long_term = False
        if ref_idc != 0:
            if idr:
                r.u(1)                      # no_output_of_prior_pics
                idr_long_term = bool(r.u(1))
            else:
                if r.u(1):                  # adaptive_ref_pic_marking
                    while True:
                        op = self._tr(r, "mmco", r.ue())
                        if op == 0:
                            break
                        if op == 1:         # short-term -> unused
                            mmco_ops.append((1, r.ue()))
                        elif op == 2:       # long-term -> unused
                            mmco_ops.append((2, r.ue()))
                        elif op == 3:       # short-term -> long-term idx
                            mmco_ops.append((3, r.ue(), r.ue()))
                        elif op == 4:       # max_long_term_frame_idx_plus1
                            mmco_ops.append((4, r.ue()))
                        elif op == 6:       # current -> long-term idx
                            mmco_ops.append((6, r.ue()))
                        elif op == 5:       # clear all
                            mmco_ops.append((5,))
                        else:
                            raise NotImplementedError(f"MMCO op {op}")
        cabac_init_idc = 0
        if pps["cabac"] and slice_type != 2:
            cabac_init_idc = r.ue()
        qp = pps["pic_init_qp"] + self._tr(r, "slice_qp_delta", r.se())
        disable_dbl = 0
        a_off = b_off = 0
        if pps["deblock_ctrl"]:
            disable_dbl = r.ue()
            if disable_dbl != 1:
                a_off = r.se() * 2
                b_off = r.se() * 2
        change_cycle = 0
        if pps["slice_groups"] > 1 and pps["sg_map_type"] in (3, 4, 5):
            pic_size = mb_w * mb_h
            rate = pps["sg_change_rate"]
            bits = max(int(np.ceil(np.log2(pic_size // rate + 1))), 1)
            change_cycle = self._tr(r, "slice_group_change_cycle",
                                    r.u(bits))

        if self._pic is None:
            self._pic = dict(
                sps=sps, pps=pps, mb_w=mb_w, mb_h=mb_h, qp=qp,
                epoch=getattr(self, "_idr_epoch", 0),
                idr_lt=idr and idr_long_term,
                mmco=mmco_ops, poc=poc, is_b=slice_type == 1,
                frame_num=frame_num, ref_idc=ref_idc,
                disable_dbl=disable_dbl, a_off=a_off, b_off=b_off,
                rec=(np.zeros((H, W), np.int64),
                     np.zeros((H // 2, W // 2), np.int64),
                     np.zeros((H // 2, W // 2), np.int64)),
                nnz=np.zeros((mb_h * 4, mb_w * 4), np.int64),
                mv=np.zeros((mb_h * 4, mb_w * 4, 2), np.int64),
                ref=np.zeros((mb_h * 4, mb_w * 4), np.int64),
                mv1=np.zeros((mb_h * 4, mb_w * 4, 2), np.int64),
                ref1=np.full((mb_h * 4, mb_w * 4), -1, np.int64),
                mb_intra=np.zeros((mb_h, mb_w), bool),
                decoded=np.zeros((mb_h, mb_w), bool),
                erc_ref=None,
                transform8=np.zeros((mb_h, mb_w), bool),
                mb_qp=np.full((mb_h, mb_w), qp, np.int64))
        pic = self._pic

        # reference list 0: decreasing PicNum with FrameNumWrap (spec 8.2.4.1:
        # FrameNumWrap = frame_num - MaxFrameNum when frame_num > CurrFrameNum;
        # JM ldecod mbuffer.c init_lists semantics)
        max_fn = 1 << sps["log2_max_frame_num"]

        def picnum(fn):
            return fn if fn <= frame_num else fn - max_fn

        short = [e for e in self.dpb if not e.get("long")]
        lterm = sorted([e for e in self.dpb if e.get("long")],
                       key=lambda e: e["lt_idx"])
        entries = sorted(short, key=lambda e: -picnum(e["fn"])) + lterm
        iv = self._inter_view_entry
        if iv is not None and slice_type == 0:
            # MVC inter-view reference: appended AFTER the temporal refs
            # in RefPicList0 (spec H.8.2.1)
            entries = entries + [iv]
        refs1 = []
        col = None
        if slice_type == 1:
            before = sorted([e for e in short if e["poc"] < poc],
                            key=lambda e: -e["poc"])
            after = sorted([e for e in short if e["poc"] >= poc],
                           key=lambda e: e["poc"])
            entries = before + after + lterm
            l1 = after + before + lterm
            refs1 = l1[:num_ref_l1]
            # spec 8.2.4.2.3: when RefPicList1 would be identical to
            # RefPicList0 and has more than one entry (e.g. low-delay B
            # with all DPB refs on one POC side), swap its first two
            if len(refs1) > 1 and refs1 == entries[:num_ref]:
                refs1[0], refs1[1] = refs1[1], refs1[0]
            col = refs1[0] if refs1 else None
        def apply_reorder(lst, ops):
            # spec 8.2.4.3.1/8.2.4.3.2 modification processes
            max_pic_num = max_fn
            pic_num_pred = frame_num
            idx = 0
            lst = list(lst)
            for op, d in ops:
                if op in (4, 5):            # MVC inter-view ref (H.8.2.2.3)
                    iv2 = self._inter_view_entry
                    assert iv2 is not None, "inter-view op without ref"
                    if iv2 in lst:
                        lst.remove(iv2)
                    lst.insert(idx, iv2)
                    idx += 1
                    continue
                if op == 2:                 # long-term: LongTermPicNum
                    match = [e for e in lst
                             if e.get("long") and e.get("lt_idx") == d]
                    assert match, "LT reorder target not in DPB"
                    lst.remove(match[0])
                    lst.insert(idx, match[0])
                    idx += 1
                    continue
                if op == 0:
                    pic_num_no_wrap = pic_num_pred - (d + 1)
                    if pic_num_no_wrap < 0:
                        pic_num_no_wrap += max_pic_num
                else:
                    pic_num_no_wrap = pic_num_pred + (d + 1)
                    if pic_num_no_wrap >= max_pic_num:
                        pic_num_no_wrap -= max_pic_num
                pic_num_pred = pic_num_no_wrap
                pic_num = pic_num_no_wrap
                if pic_num > frame_num:
                    pic_num -= max_pic_num
                match = [e for e in lst
                         if not e.get("long") and picnum(e["fn"]) == pic_num]
                assert match, "reorder target not in DPB"
                lst.remove(match[0])
                lst.insert(idx, match[0])
                idx += 1
            return lst

        if reorder_ops:
            entries = apply_reorder(entries, reorder_ops)
        if reorder_ops_l1 and slice_type == 1:
            l1r = apply_reorder(l1, reorder_ops_l1)
            refs1 = l1r[:num_ref_l1]
            col = refs1[0] if refs1 else None
        refs = entries[:num_ref] if slice_type == 1 else entries

        gmap = None
        mb_seq = None
        if pps["slice_groups"] > 1:
            gmap = _slice_group_map(pps, mb_w, mb_h, change_cycle)
            grp = int(gmap[first_mb])
            mb_seq = [i for i in np.flatnonzero(gmap == grp)
                      if i >= first_mb]
        r_b = r_c = None
        if dp is not None:
            if pps["cabac"]:
                raise ValueError("data partitioning requires CAVLC")
            slice_id = self._tr(r, "slice_id", r.ue())
            readers = []
            for part in dp:                  # (rbsp_b, rbsp_c)
                if part is None:
                    readers.append(None)
                    continue
                pr = BitReader(part)
                assert pr.ue() == slice_id, "DP slice_id mismatch"
                if pps["redundant_pic_cnt"]:
                    pr.ue()
                readers.append(pr)
            r_b, r_c = readers
        dec = _SliceDecoder(self, sps, pps, slice_type, qp, refs, r,
                            mb_w, mb_h, num_ref, first_mb=first_mb, pic=pic,
                            rbsp=rbsp, cabac_init_idc=cabac_init_idc,
                            refs1=refs1, num_ref_l1=num_ref_l1, col=col,
                            wp=wp, direct_spatial=direct_spatial,
                            gmap=gmap, mb_seq=mb_seq, r_b=r_b, r_c=r_c)
        dec.run()
        return done


class _SliceDecoder:
    def __init__(self, top, sps, pps, slice_type, qp, refs, r, mb_w, mb_h,
                 num_ref=1, first_mb=0, pic=None, rbsp=None,
                 cabac_init_idc=0, refs1=None, num_ref_l1=1, col=None,
                 wp=None, direct_spatial=True, gmap=None, mb_seq=None,
                 r_b=None, r_c=None):
        self.top = top
        # data partitioning (spec 7.4.1, NAL 2/3/4): category-2 syntax
        # reads from ``r`` (partition A), intra residual from B, inter
        # residual from C; without DP all three are the same reader
        self.r_b = r_b if r_b is not None else r
        self.r_c = r_c if r_c is not None else r
        self.wp = wp
        self.direct_spatial = direct_spatial
        self.gmap = gmap                    # FMO slice-group map (flat)
        self.mb_seq = mb_seq                # this slice's MB decode order
        # refs arrive as DPB entry dicts (or bare RefPlanes in legacy use)
        self.ref_entries = refs
        refs = [e["rp"] if isinstance(e, dict) else e for e in refs]
        self.refs1_entries = refs1 or []
        self.refs1 = [e["rp"] for e in self.refs1_entries]
        self.num_ref_l1 = num_ref_l1
        self.col = col
        self.mvf1 = INTER.MVField(mb_h, mb_w)
        self.sps, self.pps = sps, pps
        self.slice_type = slice_type
        self.qp = qp
        self.num_ref = num_ref
        self.refs = refs
        self.r = r
        self.mb_w, self.mb_h = mb_w, mb_h
        self.first_mb = first_mb
        self.pic = pic
        W, H = mb_w * 16, mb_h * 16
        if pic is not None:
            # shared picture state; slice-restricted availability guards
            # (spec 6.4.11) keep cross-slice values unread
            self.rec_y, self.rec_u, self.rec_v = pic["rec"]
            self.st_nnz = pic["nnz"]
            self.mb_intra = pic["mb_intra"]
            self.mb_qp = pic["mb_qp"]
        else:
            self.rec_y = np.zeros((H, W), np.int64)
            self.rec_u = np.zeros((H // 2, W // 2), np.int64)
            self.rec_v = np.zeros((H // 2, W // 2), np.int64)
            self.st_nnz = np.zeros((mb_h * 4, mb_w * 4), np.int64)
            self.mb_intra = np.zeros((mb_h, mb_w), bool)
            self.mb_qp = np.full((mb_h, mb_w), qp, np.int64)
        self.nnz_c = np.zeros((2, mb_h * 2, mb_w * 2), np.int64)
        self.qmat = QM.resolve_qmatrix(sps.get("seq_scaling"),
                                       pps.get("pic_scaling"))
        self.transform8 = pic["transform8"] if pic is not None else \
            np.zeros((mb_h, mb_w), bool)
        self.i4_modes = np.full((mb_h * 4, mb_w * 4), -1, np.int64)
        self.mvf = INTER.MVField(mb_h, mb_w)
        # last set bit == rbsp_stop_one_bit; data remains while pos < it
        self._stop = int(np.flatnonzero(r._bits)[-1])
        self.cabac = bool(pps["cabac"])
        if self.cabac:
            while r.pos % 8:                    # cabac_alignment_one_bit
                r.u(1)
            self.cst = CB.MBState(mb_w, mb_h)
            self.cst.first_mb = first_mb
            self.crd = CB.CabacReader(bytes(rbsp[r.pos // 8:]),
                                      slice_type, qp, self.cst,
                                      cabac_init_idc)
            self.CB = CB

    def _mb_ok(self, mby, mbx):
        """Same-slice availability of a causal neighbor MB (spec 6.4.11;
        with FMO the neighbor must share this slice's group)."""
        mb = mby * self.mb_w + mbx
        if self.gmap is not None and \
                self.gmap[mb] != self.gmap[self.first_mb]:
            return False
        return mb >= self.first_mb

    # --- weighted dequantization (High scaling lists; flat -> the
    # JM-exact fast paths in avc/quant.py) ---
    def _dq4(self, lev, qp, intra: bool, ci=None):
        if self.qmat is None:
            return Q.dequant4x4(lev, qp)
        li = (0 if intra else 3) + (0 if ci is None else 1 + ci)
        return QM.dequant4x4_w(lev, qp, self.qmat[li])

    def _dqdc16(self, lev, qp):
        if self.qmat is None:
            return Q.dequant_dc16(lev, qp)
        return QM.dequant_dc16_w(lev, qp, self.qmat[0])

    def _dqdcc(self, lev, qpc, intra: bool, ci: int):
        if self.qmat is None:
            return Q.dequant_dc_chroma(lev, qpc)
        return QM.dequant_dc_chroma_w(lev, qpc,
                                      self.qmat[(1 if intra else 4) + ci])

    def _dq8(self, lev, qp, intra: bool):
        if self.qmat is None:
            return Q8.dequant8x8(lev, qp)
        return QM.dequant8x8_w(lev, qp, self.qmat[6 if intra else 7])

    # --- nC contexts (same derivation as the encoder) ---
    def _nc_luma(self, by, bx):
        has_a = bx > 0 and self._mb_ok(by // 4, (bx - 1) // 4)
        has_b = by > 0 and self._mb_ok((by - 1) // 4, bx // 4)
        na = int(self.st_nnz[by, bx - 1]) if has_a else 0
        nb = int(self.st_nnz[by - 1, bx]) if has_b else 0
        if has_a and has_b:
            return (na + nb + 1) >> 1
        return na if has_a else (nb if has_b else 0)

    def _nc_chroma(self, comp, by, bx):
        has_a = bx > 0 and self._mb_ok(by // 2, (bx - 1) // 2)
        has_b = by > 0 and self._mb_ok((by - 1) // 2, bx // 2)
        na = int(self.nnz_c[comp, by, bx - 1]) if has_a else 0
        nb = int(self.nnz_c[comp, by - 1, bx]) if has_b else 0
        if has_a and has_b:
            return (na + nb + 1) >> 1
        return na if has_a else (nb if has_b else 0)

    def run(self):
        if self.cabac:
            return self._run_cabac()
        n_mb = self.mb_w * self.mb_h
        seq = self.mb_seq if self.mb_seq is not None else \
            range(self.first_mb, n_mb)
        seq = list(seq)
        i = 0
        r = self.r
        while i < len(seq) and r.pos < self._stop:
            if self.slice_type in (0, 1):
                skip_run = self.top._tr(r, "mb_skip_run", r.ue())
                for _ in range(skip_run):
                    if self.slice_type == 1:
                        self._decode_b_direct(seq[i], skip=True)
                    else:
                        self._decode_skip(seq[i])
                    self._mark_decoded(seq[i])
                    i += 1
                if i >= len(seq) or r.pos >= self._stop:
                    break
            if self.slice_type == 1:
                self._decode_b_mb(seq[i])
            else:
                self._decode_mb(seq[i])
            self._mark_decoded(seq[i])
            i += 1
        return self._finish_slice()

    def _mark_decoded(self, mb):
        if self.pic is not None:
            self.pic["decoded"][mb // self.mb_w, mb % self.mb_w] = True
            if self.refs and self.slice_type != 2:
                self.pic["erc_ref"] = self.refs[0]

    def _finish_slice(self):
        if self.pic is not None:
            # merge this slice's MV field into the picture (deblock ctx)
            d = self.mvf.decoded
            if self.slice_type == 1:
                # B: translate list indices to picture POC ids (bS compares
                # reference pictures) and merge both lists
                ref_ids = np.full_like(self.mvf.ref, -1)
                for i, e in enumerate(self.ref_entries):
                    ref_ids[self.mvf.ref == i] = e["poc"]
                self.pic["mv"][d] = self.mvf.mv[d]
                self.pic["ref"][d] = ref_ids[d]
                self.pic.setdefault(
                    "ref_poc", np.full_like(self.mvf.ref, -1))[d] = \
                    ref_ids[d]
                # colocated data for later direct derivation keeps LIST
                # indices (refIdxCol semantics), not the POC ids the
                # deblock ctx wants — a reference B in the DPB (hier-B)
                # must expose its l0 indices to spatial direct
                self.pic.setdefault(
                    "col_ref", np.full_like(self.mvf.ref, -1))[d] = \
                    self.mvf.ref[d]
                d1 = self.mvf1.decoded
                ref1_ids = np.full_like(self.mvf1.ref, -1)
                for i, e in enumerate(self.refs1_entries):
                    ref1_ids[self.mvf1.ref == i] = e["poc"]
                self.pic["mv1"][d1] = self.mvf1.mv[d1]
                self.pic["ref1"][d1] = ref1_ids[d1]
            else:
                self.pic["mv"][d] = self.mvf.mv[d]
                self.pic["ref"][d] = self.mvf.ref[d]
                ref_pocs = np.full_like(self.mvf.ref, -1)
                for i, e in enumerate(self.ref_entries):
                    if isinstance(e, dict):
                        ref_pocs[self.mvf.ref == i] = e["poc"]
                self.pic.setdefault(
                    "ref_poc", np.full_like(self.mvf.ref, -1))[d] = \
                    ref_pocs[d]
        return self.rec_y, self.rec_u, self.rec_v

    def _run_cabac(self):
        n_mb = self.mb_w * self.mb_h
        seq = self.mb_seq if self.mb_seq is not None else \
            range(self.first_mb, n_mb)
        for mb in seq:
            self._decode_mb_cabac(mb)
            self._mark_decoded(mb)
            if self.crd.end_of_slice():
                break
        return self._finish_slice()

    # ------------------------------------------------------------------
    def _decode_skip(self, mb):
        mby, mbx = mb // self.mb_w, mb % self.mb_w
        by, bx = mby * 4, mbx * 4
        mv = self.mvf.skip_mv(by, bx)
        self._mc_inter(mby, mbx, [((0, 0, 4, 4), mv, 0)])
        self.mvf.set_partition(by, bx, 4, 4, mv, 0)
        self.st_nnz[by:by + 4, bx:bx + 4] = 0
        self.nnz_c[:, mby * 2:mby * 2 + 2, mbx * 2:mbx * 2 + 2] = 0
        self.mb_qp[mby, mbx] = self._prev_qp(mb)

    def _mc_inter(self, mby, mbx, parts):
        """parts: list of ((dy4, dx4, w4, h4), mv, ref_idx) in 4x4 units
        relative to the MB; performs luma + chroma MC into the recon
        (explicit WP applied when the slice carries a weight table)."""
        y0, x0 = mby * 16, mbx * 16
        for (dy4, dx4, w4, h4), mv, ri in parts:
            ref = self.refs[ri]
            py, px = y0 + dy4 * 4, x0 + dx4 * 4
            cy, cx = py // 2, px // 2
            ch, cw = h4 * 2, w4 * 2
            pl, pu, pv = self._wp_apply(
                (ref.luma_block(py, px, h4 * 4, w4 * 4,
                                int(mv[0]), int(mv[1])),
                 ref.chroma_block("u", cy, cx, ch, cw,
                                  int(mv[0]), int(mv[1])),
                 ref.chroma_block("v", cy, cx, ch, cw,
                                  int(mv[0]), int(mv[1]))), 0, ri)
            self.rec_y[py:py + h4 * 4, px:px + w4 * 4] = pl
            self.rec_u[cy:cy + ch, cx:cx + cw] = pu
            self.rec_v[cy:cy + ch, cx:cx + cw] = pv

    def _wp_apply(self, planes, lst, ri):
        """Spec 8.4.2.3.2 unidirectional explicit WP of (Y, U, V)."""
        if self.wp is None or self.wp.get("implicit"):
            return planes          # implicit mode: uni-pred unweighted
        e = (self.wp["l1"] if lst else self.wp["l0"])[ri]
        d_l, d_c = self.wp["d_l"], self.wp["d_c"]
        out = []
        for pl, w_, o_, d in ((planes[0], e[0], e[1], d_l),
                              (planes[1], e[2], e[3], d_c),
                              (planes[2], e[4], e[5], d_c)):
            if d > 0:
                v = ((pl * w_ + (1 << (d - 1))) >> d) + o_
            else:
                v = pl * w_ + o_
            out.append(np.clip(v, 0, 255))
        return tuple(out)

    def _wp_combine(self, acc):
        """acc: [(lst, ri, (pl, pu, pv))] of 1 or 2 prediction legs ->
        final planes (spec 8.4.2.3: default average or explicit WP)."""
        if len(acc) == 1:
            lst, ri, pls = acc[0]
            return self._wp_apply(pls, lst, ri)
        if self.wp is None:
            return tuple((a + b + 1) >> 1
                         for a, b in zip(acc[0][2], acc[1][2]))
        if self.wp.get("implicit"):
            # spec 8.4.2.3.1: w1 = DistScaleFactor >> 2 from the POC
            # distances of the two reference pictures, w0 = 64 - w1;
            # defaults 32/32 on td == 0, long-term refs, or range
            # violations (JM ldecod weighted_prediction.c compute_
            # colocated/implicit shapes)
            e0 = self.ref_entries[acc[0][1]]
            e1 = self.refs1_entries[acc[1][1]]
            poc_cur = self.wp["poc"]
            w0, w1 = 32, 32
            td = min(max(e1["poc"] - e0["poc"], -128), 127)
            if td != 0 and not e0.get("long") and not e1.get("long"):
                tb = min(max(poc_cur - e0["poc"], -128), 127)
                tx = (16384 + abs(td) // 2) // td
                dsf = min(max((tb * tx + 32) >> 6, -1024), 1023)
                if -64 <= dsf >> 2 <= 128:
                    w1 = dsf >> 2
                    w0 = 64 - w1
            return tuple(
                np.clip((a * w0 + b * w1 + 32) >> 6, 0, 255)
                for a, b in zip(acc[0][2], acc[1][2]))
        e0 = self.wp["l0"][acc[0][1]]
        e1 = self.wp["l1"][acc[1][1]]
        d_l, d_c = self.wp["d_l"], self.wp["d_c"]
        out = []
        for i, d in ((0, d_l), (1, d_c), (2, d_c)):
            w0, o0 = e0[2 * i], e0[2 * i + 1]
            w1, o1 = e1[2 * i], e1[2 * i + 1]
            v = ((acc[0][2][i] * w0 + acc[1][2][i] * w1 + (1 << d))
                 >> (d + 1)) + ((o0 + o1 + 1) >> 1)
            out.append(np.clip(v, 0, 255))
        return tuple(out)

    # ------------------------------------------------------------------
    def _decode_mb(self, mb):
        r = self.r
        mby, mbx = mb // self.mb_w, mb % self.mb_w
        by, bx = mby * 4, mbx * 4
        mb_type = self.top._tr(r, "mb_type", r.ue())
        p_slice = self.slice_type == 0
        if p_slice and mb_type >= 5:
            intra_type = mb_type - 5
        elif not p_slice:
            intra_type = mb_type
        else:
            intra_type = None

        if intra_type is not None:
            self._decode_intra_mb(mby, mbx, intra_type)
            self.mvf.set_partition(by, bx, 4, 4, np.zeros(2, np.int64), -1)
            self.mb_intra[mby, mbx] = True
            return

        self.mb_intra[mby, mbx] = False
        num_ref = self.num_ref
        parts = []        # ((dy4,dx4,w4,h4), mv, ref)
        if mb_type == 0:          # 16x16
            ri = self.top._tr(r, "ref_idx_l0",
                              _te(r, num_ref - 1) if num_ref > 1 else 0)
            pmv = self.mvf.predict(by, bx, 4, 4, ri)
            mv = pmv + np.array([self.top._tr(r, "mvd_l0_x", r.se()),
                                 self.top._tr(r, "mvd_l0_y", r.se())],
                                np.int64)
            self.mvf.set_partition(by, bx, 4, 4, mv, ri)
            parts = [((0, 0, 4, 4), mv, ri)]
        elif mb_type in (1, 2):   # 16x8 / 8x16
            geo = ([((0, 0, 4, 2), "16x8_top"), ((2, 0, 4, 2), "16x8_bot")]
                   if mb_type == 1 else
                   [((0, 0, 2, 4), "8x16_left"), ((0, 2, 2, 4), "8x16_right")])
            ris = [(_te(r, num_ref - 1) if num_ref > 1 else 0) for _ in range(2)]
            for ((dy4, dx4, w4, h4), tag), ri in zip(geo, ris):
                pmv = self.mvf.predict(by + dy4, bx + dx4, w4, h4, ri, tag)
                mv = pmv + np.array([r.se(), r.se()], np.int64)
                self.mvf.set_partition(by + dy4, bx + dx4, w4, h4, mv, ri)
                parts.append(((dy4, dx4, w4, h4), mv, ri))
        elif mb_type in (3, 4):   # P8x8 / P8x8ref0
            subs = [r.ue() for _ in range(4)]
            if any(s > 3 for s in subs):
                raise ValueError("bad sub_mb_type")
            ris = []
            for b8 in range(4):
                if mb_type == 3 and num_ref > 1:
                    ris.append(_te(r, num_ref - 1))
                else:
                    ris.append(0)
            for b8 in range(4):
                dy8, dx8 = (b8 >> 1) * 2, (b8 & 1) * 2
                sub = subs[b8]
                geo = {0: [(0, 0, 2, 2)],
                       1: [(0, 0, 2, 1), (1, 0, 2, 1)],
                       2: [(0, 0, 1, 2), (0, 1, 1, 2)],
                       3: [(0, 0, 1, 1), (0, 1, 1, 1),
                           (1, 0, 1, 1), (1, 1, 1, 1)]}[sub]
                for (sy, sx, w4, h4) in geo:
                    pby, pbx = by + dy8 + sy, bx + dx8 + sx
                    pmv = self.mvf.predict(pby, pbx, w4, h4, ris[b8])
                    mv = pmv + np.array([r.se(), r.se()], np.int64)
                    self.mvf.set_partition(pby, pbx, w4, h4, mv, ris[b8])
                    parts.append(((dy8 + sy, dx8 + sx, w4, h4), mv, ris[b8]))
        else:
            raise NotImplementedError(f"P mb_type {mb_type}")

        self._mc_inter(mby, mbx, parts)

        cbp = int(CODENUM_TO_CBP_INTER[
            self.top._tr(r, "coded_block_pattern", r.ue())])
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        t8 = False
        no_small = mb_type in (0, 1, 2) or \
            (mb_type in (3, 4) and all(s == 0 for s in subs))
        if cbp_luma > 0 and self.pps["transform_8x8"] and no_small:
            t8 = bool(self.top._tr(r, "transform_size_8x8_flag", r.u(1)))
        self.transform8[mby, mbx] = t8
        qp = self._prev_qp(mby * self.mb_w + mbx)
        if cbp > 0:
            qp = (qp + self.top._tr(r, "mb_qp_delta", r.se()) + 52) % 52
        self.mb_qp[mby, mbx] = qp
        if t8:
            self._decode_residual_luma8(mby, mbx, cbp_luma, qp)
        else:
            self._decode_residual_luma(mby, mbx, cbp_luma, qp,
                                       intra16=False)
        self._decode_residual_chroma(mby, mbx, cbp_chroma, qp,
                                     intra=False)

    def _prev_qp(self, mb):
        if mb == self.first_mb:
            return self.qp
        pm_by, pm_bx = (mb - 1) // self.mb_w, (mb - 1) % self.mb_w
        return int(self.mb_qp[pm_by, pm_bx])

    # ------------------------------------------------------------------
    def _decode_intra_mb(self, mby, mbx, intra_type):
        r = self.r
        by, bx = mby * 4, mbx * 4
        if intra_type == 0 and self.pps["transform_8x8"] and \
                r.u(1):                      # transform_size_8x8_flag
            self._decode_intra8x8_mb(mby, mbx)
            return
        if intra_type == 0:                  # I4x4
            modes = np.zeros(16, np.int64)
            for k in range(16):
                y4, x4 = int(BLOCK_SCAN[k][0]), int(BLOCK_SCAN[k][1])
                bby, bbx = by + y4, bx + x4
                avail_l = bbx > 0 and self._mb_ok(bby // 4, (bbx - 1) // 4)
                avail_t = bby > 0 and self._mb_ok((bby - 1) // 4, bbx // 4)
                ma = int(self.i4_modes[bby, bbx - 1]) if avail_l else -2
                mb_ = int(self.i4_modes[bby - 1, bbx]) if avail_t else -2
                if ma == -2 or mb_ == -2:
                    mpm = 2
                else:
                    mpm = min(ma if ma >= 0 else 2, mb_ if mb_ >= 0 else 2)
                if r.u(1):
                    m = mpm
                else:
                    rem = r.u(3)
                    m = rem + (1 if rem >= mpm else 0)
                modes[k] = m
                self.i4_modes[bby, bbx] = m
            ch_mode = r.ue()
            cbp = int(CODENUM_TO_CBP_INTRA[r.ue()])
            cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
            qp = self._prev_qp(mby * self.mb_w + mbx)
            if cbp > 0:
                qp = (qp + r.se() + 52) % 52
            self.mb_qp[mby, mbx] = qp
            # parse + reconstruct block by block in coding order
            zzs = np.zeros((16, 16), np.int64)
            for k in range(16):
                y4, x4 = int(BLOCK_SCAN[k][0]), int(BLOCK_SCAN[k][1])
                bby, bbx = by + y4, bx + x4
                b8 = (y4 // 2) * 2 + (x4 // 2)
                if cbp_luma & (1 << b8):
                    nc = self._nc_luma(bby, bbx)
                    zz = CV.read_block(self.r_b, nc, 16)
                    self.st_nnz[bby, bbx] = int((zz != 0).sum())
                    zzs[k] = zz
                else:
                    self.st_nnz[bby, bbx] = 0
            for k in range(16):
                y4, x4 = int(BLOCK_SCAN[k][0]), int(BLOCK_SCAN[k][1])
                self._recon_i4_block(mby, mbx, y4, x4, int(modes[k]),
                                     zzs[k], qp)
            self._decode_residual_chroma(mby, mbx, cbp_chroma, qp,
                                         intra=True, ch_mode=ch_mode)
        elif 1 <= intra_type <= 24:          # I16x16
            i16mode, cbp_chroma, cbp_luma_nz = mb_type_i16_parse(intra_type)
            ch_mode = r.ue()
            qp = self._prev_qp(mby * self.mb_w + mbx)
            qp = (qp + r.se() + 52) % 52
            self.mb_qp[mby, mbx] = qp
            y0, x0 = mby * 16, mbx * 16
            avail_t = mby > 0 and self._mb_ok(mby - 1, mbx)
            avail_l = mbx > 0 and self._mb_ok(mby, mbx - 1)
            top16 = self.rec_y[y0 - 1, x0:x0 + 16] if avail_t else \
                np.zeros(16, np.int64)
            left16 = self.rec_y[y0:y0 + 16, x0 - 1] if avail_l else \
                np.zeros(16, np.int64)
            corner = self.rec_y[y0 - 1, x0 - 1] if (avail_t and avail_l) else 0
            preds, _ = IP.pred16x16_all(top16, left16, corner,
                                        avail_t, avail_l)
            pred = preds[i16mode]
            nc = self._nc_luma(by, bx)
            dc_zz = CV.read_block(self.r_b, nc, 16)
            dc_lev = Q.unzigzag(dc_zz)
            dc_deq = self._dqdc16(dc_lev, qp)
            ac = np.zeros((4, 4, 4, 4), np.int64)
            for k in range(16):
                y4, x4 = int(BLOCK_SCAN[k][0]), int(BLOCK_SCAN[k][1])
                bby, bbx = by + y4, bx + x4
                if cbp_luma_nz:
                    nc = self._nc_luma(bby, bbx)
                    zz15 = CV.read_block(self.r_b, nc, 15)
                    self.st_nnz[bby, bbx] = int((zz15 != 0).sum())
                    full = np.zeros(16, np.int64)
                    full[1:] = zz15
                    ac[y4, x4] = Q.unzigzag(full)
                else:
                    self.st_nnz[bby, bbx] = 0
            deq = self._dq4(ac, qp, intra=True)
            deq[:, :, 0, 0] = dc_deq
            rec_b = Q.reconstruct(
                pred.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3),
                Q.idct4x4(deq))
            self.rec_y[y0:y0 + 16, x0:x0 + 16] = \
                rec_b.transpose(0, 2, 1, 3).reshape(16, 16)
            self.i4_modes[by:by + 4, bx:bx + 4] = -1
            self._decode_residual_chroma(mby, mbx, cbp_chroma, qp,
                                         intra=True, ch_mode=ch_mode)
        elif intra_type == 25:               # I_PCM (spec 7.3.5 / 8.3.5)
            rp = self.r_b                    # sample cat 3 -> partition B
            rp.align()                       # pcm_alignment_zero_bit(s)
            y0, x0 = mby * 16, mbx * 16
            cy0, cx0 = mby * 8, mbx * 8
            self.rec_y[y0:y0 + 16, x0:x0 + 16] = np.array(
                [rp.u(8) for _ in range(256)], np.int64).reshape(16, 16)
            self.rec_u[cy0:cy0 + 8, cx0:cx0 + 8] = np.array(
                [rp.u(8) for _ in range(64)], np.int64).reshape(8, 8)
            self.rec_v[cy0:cy0 + 8, cx0:cx0 + 8] = np.array(
                [rp.u(8) for _ in range(64)], np.int64).reshape(8, 8)
            # spec: PCM MBs count TotalCoeff 16 for nC and deblock as
            # max-strength intra with QP 0
            self.st_nnz[by:by + 4, bx:bx + 4] = 16
            self.nnz_c[:, mby * 2:mby * 2 + 2, mbx * 2:mbx * 2 + 2] = 16
            self.i4_modes[by:by + 4, bx:bx + 4] = -1
            self.mb_qp[mby, mbx] = 0
        else:
            raise NotImplementedError(f"intra mb_type {intra_type} (PCM?)")

    def _recon_i4_block(self, mby, mbx, y4, x4, mode, zz, qp):
        p_w4 = self.mb_w * 4
        by, bx = mby * 4 + y4, mbx * 4 + x4
        y, x = by * 4, bx * 4
        avail_t = by > 0 and self._mb_ok((by - 1) // 4, bx // 4)
        avail_l = bx > 0 and self._mb_ok(by // 4, (bx - 1) // 4)
        tr_by, tr_bx = by - 1, bx + 1
        if tr_by < 0 or tr_bx >= p_w4:
            avail_tr = False
        elif tr_by // 4 < mby:
            avail_tr = self._mb_ok(tr_by // 4, tr_bx // 4)
        elif tr_bx // 4 > mbx:
            avail_tr = False
        else:
            k = int(BLOCK_SCAN_INV[y4, x4])
            avail_tr = int(BLOCK_SCAN_INV[y4 - 1, x4 + 1]) < k
        H, W = self.rec_y.shape
        top9 = np.zeros(8, np.int64)
        if y > 0:
            hi = min(x + 8, W)
            top9[:hi - x] = self.rec_y[y - 1, x:hi]
            if hi - x < 8:
                top9[hi - x:] = self.rec_y[y - 1, hi - 1]
        left4 = self.rec_y[y:y + 4, x - 1] if x > 0 else np.zeros(4, np.int64)
        corner = self.rec_y[y - 1, x - 1] if (y > 0 and x > 0) else 0
        preds, _ = IP.pred4x4_all(top9, left4, corner, avail_t, avail_l,
                                  avail_tr)
        deq = self._dq4(Q.unzigzag(zz), qp, intra=True)
        self.rec_y[y:y + 4, x:x + 4] = Q.reconstruct(preds[mode],
                                                     Q.idct4x4(deq))

    # ------------------------------------------------------------------
    def _decode_residual_luma(self, mby, mbx, cbp_luma, qp, intra16):
        """Inter luma residual: parse + add to the MC prediction in recon."""
        r = self.r_c                         # DP: inter residual = C
        by, bx = mby * 4, mbx * 4
        y0, x0 = mby * 16, mbx * 16
        lev = np.zeros((4, 4, 4, 4), np.int64)
        for k in range(16):
            y4, x4 = int(BLOCK_SCAN[k][0]), int(BLOCK_SCAN[k][1])
            bby, bbx = by + y4, bx + x4
            b8 = (y4 // 2) * 2 + (x4 // 2)
            if cbp_luma & (1 << b8):
                nc = self._nc_luma(bby, bbx)
                zz = CV.read_block(r, nc, 16)
                self.st_nnz[bby, bbx] = int((zz != 0).sum())
                lev[y4, x4] = Q.unzigzag(zz)
            else:
                self.st_nnz[bby, bbx] = 0
        if cbp_luma:
            pred = self.rec_y[y0:y0 + 16, x0:x0 + 16]
            deq = self._dq4(lev, qp, intra=False)
            rec_b = Q.reconstruct(
                pred.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3),
                Q.idct4x4(deq))
            self.rec_y[y0:y0 + 16, x0:x0 + 16] = \
                rec_b.transpose(0, 2, 1, 3).reshape(16, 16)

    # --- High profile: 8x8 transform (spec 8.5.12.2; JM ldecod
    # transform8x8.c itrans8x8 / read_comp_cavlc.c interleaved 4x4) ---
    def _read_zz64_cavlc(self, mby, mbx, y8, x8, intra=False):
        """CAVLC 8x8 residual: four interleaved 4x4 blocks — coefficient
        k of sub-block b4 sits at 8x8 zig-zag position 4*k + b4; each
        sub-block keeps its own total_coeff for nC/nnz (spec 7.3.5.3.2,
        JM read_comp_coeff_4x4_CAVLC with luma_transform_size_8x8_flag)."""
        by, bx = mby * 4 + y8 * 2, mbx * 4 + x8 * 2
        rr = self.r_b if intra else self.r_c
        zz64 = np.zeros(64, np.int64)
        for b4 in range(4):
            bby, bbx = by + (b4 >> 1), bx + (b4 & 1)
            nc = self._nc_luma(bby, bbx)
            zz = CV.read_block(rr, nc, 16)
            self.st_nnz[bby, bbx] = int((zz != 0).sum())
            zz64[4 * np.arange(16) + b4] = zz
        return zz64

    def _decode_residual_luma8(self, mby, mbx, cbp_luma, qp):
        """Inter luma residual with the 8x8 transform."""
        y0, x0 = mby * 16, mbx * 16
        for b8 in range(4):
            y8, x8 = b8 >> 1, b8 & 1
            if not (cbp_luma & (1 << b8)):
                self.st_nnz[mby * 4 + y8 * 2:mby * 4 + y8 * 2 + 2,
                            mbx * 4 + x8 * 2:mbx * 4 + x8 * 2 + 2] = 0
                continue
            zz64 = self._read_zz64_cavlc(mby, mbx, y8, x8)
            deq = self._dq8(Q8.unzigzag8(zz64), qp, intra=False)
            yy, xx = y0 + y8 * 8, x0 + x8 * 8
            pred = self.rec_y[yy:yy + 8, xx:xx + 8]
            self.rec_y[yy:yy + 8, xx:xx + 8] = \
                Q8.reconstruct8(pred, Q8.idct8x8(deq))

    def _decode_intra8x8_mb(self, mby, mbx):
        """I_NxN with transform_size_8x8_flag=1 (spec 8.3.2; JM ldecod
        intra8x8_pred.c + transform8x8.c)."""
        r = self.r
        by, bx = mby * 4, mbx * 4
        self.transform8[mby, mbx] = True
        modes = np.zeros(4, np.int64)
        for b8 in range(4):
            y8, x8 = b8 >> 1, b8 & 1
            cby, cbx = by + 2 * y8, bx + 2 * x8
            avail_l = cbx > 0 and self._mb_ok(cby // 4, (cbx - 1) // 4)
            avail_t = cby > 0 and self._mb_ok((cby - 1) // 4, cbx // 4)
            ma = int(self.i4_modes[cby, cbx - 1]) if avail_l else -2
            mb_ = int(self.i4_modes[cby - 1, cbx]) if avail_t else -2
            if ma == -2 or mb_ == -2:
                mpm = 2
            else:
                mpm = min(ma if ma >= 0 else 2, mb_ if mb_ >= 0 else 2)
            if r.u(1):
                m = mpm
            else:
                rem = r.u(3)
                m = rem + (1 if rem >= mpm else 0)
            modes[b8] = m
            self.i4_modes[cby:cby + 2, cbx:cbx + 2] = m
        ch_mode = r.ue()
        cbp = int(CODENUM_TO_CBP_INTRA[r.ue()])
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        qp = self._prev_qp(mby * self.mb_w + mbx)
        if cbp > 0:
            qp = (qp + r.se() + 52) % 52
        self.mb_qp[mby, mbx] = qp

        for b8 in range(4):
            y8, x8 = b8 >> 1, b8 & 1
            if cbp_luma & (1 << b8):
                zz64 = self._read_zz64_cavlc(mby, mbx, y8, x8, intra=True)
            else:
                zz64 = np.zeros(64, np.int64)
                self.st_nnz[by + y8 * 2:by + y8 * 2 + 2,
                            bx + x8 * 2:bx + x8 * 2 + 2] = 0
            self._recon_i8x8_block(mby, mbx, b8, int(modes[b8]), zz64, qp)
        self._decode_residual_chroma(mby, mbx, cbp_chroma, qp,
                                     intra=True, ch_mode=ch_mode)
        self.mb_intra[mby, mbx] = True

    def _recon_i8x8_block(self, mby, mbx, b8, mode, zz64, qp):
        """Reconstruct one Intra_8x8 block (shared CAVLC/CABAC): spec
        8.3.2 availability geometry + filtered prediction + itrans8x8."""
        y8, x8 = b8 >> 1, b8 & 1
        y0, x0 = mby * 16, mbx * 16
        yy, xx = y0 + y8 * 8, x0 + x8 * 8
        W = self.rec_y.shape[1]
        mb_t = mby > 0 and self._mb_ok(mby - 1, mbx)
        mb_l = mbx > 0 and self._mb_ok(mby, mbx - 1)
        avail_t = True if y8 == 1 else mb_t
        avail_l = True if x8 == 1 else mb_l
        if b8 == 0:
            avail_tr = mb_t
            avail_c = (mby > 0 and mbx > 0
                       and self._mb_ok(mby - 1, mbx - 1))
        elif b8 == 1:
            avail_tr = (mby > 0 and mbx < self.mb_w - 1
                        and self._mb_ok(mby - 1, mbx + 1))
            avail_c = mb_t
        elif b8 == 2:
            avail_tr = True
            avail_c = mb_l
        else:
            avail_tr = False
            avail_c = True
        top16 = np.zeros(16, np.int64)
        if avail_t:
            hi = min(xx + 16, W)
            top16[:hi - xx] = self.rec_y[yy - 1, xx:hi]
            if hi - xx < 16:
                top16[hi - xx:] = self.rec_y[yy - 1, hi - 1]
        left8 = self.rec_y[yy:yy + 8, xx - 1] if avail_l else \
            np.zeros(8, np.int64)
        corner = self.rec_y[yy - 1, xx - 1] if avail_c else 0
        preds, _ = IP.pred8x8_all(top16, left8, corner, avail_t,
                                  avail_l, avail_tr, avail_c)
        deq = self._dq8(Q8.unzigzag8(zz64), qp, intra=True)
        self.rec_y[yy:yy + 8, xx:xx + 8] = \
            Q8.reconstruct8(preds[mode], Q8.idct8x8(deq))

    def _decode_residual_chroma(self, mby, mbx, cbp_chroma, qp, intra,
                                ch_mode=None):
        r = self.r_b if intra else self.r_c
        qpc = Q.chroma_qp(qp, self.pps["chroma_qp_offset"])
        cy, cx = mby * 8, mbx * 8
        if intra:
            avail_t = mby > 0 and self._mb_ok(mby - 1, mbx)
            avail_l = mbx > 0 and self._mb_ok(mby, mbx - 1)
            preds = []
            for rec_p in (self.rec_u, self.rec_v):
                top8 = rec_p[cy - 1, cx:cx + 8] if avail_t else \
                    np.zeros(8, np.int64)
                left8 = rec_p[cy:cy + 8, cx - 1] if avail_l else \
                    np.zeros(8, np.int64)
                corner = rec_p[cy - 1, cx - 1] if (avail_t and avail_l) else 0
                pr, _ = IP.pred_chroma_all(top8, left8, corner,
                                           avail_t, avail_l)
                preds.append(pr[ch_mode])
        else:
            preds = [self.rec_u[cy:cy + 8, cx:cx + 8].copy(),
                     self.rec_v[cy:cy + 8, cx:cx + 8].copy()]

        dc_deqs = [np.zeros((2, 2), np.int64), np.zeros((2, 2), np.int64)]
        if cbp_chroma > 0:
            for ci in range(2):
                dc_zz = CV.read_block(r, -1, 4)
                dc_deqs[ci] = self._dqdcc(dc_zz, qpc, intra, ci)
        acs = [np.zeros((2, 2, 4, 4), np.int64) for _ in range(2)]
        for ci in range(2):
            for by4 in range(2):
                for bx4 in range(2):
                    cby, cbx = mby * 2 + by4, mbx * 2 + bx4
                    if cbp_chroma == 2:
                        nc = self._nc_chroma(ci, cby, cbx)
                        zz15 = CV.read_block(r, nc, 15)
                        self.nnz_c[ci, cby, cbx] = int((zz15 != 0).sum())
                        full = np.zeros(16, np.int64)
                        full[1:] = zz15
                        acs[ci][by4, bx4] = Q.unzigzag(full)
                    else:
                        self.nnz_c[ci, cby, cbx] = 0
        for ci, rec_p in ((0, self.rec_u), (1, self.rec_v)):
            deq = self._dq4(acs[ci], qpc, intra, ci) if cbp_chroma == 2 else \
                np.zeros((2, 2, 4, 4), np.int64)
            deq[:, :, 0, 0] = dc_deqs[ci]
            rec_b = Q.reconstruct(
                np.asarray(preds[ci]).reshape(2, 4, 2, 4).transpose(0, 2, 1, 3),
                Q.idct4x4(deq))
            rec_p[cy:cy + 8, cx:cx + 8] = \
                rec_b.transpose(0, 2, 1, 3).reshape(8, 8)


# ---------------------------------------------------------------------------
# CABAC macroblock parsing (mixin methods of _SliceDecoder)
# ---------------------------------------------------------------------------

def _cabac_decode_mb(self, mb):
    """Parse + reconstruct one MB with CABAC entropy (spec 9.3 syntax;
    JM ldecod read_one_macroblock_*_cabac semantics)."""
    CB = self.CB
    rd = self.crd
    cst = self.cst
    mby, mbx = mb // self.mb_w, mb % self.mb_w
    by, bx = mby * 4, mbx * 4
    p_slice = self.slice_type == 0

    if self.slice_type == 1:                 # B slice
        c0 = CB._Common(cst, mby, mbx, intra=False)
        skip = rd.mb_skip_flag_b(c0)
        cst.skip[mby, mbx] = skip
        if skip:
            cst.btype0[mby, mbx] = True
            self._decode_b_direct(mb, skip=True)
            cst.cat[mby, mbx] = CB.MBState.CAT_SKIP
            cst.cbp[mby, mbx] = 0
            cst.cipred[mby, mbx] = 0
            cst.last_dqp = 0
            sl4 = (slice(by, by + 4), slice(bx, bx + 4))
            cst.direct[sl4] = True
            cst.ref[sl4] = 0
            cst.ref1[sl4] = 0
            cst.mvd[sl4] = 0
            cst.mvd1[sl4] = 0
            return
        return self._decode_b_mb_cabac(mb)

    if p_slice:
        c0 = CB._Common(cst, mby, mbx, intra=False)
        skip = rd.mb_skip_flag(c0)
        cst.skip[mby, mbx] = skip
        if skip:
            self._decode_skip(mb)
            cst.cat[mby, mbx] = CB.MBState.CAT_SKIP
            cst.cbp[mby, mbx] = 0
            cst.cipred[mby, mbx] = 0
            cst.last_dqp = 0
            return

    if p_slice:
        win, i16_code = rd.mb_type_p_slice()
        if win == 7:
            raise NotImplementedError("PCM")
        intra = win in (5, 6)
        intra_type = None
        if intra:
            intra_type = 0 if win == 5 else i16_code
    else:
        c0 = CB._Common(cst, mby, mbx, intra=True)
        intra_type = rd.mb_type_i_slice(c0)
        if intra_type == 25:
            raise NotImplementedError("PCM")
        intra = True
        win = 5 if intra_type == 0 else 6

    if intra:
        c = CB._Common(cst, mby, mbx, intra=True)
        self._cabac_intra_mb(mby, mbx, intra_type, c)
        self.mvf.set_partition(by, bx, 4, 4, np.zeros(2, np.int64), -1)
        self.mb_intra[mby, mbx] = True
        cst.cat[mby, mbx] = CB.MBState.CAT_I4 if intra_type == 0 \
            else CB.MBState.CAT_I16
        return

    # ---- inter MB ----
    c = CB._Common(cst, mby, mbx, intra=False)
    self.mb_intra[mby, mbx] = False
    cst.cat[mby, mbx] = CB.MBState.CAT_INTER
    cst.cipred[mby, mbx] = 0
    num_ref = self.num_ref
    parts = []

    def read_mv(pby, pbx, w4, h4, ri, tag="none"):
        pmv = self.mvf.predict(pby, pbx, w4, h4, ri, tag)
        dx = rd.mvd(c, pby, pbx, 0)
        dy = rd.mvd(c, pby, pbx, 1)
        cst.mvd[pby:pby + h4, pbx:pbx + w4] = (dx, dy)
        mv = pmv + np.array([dx, dy], np.int64)
        self.mvf.set_partition(pby, pbx, w4, h4, mv, ri)
        return mv

    if win == 1:
        ri = rd.ref_idx(c, by, bx) if num_ref > 1 else 0
        cst.ref[by:by + 4, bx:bx + 4] = ri
        mv = read_mv(by, bx, 4, 4, ri)
        parts = [((0, 0, 4, 4), mv, ri)]
    elif win in (2, 3):
        geo = ([((0, 0, 4, 2), "16x8_top"), ((2, 0, 4, 2), "16x8_bot")]
               if win == 2 else
               [((0, 0, 2, 4), "8x16_left"), ((0, 2, 2, 4), "8x16_right")])
        ris = []
        for (dy4, dx4, w4, h4), tag in geo:
            # store each ref before reading the next: the ctx of a later
            # partition reads earlier partitions' cells (ldecod order)
            ri = rd.ref_idx(c, by + dy4, bx + dx4) if num_ref > 1 else 0
            cst.ref[by + dy4:by + dy4 + h4, bx + dx4:bx + dx4 + w4] = ri
            ris.append(ri)
        for ((dy4, dx4, w4, h4), tag), ri in zip(geo, ris):
            mv = read_mv(by + dy4, bx + dx4, w4, h4, ri, tag)
            parts.append(((dy4, dx4, w4, h4), mv, ri))
    else:                                   # P8x8
        subs = [rd.sub_mb_type() for _ in range(4)]
        ris = []
        for b8 in range(4):
            dy8, dx8 = (b8 >> 1) * 2, (b8 & 1) * 2
            ri = rd.ref_idx(c, by + dy8, bx + dx8) if num_ref > 1 else 0
            cst.ref[by + dy8:by + dy8 + 2, bx + dx8:bx + dx8 + 2] = ri
            ris.append(ri)
        for b8 in range(4):
            dy8, dx8 = (b8 >> 1) * 2, (b8 & 1) * 2
            geo = {0: [(0, 0, 2, 2)],
                   1: [(0, 0, 2, 1), (1, 0, 2, 1)],
                   2: [(0, 0, 1, 2), (0, 1, 1, 2)],
                   3: [(0, 0, 1, 1), (0, 1, 1, 1),
                       (1, 0, 1, 1), (1, 1, 1, 1)]}[subs[b8]]
            for (sy, sx, w4, h4) in geo:
                mv = read_mv(by + dy8 + sy, bx + dx8 + sx, w4, h4, ris[b8])
                parts.append(((dy8 + sy, dx8 + sx, w4, h4), mv, ris[b8]))

    self._mc_inter(mby, mbx, parts)

    cbp = rd.cbp(c)
    cst.cbp[mby, mbx] = cbp
    cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
    t8 = False
    no_small = win in (1, 2, 3) or \
        (win == 4 and all(sx == 0 for sx in subs))
    if cbp_luma > 0 and self.pps["transform_8x8"] and no_small:
        t8 = rd.transform_size_flag(c)
    self.transform8[mby, mbx] = t8
    qp = self._prev_qp(mb)
    if cbp > 0:
        qp = (qp + rd.mb_qp_delta(c) + 52) % 52
    else:
        cst.last_dqp = 0
    self.mb_qp[mby, mbx] = qp
    if t8:
        self._cabac_residual_luma8(mby, mbx, cbp_luma, qp, c)
    else:
        self._cabac_residual_luma(mby, mbx, cbp_luma, qp, c, intra16=False)
    self._cabac_residual_chroma(mby, mbx, cbp_chroma, qp, c, intra=False)


def _cabac_residual_luma8(self, mby, mbx, cbp_luma, qp, c):
    """CABAC 8x8 luma residual: one cat-5 (LUMA_8x8) block per coded
    8x8, 64-coefficient scan, no coded_block_flag (spec 7.4.5.3.3); the
    four 4x4 cells inherit the coded status for neighbor cbf contexts
    and deblock (JM ldecod read_comp_coeff_8x8_CABAC)."""
    rd = self.crd
    by, bx = mby * 4, mbx * 4
    y0, x0 = mby * 16, mbx * 16
    for b8 in range(4):
        y8, x8 = b8 >> 1, b8 & 1
        cells = (slice(by + 2 * y8, by + 2 * y8 + 2),
                 slice(bx + 2 * x8, bx + 2 * x8 + 2))
        if not (cbp_luma & (1 << b8)):
            self.st_nnz[cells] = 0
            continue
        zz64 = rd.residual_block(c, self.CB.LUMA_8x8)
        cnt = int((zz64 != 0).sum())
        self.st_nnz[cells] = cnt
        for cy in range(2):
            for cx4 in range(2):
                c.set_cbf(self.CB.LUMA_4x4, by + 2 * y8 + cy,
                          bx + 2 * x8 + cx4)
        deq = self._dq8(Q8.unzigzag8(zz64), qp, intra=False)
        yy, xx = y0 + y8 * 8, x0 + x8 * 8
        pred = self.rec_y[yy:yy + 8, xx:xx + 8]
        self.rec_y[yy:yy + 8, xx:xx + 8] = \
            Q8.reconstruct8(pred, Q8.idct8x8(deq))


def _cabac_intra8x8_mb(self, mby, mbx, c):
    """I_NxN with transform_size_8x8_flag=1, CABAC entropy."""
    rd = self.crd
    cst = self.cst
    by, bx = mby * 4, mbx * 4
    self.transform8[mby, mbx] = True
    modes = np.zeros(4, np.int64)
    for b8 in range(4):
        y8, x8 = b8 >> 1, b8 & 1
        cby, cbx = by + 2 * y8, bx + 2 * x8
        avail_l = cbx > 0 and self._mb_ok(cby // 4, (cbx - 1) // 4)
        avail_t = cby > 0 and self._mb_ok((cby - 1) // 4, cbx // 4)
        ma = int(self.i4_modes[cby, cbx - 1]) if avail_l else -2
        mb_ = int(self.i4_modes[cby - 1, cbx]) if avail_t else -2
        if ma == -2 or mb_ == -2:
            mpm = 2
        else:
            mpm = min(ma if ma >= 0 else 2, mb_ if mb_ >= 0 else 2)
        flag, rem = rd.intra_pred_mode()
        m = mpm if flag else rem + (1 if rem >= mpm else 0)
        modes[b8] = m
        self.i4_modes[cby:cby + 2, cbx:cbx + 2] = m
    ch_mode = rd.chroma_pred_mode(c)
    cst.cipred[mby, mbx] = ch_mode
    cbp = rd.cbp(c)
    cst.cbp[mby, mbx] = cbp
    cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
    qp = self._prev_qp(mby * self.mb_w + mbx)
    if cbp > 0:
        qp = (qp + rd.mb_qp_delta(c) + 52) % 52
    else:
        cst.last_dqp = 0
    self.mb_qp[mby, mbx] = qp
    for b8 in range(4):
        y8, x8 = b8 >> 1, b8 & 1
        cells = (slice(by + 2 * y8, by + 2 * y8 + 2),
                 slice(bx + 2 * x8, bx + 2 * x8 + 2))
        if cbp_luma & (1 << b8):
            zz64 = rd.residual_block(c, self.CB.LUMA_8x8)
            self.st_nnz[cells] = int((zz64 != 0).sum())
            for cy in range(2):
                for cx4 in range(2):
                    c.set_cbf(self.CB.LUMA_4x4, by + 2 * y8 + cy,
                              bx + 2 * x8 + cx4)
        else:
            zz64 = np.zeros(64, np.int64)
            self.st_nnz[cells] = 0
        self._recon_i8x8_block(mby, mbx, b8, int(modes[b8]), zz64, qp)
    self._cabac_residual_chroma(mby, mbx, cbp_chroma, qp, c,
                                intra=True, ch_mode=ch_mode)
    self.mb_intra[mby, mbx] = True


def _cabac_intra_mb(self, mby, mbx, intra_type, c):
    CB = self.CB
    rd = self.crd
    cst = self.cst
    by, bx = mby * 4, mbx * 4
    if intra_type == 0:                      # I_NxN
        if self.pps["transform_8x8"] and rd.transform_size_flag(c):
            return self._cabac_intra8x8_mb(mby, mbx, c)
        modes = np.zeros(16, np.int64)
        for k in range(16):
            y4, x4 = int(BLOCK_SCAN[k][0]), int(BLOCK_SCAN[k][1])
            bby, bbx = by + y4, bx + x4
            avail_l = bbx > 0 and self._mb_ok(bby // 4, (bbx - 1) // 4)
            avail_t = bby > 0 and self._mb_ok((bby - 1) // 4, bbx // 4)
            ma = int(self.i4_modes[bby, bbx - 1]) if avail_l else -2
            mb_ = int(self.i4_modes[bby - 1, bbx]) if avail_t else -2
            if ma == -2 or mb_ == -2:
                mpm = 2
            else:
                mpm = min(ma if ma >= 0 else 2, mb_ if mb_ >= 0 else 2)
            flag, rem = rd.intra_pred_mode()
            m = mpm if flag else rem + (1 if rem >= mpm else 0)
            modes[k] = m
            self.i4_modes[bby, bbx] = m
        ch_mode = rd.chroma_pred_mode(c)
        cst.cipred[mby, mbx] = ch_mode
        cbp = rd.cbp(c)
        cst.cbp[mby, mbx] = cbp
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        qp = self._prev_qp(mby * self.mb_w + mbx)
        if cbp > 0:
            qp = (qp + rd.mb_qp_delta(c) + 52) % 52
        else:
            cst.last_dqp = 0
        self.mb_qp[mby, mbx] = qp
        zzs = np.zeros((16, 16), np.int64)
        for k in range(16):
            y4, x4 = int(BLOCK_SCAN[k][0]), int(BLOCK_SCAN[k][1])
            bby, bbx = by + y4, bx + x4
            b8 = (y4 // 2) * 2 + (x4 // 2)
            if cbp_luma & (1 << b8):
                zz = rd.residual_block(c, self.CB.LUMA_4x4, by=bby, bx=bbx)
                self.st_nnz[bby, bbx] = int((zz != 0).sum())
                zzs[k] = zz
            else:
                self.st_nnz[bby, bbx] = 0
        for k in range(16):
            y4, x4 = int(BLOCK_SCAN[k][0]), int(BLOCK_SCAN[k][1])
            self._recon_i4_block(mby, mbx, y4, x4, int(modes[k]), zzs[k], qp)
        self._cabac_residual_chroma(mby, mbx, cbp_chroma, qp, c,
                                    intra=True, ch_mode=ch_mode)
    else:                                    # I16x16
        i16mode, cbp_chroma, cbp_luma_nz = mb_type_i16_parse(intra_type)
        ch_mode = rd.chroma_pred_mode(c)
        cst.cipred[mby, mbx] = ch_mode
        cst.cbp[mby, mbx] = (15 if cbp_luma_nz else 0) | (cbp_chroma << 4)
        qp = self._prev_qp(mby * self.mb_w + mbx)
        qp = (qp + rd.mb_qp_delta(c) + 52) % 52
        self.mb_qp[mby, mbx] = qp
        y0, x0 = mby * 16, mbx * 16
        avail_t = mby > 0 and self._mb_ok(mby - 1, mbx)
        avail_l = mbx > 0 and self._mb_ok(mby, mbx - 1)
        top16 = self.rec_y[y0 - 1, x0:x0 + 16] if avail_t else \
            np.zeros(16, np.int64)
        left16 = self.rec_y[y0:y0 + 16, x0 - 1] if avail_l else \
            np.zeros(16, np.int64)
        corner = self.rec_y[y0 - 1, x0 - 1] if (avail_t and avail_l) else 0
        preds, _ = IP.pred16x16_all(top16, left16, corner, avail_t, avail_l)
        pred = preds[i16mode]
        dc_zz = rd.residual_block(c, self.CB.LUMA_16DC)
        dc_lev = Q.unzigzag(dc_zz)
        dc_deq = self._dqdc16(dc_lev, qp)
        ac = np.zeros((4, 4, 4, 4), np.int64)
        for k in range(16):
            y4, x4 = int(BLOCK_SCAN[k][0]), int(BLOCK_SCAN[k][1])
            bby, bbx = by + y4, bx + x4
            if cbp_luma_nz:
                zz15 = rd.residual_block(c, self.CB.LUMA_16AC, by=bby, bx=bbx)
                self.st_nnz[bby, bbx] = int((zz15 != 0).sum())
                full = np.zeros(16, np.int64)
                full[1:] = zz15
                ac[y4, x4] = Q.unzigzag(full)
            else:
                self.st_nnz[bby, bbx] = 0
        deq = self._dq4(ac, qp, intra=True)
        deq[:, :, 0, 0] = dc_deq
        rec_b = Q.reconstruct(
            pred.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3), Q.idct4x4(deq))
        self.rec_y[y0:y0 + 16, x0:x0 + 16] = \
            rec_b.transpose(0, 2, 1, 3).reshape(16, 16)
        self.i4_modes[by:by + 4, bx:bx + 4] = -1
        self._cabac_residual_chroma(mby, mbx, cbp_chroma, qp, c,
                                    intra=True, ch_mode=ch_mode)


def _cabac_residual_luma(self, mby, mbx, cbp_luma, qp, c, intra16):
    rd = self.crd
    by, bx = mby * 4, mbx * 4
    y0, x0 = mby * 16, mbx * 16
    lev = np.zeros((4, 4, 4, 4), np.int64)
    for k in range(16):
        y4, x4 = int(BLOCK_SCAN[k][0]), int(BLOCK_SCAN[k][1])
        bby, bbx = by + y4, bx + x4
        b8 = (y4 // 2) * 2 + (x4 // 2)
        if cbp_luma & (1 << b8):
            zz = rd.residual_block(c, self.CB.LUMA_4x4, by=bby, bx=bbx)
            self.st_nnz[bby, bbx] = int((zz != 0).sum())
            lev[y4, x4] = Q.unzigzag(zz)
        else:
            self.st_nnz[bby, bbx] = 0
    if cbp_luma:
        pred = self.rec_y[y0:y0 + 16, x0:x0 + 16]
        deq = self._dq4(lev, qp, intra=False)
        rec_b = Q.reconstruct(
            pred.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3), Q.idct4x4(deq))
        self.rec_y[y0:y0 + 16, x0:x0 + 16] = \
            rec_b.transpose(0, 2, 1, 3).reshape(16, 16)


def _cabac_residual_chroma(self, mby, mbx, cbp_chroma, qp, c, intra,
                           ch_mode=None):
    rd = self.crd
    qpc = Q.chroma_qp(qp, self.pps["chroma_qp_offset"])
    cy, cx = mby * 8, mbx * 8
    if intra:
        avail_t = mby > 0 and self._mb_ok(mby - 1, mbx)
        avail_l = mbx > 0 and self._mb_ok(mby, mbx - 1)
        preds = []
        for rec_p in (self.rec_u, self.rec_v):
            top8 = rec_p[cy - 1, cx:cx + 8] if avail_t else \
                np.zeros(8, np.int64)
            left8 = rec_p[cy:cy + 8, cx - 1] if avail_l else \
                np.zeros(8, np.int64)
            corner = rec_p[cy - 1, cx - 1] if (avail_t and avail_l) else 0
            pr, _ = IP.pred_chroma_all(top8, left8, corner, avail_t, avail_l)
            preds.append(pr[ch_mode])
    else:
        preds = [self.rec_u[cy:cy + 8, cx:cx + 8].copy(),
                 self.rec_v[cy:cy + 8, cx:cx + 8].copy()]

    dc_deqs = [np.zeros((2, 2), np.int64), np.zeros((2, 2), np.int64)]
    if cbp_chroma > 0:
        for ci in range(2):
            dc_zz = rd.residual_block(c, self.CB.CHROMA_DC, comp=ci)
            dc_deqs[ci] = self._dqdcc(dc_zz, qpc, intra, ci)
    acs = [np.zeros((2, 2, 4, 4), np.int64) for _ in range(2)]
    for ci in range(2):
        for by4 in range(2):
            for bx4 in range(2):
                cby, cbx = mby * 2 + by4, mbx * 2 + bx4
                if cbp_chroma == 2:
                    zz15 = rd.residual_block(c, self.CB.CHROMA_AC,
                                             by=cby, bx=cbx, comp=ci)
                    self.nnz_c[ci, cby, cbx] = int((zz15 != 0).sum())
                    full = np.zeros(16, np.int64)
                    full[1:] = zz15
                    acs[ci][by4, bx4] = Q.unzigzag(full)
                else:
                    self.nnz_c[ci, cby, cbx] = 0
    for ci, rec_p in ((0, self.rec_u), (1, self.rec_v)):
        deq = self._dq4(acs[ci], qpc, intra, ci) if cbp_chroma == 2 else \
            np.zeros((2, 2, 4, 4), np.int64)
        deq[:, :, 0, 0] = dc_deqs[ci]
        rec_b = Q.reconstruct(
            np.asarray(preds[ci]).reshape(2, 4, 2, 4).transpose(0, 2, 1, 3),
            Q.idct4x4(deq))
        rec_p[cy:cy + 8, cx:cx + 8] = \
            rec_b.transpose(0, 2, 1, 3).reshape(8, 8)


_SliceDecoder._decode_mb_cabac = _cabac_decode_mb
_SliceDecoder._cabac_intra_mb = _cabac_intra_mb
_SliceDecoder._cabac_residual_luma = _cabac_residual_luma
_SliceDecoder._cabac_residual_luma8 = _cabac_residual_luma8
_SliceDecoder._cabac_intra8x8_mb = _cabac_intra8x8_mb
_SliceDecoder._cabac_residual_chroma = _cabac_residual_chroma


# ---------------------------------------------------------------------------
# B-slice parsing (CAVLC; spec 7.4.5 Table 7-14 subset + spatial direct)
# ---------------------------------------------------------------------------

def _min_positive(a: int, b: int) -> int:
    """spec 8.4.1.2.2 MinPositive."""
    if a >= 0 and b >= 0:
        return min(a, b)
    return max(a, b)


def spatial_direct_16x16(mvf0, mvf1, by, bx, col_mv, col_ref,
                         col_short_term=True):
    """Spatial direct derivation for one MB (spec 8.4.1.2.2).

    mvf0/mvf1: per-list MVFields of the current picture; col_mv/col_ref:
    the colocated (first list-1 reference) picture's stored motion.
    Returns (ref0, ref1, mv0_cells [4,4,2], mv1_cells [4,4,2],
    used0, used1)."""
    def nbr_refs(mvf):
        mv_a, ref_a, av_a = mvf.cell(by, bx - 1)
        mv_b, ref_b, av_b = mvf.cell(by - 1, bx)
        mv_c, ref_c, av_c = mvf.cell(by - 1, bx + 4)
        if not av_c:
            mv_c, ref_c, av_c = mvf.cell(by - 1, bx - 1)
        return ref_a, ref_b, ref_c

    r0 = _min_positive(_min_positive(*nbr_refs(mvf0)[:2]), nbr_refs(mvf0)[2])
    r1 = _min_positive(_min_positive(*nbr_refs(mvf1)[:2]), nbr_refs(mvf1)[2])
    direct_zero = r0 < 0 and r1 < 0
    if direct_zero:
        r0 = r1 = 0
        mv0 = np.zeros(2, np.int64)
        mv1 = np.zeros(2, np.int64)
    else:
        mv0 = mvf0.predict(by, bx, 4, 4, r0) if r0 >= 0 else \
            np.zeros(2, np.int64)
        mv1 = mvf1.predict(by, bx, 4, 4, r1) if r1 >= 0 else \
            np.zeros(2, np.int64)
    used0, used1 = r0 >= 0, r1 >= 0
    if not used0:
        r0 = 0
    if not used1:
        r1 = 0

    mv0_cells = np.broadcast_to(mv0, (4, 4, 2)).copy()
    mv1_cells = np.broadcast_to(mv1, (4, 4, 2)).copy()
    if not direct_zero and col_short_term:
        # direct_8x8_inference_flag = 1: each 8x8 quadrant uses the
        # colocated MACROBLOCK's corner 4x4 (cells (0,0),(0,3),(3,0),(3,3))
        for qy in range(2):
            for qx in range(2):
                rc = int(col_ref[by + 3 * qy, bx + 3 * qx])
                mc = col_mv[by + 3 * qy, bx + 3 * qx]
                # intra colocated (ref < 0) counts as "moving" (JM
                # ldecod mc_direct.c get_colocated_info: colZero needs
                # ref_idx 0 with |mv| <= 1)
                col_zero = (rc == 0 and abs(int(mc[0])) <= 1
                            and abs(int(mc[1])) <= 1)
                if col_zero:
                    sl = (slice(2 * qy, 2 * qy + 2),
                          slice(2 * qx, 2 * qx + 2))
                    if used0 and r0 == 0:
                        mv0_cells[sl[0], sl[1]] = 0
                    if used1 and r1 == 0:
                        mv1_cells[sl[0], sl[1]] = 0
    return r0, r1, mv0_cells, mv1_cells, used0, used1


def _b_mc_bi(self, mby, mbx, pred_parts):
    """Store a B MB prediction: pred_parts = list of (py, pu, pv)."""
    y0, x0 = mby * 16, mbx * 16
    cy, cx = mby * 8, mbx * 8
    if len(pred_parts) == 2:
        py, pu, pv = (( a + b + 1) >> 1 for a, b in zip(*pred_parts))
    else:
        py, pu, pv = pred_parts[0]
    self.rec_y[y0:y0 + 16, x0:x0 + 16] = py
    self.rec_u[cy:cy + 8, cx:cx + 8] = pu
    self.rec_v[cy:cy + 8, cx:cx + 8] = pv


def _b_direct_cells(self, mby, mbx):
    """Per-4x4-cell direct motion of one MB -> (ref0 [4,4], mv0 [4,4,2],
    ref1 [4,4], mv1 [4,4,2]); ref < 0 = list unused for that cell.

    Spatial per spec 8.4.1.2.2 (list-uniform except colZero quadrants) or
    temporal per 8.4.1.2.3 (per-quadrant scaled colocated motion,
    direct_8x8_inference_flag = 1; JM twin ldecod mc_direct.c:25)."""
    by, bx = mby * 4, mbx * 4
    ref0 = np.full((4, 4), -1, np.int64)
    ref1 = np.full((4, 4), -1, np.int64)
    mv0 = np.zeros((4, 4, 2), np.int64)
    mv1 = np.zeros((4, 4, 2), np.int64)
    if self.direct_spatial:
        col_mv = self.col["mv"] if self.col else np.zeros_like(self.mvf.mv)
        col_ref = self.col["ref"] if self.col else \
            np.full_like(self.mvf.ref, -1)
        r0, r1, mv0c, mv1c, used0, used1 = spatial_direct_16x16(
            self.mvf, self.mvf1, by, bx, col_mv, col_ref)
        if used0:
            ref0[:] = r0
            mv0[:] = mv0c
        if used1:
            ref1[:] = r1
            mv1[:] = mv1c
        return ref0, mv0, ref1, mv1

    # temporal direct: both lists always used; refIdxL1 = 0
    poc_cur = self.pic["poc"] if self.pic is not None else 0
    col = self.col
    poc_l1 = self.refs1_entries[0]["poc"]
    l0_pocs = [e["poc"] for e in self.ref_entries]
    col_rp = col.get("ref_poc") if col else None
    for qy in range(2):
        for qx in range(2):
            cc_y, cc_x = by + 3 * qy, bx + 3 * qx   # corner cell (8x8 inf)
            if col is None or col_rp is None:
                mv_col = np.zeros(2, np.int64)
                rp_col = -1
            else:
                mv_col = col["mv"][cc_y, cc_x]
                rp_col = int(col_rp[cc_y, cc_x])
            if rp_col < 0:                          # intra colocated
                r0i = 0
                mv_col = np.zeros(2, np.int64)
            else:
                r0i = l0_pocs.index(rp_col) if rp_col in l0_pocs else 0
            poc_ref = l0_pocs[r0i]
            tb = min(max(poc_cur - poc_ref, -128), 127)
            td = min(max(poc_l1 - poc_ref, -128), 127)
            sl = (slice(2 * qy, 2 * qy + 2), slice(2 * qx, 2 * qx + 2))
            ref0[sl] = r0i
            ref1[sl] = 0
            if td == 0:
                mv0[sl] = mv_col
                mv1[sl] = 0
            else:
                q = 16384 + abs(td) // 2
                tx = q // td if td > 0 else -(q // -td)
                dsf = min(max((tb * tx + 32) >> 6, -1024), 1023)
                m0 = np.array([(dsf * int(mv_col[0]) + 128) >> 8,
                               (dsf * int(mv_col[1]) + 128) >> 8], np.int64)
                mv0[sl] = m0
                mv1[sl] = m0 - mv_col
    return ref0, mv0, ref1, mv1


def _b_direct_pred(self, mby, mbx):
    """Direct derivation + per-cell MC for one MB; commits MV fields.

    Returns [(py, pu, pv)] (already list-combined)."""
    by, bx = mby * 4, mbx * 4
    ref0, mv0, ref1, mv1 = self._b_direct_cells(mby, mbx)
    py = np.zeros((16, 16), np.int64)
    pu = np.zeros((8, 8), np.int64)
    pv = np.zeros((8, 8), np.int64)
    for cy4 in range(4):
        for cx4 in range(4):
            py_, px_ = (by + cy4) * 4, (bx + cx4) * 4
            acc = []
            for lst, (refc, mvc, refs) in enumerate(
                    ((ref0, mv0, self.refs), (ref1, mv1, self.refs1))):
                ri = int(refc[cy4, cx4])
                if ri < 0:
                    continue
                mv = mvc[cy4, cx4]
                rp = refs[ri]
                acc.append((lst, ri,
                            (rp.luma_block(py_, px_, 4, 4,
                                           int(mv[0]), int(mv[1])),
                             rp.chroma_block("u", py_ // 2, px_ // 2, 2, 2,
                                             int(mv[0]), int(mv[1])),
                             rp.chroma_block("v", py_ // 2, px_ // 2, 2, 2,
                                             int(mv[0]), int(mv[1])))))
            pl, puc, pvc = self._wp_combine(acc)
            py[cy4 * 4:cy4 * 4 + 4, cx4 * 4:cx4 * 4 + 4] = pl
            pu[cy4 * 2:cy4 * 2 + 2, cx4 * 2:cx4 * 2 + 2] = puc
            pv[cy4 * 2:cy4 * 2 + 2, cx4 * 2:cx4 * 2 + 2] = pvc
            self.mvf.set_partition(by + cy4, bx + cx4, 1, 1,
                                   mv0[cy4, cx4], int(ref0[cy4, cx4]))
            self.mvf1.set_partition(by + cy4, bx + cx4, 1, 1,
                                    mv1[cy4, cx4], int(ref1[cy4, cx4]))
    return [(py, pu, pv)]


def _b_decode_direct(self, mb, skip=False):
    mby, mbx = mb // self.mb_w, mb % self.mb_w
    preds = self._b_direct_pred(mby, mbx)
    self._b_mc_bi(mby, mbx, preds)
    by, bx = mby * 4, mbx * 4
    self.st_nnz[by:by + 4, bx:bx + 4] = 0
    self.nnz_c[:, mby * 2:mby * 2 + 2, mbx * 2:mbx * 2 + 2] = 0
    self.mb_qp[mby, mbx] = self._prev_qp(mb)
    self.i4_modes[by:by + 4, bx:bx + 4] = -1
    return preds


def _b_decode_mb(self, mb):
    r = self.r
    mby, mbx = mb // self.mb_w, mb % self.mb_w
    by, bx = mby * 4, mbx * 4
    mb_type = self.top._tr(r, "mb_type", r.ue())

    if mb_type >= 23:                        # intra (Table 7-14)
        self._decode_intra_mb(mby, mbx, mb_type - 23)
        self.mvf.set_partition(by, bx, 4, 4, np.zeros(2, np.int64), -1)
        self.mvf1.set_partition(by, bx, 4, 4, np.zeros(2, np.int64), -1)
        self.mb_intra[mby, mbx] = True
        return
    self.mb_intra[mby, mbx] = False
    subs = None
    if mb_type == 22:                        # B_8x8 (Table 7-18 sub types)
        subs = self._decode_b_8x8(mb)
    elif mb_type == 0:                       # B_Direct_16x16
        preds = self._decode_b_direct(mb)
        self._b_mc_bi(mby, mbx, preds)
    else:
        # Table 7-14 partition shapes + per-partition pred modes
        L0, L1, BI = 1, 2, 3
        if mb_type <= 3:
            parts = [((0, 0, 4, 4), "none")]
            modes = [(L0, L1, BI)[mb_type - 1]]
        else:
            idx = mb_type - 4
            pair = [(L0, L0), (L1, L1), (L0, L1), (L1, L0), (L0, BI),
                    (L1, BI), (BI, L0), (BI, L1), (BI, BI)][idx // 2]
            if idx % 2 == 0:                 # 16x8
                parts = [((0, 0, 4, 2), "16x8_top"),
                         ((2, 0, 4, 2), "16x8_bot")]
            else:                            # 8x16
                parts = [((0, 0, 2, 4), "8x16_left"),
                         ((0, 2, 2, 4), "8x16_right")]
            modes = list(pair)
        use0 = [m in (L0, BI) for m in modes]
        use1 = [m in (L1, BI) for m in modes]
        ris0 = [0] * len(parts)
        ris1 = [0] * len(parts)
        for pi in range(len(parts)):
            if use0[pi] and self.num_ref > 1:
                ris0[pi] = self.top._tr(r, "ref_idx_l0",
                                        _te(r, self.num_ref - 1))
        for pi in range(len(parts)):
            if use1[pi] and self.num_ref_l1 > 1:
                ris1[pi] = self.top._tr(r, "ref_idx_l1",
                                        _te(r, self.num_ref_l1 - 1))
        mvs0 = [None] * len(parts)
        mvs1 = [None] * len(parts)
        for pi, ((dy4, dx4, w4, h4), tag) in enumerate(parts):
            if use0[pi]:
                pmv = self.mvf.predict(by + dy4, bx + dx4, w4, h4,
                                       ris0[pi], tag)
                mv = pmv + np.array([self.top._tr(r, "mvd_l0_x", r.se()),
                                     self.top._tr(r, "mvd_l0_y", r.se())],
                                    np.int64)
                self.mvf.set_partition(by + dy4, bx + dx4, w4, h4, mv,
                                       ris0[pi])
                mvs0[pi] = mv
            else:
                self.mvf.set_partition(by + dy4, bx + dx4, w4, h4,
                                       np.zeros(2, np.int64), -1)
        for pi, ((dy4, dx4, w4, h4), tag) in enumerate(parts):
            if use1[pi]:
                pmv = self.mvf1.predict(by + dy4, bx + dx4, w4, h4,
                                        ris1[pi], tag)
                mv = pmv + np.array([self.top._tr(r, "mvd_l1_x", r.se()),
                                     self.top._tr(r, "mvd_l1_y", r.se())],
                                    np.int64)
                self.mvf1.set_partition(by + dy4, bx + dx4, w4, h4, mv,
                                        ris1[pi])
                mvs1[pi] = mv
            else:
                self.mvf1.set_partition(by + dy4, bx + dx4, w4, h4,
                                        np.zeros(2, np.int64), -1)
        # per-partition MC (+ bipred average)
        y0, x0 = mby * 16, mbx * 16
        for pi, ((dy4, dx4, w4, h4), tag) in enumerate(parts):
            py_, px_ = y0 + dy4 * 4, x0 + dx4 * 4
            bh, bw = h4 * 4, w4 * 4
            acc = []
            for lst, (mv, ris, refs) in enumerate(
                    ((mvs0[pi], ris0, self.refs),
                     (mvs1[pi], ris1, self.refs1))):
                if mv is None:
                    continue
                rp = refs[ris[pi]]
                acc.append((lst, ris[pi],
                            (rp.luma_block(py_, px_, bh, bw,
                                           int(mv[0]), int(mv[1])),
                             rp.chroma_block("u", py_ // 2, px_ // 2,
                                             bh // 2, bw // 2,
                                             int(mv[0]), int(mv[1])),
                             rp.chroma_block("v", py_ // 2, px_ // 2,
                                             bh // 2, bw // 2,
                                             int(mv[0]), int(mv[1])))))
            pl, pu, pv = self._wp_combine(acc)
            self.rec_y[py_:py_ + bh, px_:px_ + bw] = pl
            self.rec_u[py_ // 2:py_ // 2 + bh // 2,
                       px_ // 2:px_ // 2 + bw // 2] = pu
            self.rec_v[py_ // 2:py_ // 2 + bh // 2,
                       px_ // 2:px_ // 2 + bw // 2] = pv

    cbp = int(CODENUM_TO_CBP_INTER[
        self.top._tr(r, "coded_block_pattern", r.ue())])
    cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
    t8 = False
    if cbp_luma > 0 and self.pps["transform_8x8"]:
        # noSubMbPartSizeLessThan8x8Flag (spec 7.3.5): B_8x8 needs every
        # sub >= 8x8 (or direct with inference); B_Direct_16x16 needs
        # direct_8x8_inference_flag
        inference = self.sps.get("direct_8x8_inference", 1)
        if subs is not None:
            ok = all(sx in (1, 2, 3) or (sx == 0 and inference)
                     for sx in subs)
        elif mb_type == 0:
            ok = bool(inference)
        else:
            ok = True
        if ok:
            t8 = bool(self.top._tr(r, "transform_size_8x8_flag", r.u(1)))
    self.transform8[mby, mbx] = t8
    qp = self._prev_qp(mb)
    if cbp > 0:
        qp = (qp + self.top._tr(r, "mb_qp_delta", r.se()) + 52) % 52
    self.mb_qp[mby, mbx] = qp
    if t8:
        self._decode_residual_luma8(mby, mbx, cbp_luma, qp)
    else:
        self._decode_residual_luma(mby, mbx, cbp_luma, qp, intra16=False)
    self._decode_residual_chroma(mby, mbx, cbp_chroma, qp, intra=False)


_SliceDecoder._decode_b_mb = _b_decode_mb
_SliceDecoder._decode_b_direct = _b_decode_direct
_SliceDecoder._b_direct_cells = _b_direct_cells
_SliceDecoder._b_direct_pred = _b_direct_pred
_SliceDecoder._b_mc_bi = _b_mc_bi


# B_8x8 sub-partition decoding (Table 7-18; ldecod readMotionInfoFromNAL)
_B_SUB = {0: ("direct", None), 1: ("l0", [(0, 0, 2, 2)]),
          2: ("l1", [(0, 0, 2, 2)]), 3: ("bi", [(0, 0, 2, 2)]),
          4: ("l0", [(0, 0, 2, 1), (1, 0, 2, 1)]),
          5: ("l0", [(0, 0, 1, 2), (0, 1, 1, 2)]),
          6: ("l1", [(0, 0, 2, 1), (1, 0, 2, 1)]),
          7: ("l1", [(0, 0, 1, 2), (0, 1, 1, 2)]),
          8: ("bi", [(0, 0, 2, 1), (1, 0, 2, 1)]),
          9: ("bi", [(0, 0, 1, 2), (0, 1, 1, 2)]),
          10: ("l0", [(0, 0, 1, 1), (0, 1, 1, 1), (1, 0, 1, 1), (1, 1, 1, 1)]),
          11: ("l1", [(0, 0, 1, 1), (0, 1, 1, 1), (1, 0, 1, 1), (1, 1, 1, 1)]),
          12: ("bi", [(0, 0, 1, 1), (0, 1, 1, 1), (1, 0, 1, 1), (1, 1, 1, 1)])}


def _b_decode_8x8(self, mb):
    r = self.r
    mby, mbx = mb // self.mb_w, mb % self.mb_w
    by, bx = mby * 4, mbx * 4
    subs = [self.top._tr(r, "sub_mb_type", r.ue()) for _ in range(4)]
    if any(sx > 12 for sx in subs):
        raise ValueError("bad B sub_mb_type")
    kinds = [_B_SUB[sx][0] for sx in subs]

    # MB-level direct derivation (once; used by direct 8x8s)
    if "direct" in kinds:
        ref0d, mv0d, ref1d, mv1d = self._b_direct_cells(mby, mbx)
        for b8 in range(4):
            if kinds[b8] != "direct":
                continue
            dy8, dx8 = (b8 >> 1) * 2, (b8 & 1) * 2
            for cy in range(2):
                for cx4 in range(2):
                    cyy, cxx = dy8 + cy, dx8 + cx4
                    self.mvf.set_partition(by + cyy, bx + cxx, 1, 1,
                                           mv0d[cyy, cxx],
                                           int(ref0d[cyy, cxx]))
                    self.mvf1.set_partition(by + cyy, bx + cxx, 1, 1,
                                            mv1d[cyy, cxx],
                                            int(ref1d[cyy, cxx]))

    ris0 = [0] * 4
    ris1 = [0] * 4
    for b8 in range(4):
        if kinds[b8] in ("l0", "bi") and self.num_ref > 1:
            ris0[b8] = self.top._tr(r, "ref_idx_l0",
                                    _te(r, self.num_ref - 1))
    for b8 in range(4):
        if kinds[b8] in ("l1", "bi") and self.num_ref_l1 > 1:
            ris1[b8] = self.top._tr(r, "ref_idx_l1",
                                    _te(r, self.num_ref_l1 - 1))
    mvs0 = {}
    mvs1 = {}
    for b8 in range(4):
        if kinds[b8] in ("l0", "bi"):
            dy8, dx8 = (b8 >> 1) * 2, (b8 & 1) * 2
            for gi, (sy, sx, w4, h4) in enumerate(_B_SUB[subs[b8]][1]):
                pby, pbx = by + dy8 + sy, bx + dx8 + sx
                pmv = self.mvf.predict(pby, pbx, w4, h4, ris0[b8])
                mv = pmv + np.array([self.top._tr(r, "mvd_l0_x", r.se()),
                                     self.top._tr(r, "mvd_l0_y", r.se())],
                                    np.int64)
                self.mvf.set_partition(pby, pbx, w4, h4, mv, ris0[b8])
                mvs0[(b8, gi)] = mv
        elif kinds[b8] != "direct":
            dy8, dx8 = (b8 >> 1) * 2, (b8 & 1) * 2
            self.mvf.set_partition(by + dy8, bx + dx8, 2, 2,
                                   np.zeros(2, np.int64), -1)
    for b8 in range(4):
        if kinds[b8] in ("l1", "bi"):
            dy8, dx8 = (b8 >> 1) * 2, (b8 & 1) * 2
            for gi, (sy, sx, w4, h4) in enumerate(_B_SUB[subs[b8]][1]):
                pby, pbx = by + dy8 + sy, bx + dx8 + sx
                pmv = self.mvf1.predict(pby, pbx, w4, h4, ris1[b8])
                mv = pmv + np.array([self.top._tr(r, "mvd_l1_x", r.se()),
                                     self.top._tr(r, "mvd_l1_y", r.se())],
                                    np.int64)
                self.mvf1.set_partition(pby, pbx, w4, h4, mv, ris1[b8])
                mvs1[(b8, gi)] = mv
        elif kinds[b8] != "direct":
            dy8, dx8 = (b8 >> 1) * 2, (b8 & 1) * 2
            self.mvf1.set_partition(by + dy8, bx + dx8, 2, 2,
                                    np.zeros(2, np.int64), -1)

    self._b_8x8_mc(mb, subs, kinds, ris0, ris1, mvs0, mvs1)
    return subs


def _b_8x8_mc(self, mb, subs, kinds, ris0, ris1, mvs0, mvs1):
    """Per-sub-block MC of a B_8x8 MB (shared CAVLC/CABAC)."""
    mby, mbx = mb // self.mb_w, mb % self.mb_w
    by, bx = mby * 4, mbx * 4
    y0, x0 = mby * 16, mbx * 16
    for b8 in range(4):
        dy8, dx8 = (b8 >> 1) * 2, (b8 & 1) * 2
        if kinds[b8] == "direct":
            # per-4x4-cell MC from the committed direct field
            for cy in range(2):
                for cx4 in range(2):
                    cby, cbx = by + dy8 + cy, bx + dx8 + cx4
                    py_, px_ = cby * 4, cbx * 4
                    acc = []
                    for lst, (mvf, refs) in enumerate(
                            ((self.mvf, self.refs),
                             (self.mvf1, self.refs1))):
                        ri = int(mvf.ref[cby, cbx])
                        if ri < 0:
                            continue
                        mv = mvf.mv[cby, cbx]
                        rp = refs[ri]
                        acc.append((lst, ri,
                                    (rp.luma_block(py_, px_, 4, 4,
                                                   int(mv[0]), int(mv[1])),
                                     rp.chroma_block("u", py_ // 2,
                                                     px_ // 2, 2, 2,
                                                     int(mv[0]), int(mv[1])),
                                     rp.chroma_block("v", py_ // 2,
                                                     px_ // 2, 2, 2,
                                                     int(mv[0]),
                                                     int(mv[1])))))
                    pl, pu, pv = self._wp_combine(acc)
                    self.rec_y[py_:py_ + 4, px_:px_ + 4] = pl
                    self.rec_u[py_ // 2:py_ // 2 + 2,
                               px_ // 2:px_ // 2 + 2] = pu
                    self.rec_v[py_ // 2:py_ // 2 + 2,
                               px_ // 2:px_ // 2 + 2] = pv
            continue
        for gi, (sy, sx, w4, h4) in enumerate(_B_SUB[subs[b8]][1]):
            py_ = y0 + (dy8 + sy) * 4
            px_ = x0 + (dx8 + sx) * 4
            bh, bw = h4 * 4, w4 * 4
            acc = []
            if (b8, gi) in mvs0:
                mv = mvs0[(b8, gi)]
                rp = self.refs[ris0[b8]]
                acc.append((0, ris0[b8],
                            (rp.luma_block(py_, px_, bh, bw,
                                           int(mv[0]), int(mv[1])),
                             rp.chroma_block("u", py_ // 2, px_ // 2,
                                             bh // 2, bw // 2,
                                             int(mv[0]), int(mv[1])),
                             rp.chroma_block("v", py_ // 2, px_ // 2,
                                             bh // 2, bw // 2,
                                             int(mv[0]), int(mv[1])))))
            if (b8, gi) in mvs1:
                mv = mvs1[(b8, gi)]
                rp = self.refs1[ris1[b8]]
                acc.append((1, ris1[b8],
                            (rp.luma_block(py_, px_, bh, bw,
                                           int(mv[0]), int(mv[1])),
                             rp.chroma_block("u", py_ // 2, px_ // 2,
                                             bh // 2, bw // 2,
                                             int(mv[0]), int(mv[1])),
                             rp.chroma_block("v", py_ // 2, px_ // 2,
                                             bh // 2, bw // 2,
                                             int(mv[0]), int(mv[1])))))
            pl, pu, pv = self._wp_combine(acc)
            self.rec_y[py_:py_ + bh, px_:px_ + bw] = pl
            self.rec_u[py_ // 2:py_ // 2 + bh // 2,
                       px_ // 2:px_ // 2 + bw // 2] = pu
            self.rec_v[py_ // 2:py_ // 2 + bh // 2,
                       px_ // 2:px_ // 2 + bw // 2] = pv


_SliceDecoder._decode_b_8x8 = _b_decode_8x8
_SliceDecoder._b_8x8_mc = _b_8x8_mc


def _b_decode_mb_cabac(self, mb):
    """Parse + reconstruct one B MB with CABAC (Table 9-37 mb_type,
    per-list mvd/ref contexts; ldecod read_one_macroblock_b_slice_cabac
    semantics).  mb_skip_flag is read by the caller."""
    CB = self.CB
    rd = self.crd
    cst = self.cst
    mby, mbx = mb // self.mb_w, mb % self.mb_w
    by, bx = mby * 4, mbx * 4
    sl4 = (slice(by, by + 4), slice(bx, bx + 4))

    c0 = CB._Common(cst, mby, mbx, intra=False)
    mb_type, i16_code = rd.mb_type_b_slice(c0)
    cst.btype0[mby, mbx] = mb_type == 0
    b_subs = None
    if mb_type == 25:
        raise NotImplementedError("PCM in CABAC B")

    if mb_type >= 23:                        # intra
        intra_type = 0 if mb_type == 23 else i16_code
        c = CB._Common(cst, mby, mbx, intra=True)
        self._cabac_intra_mb(mby, mbx, intra_type, c)
        self.mvf.set_partition(by, bx, 4, 4, np.zeros(2, np.int64), -1)
        self.mvf1.set_partition(by, bx, 4, 4, np.zeros(2, np.int64), -1)
        self.mb_intra[mby, mbx] = True
        cst.cat[mby, mbx] = CB.MBState.CAT_I4 if intra_type == 0 \
            else CB.MBState.CAT_I16
        cst.direct[sl4] = False
        return

    self.mb_intra[mby, mbx] = False
    cst.cat[mby, mbx] = CB.MBState.CAT_INTER
    cst.cipred[mby, mbx] = 0
    c = CB._Common(cst, mby, mbx, intra=False)

    if mb_type == 0:                         # B_Direct_16x16
        preds = self._b_direct_pred(mby, mbx)
        self._b_mc_bi(mby, mbx, preds)
        cst.direct[sl4] = True
        cst.ref[sl4] = 0
        cst.ref1[sl4] = 0
        cst.mvd[sl4] = 0
        cst.mvd1[sl4] = 0
    elif mb_type == 22:                      # B_8x8
        subs = [rd.sub_mb_type_b() for _ in range(4)]
        self._b_8x8_body_cabac(mb, subs)
        b_subs = subs
    else:
        L0, L1, BI = 1, 2, 3
        if mb_type <= 3:
            parts = [((0, 0, 4, 4), "none")]
            modes = [(L0, L1, BI)[mb_type - 1]]
        else:
            idx = mb_type - 4
            pair = [(L0, L0), (L1, L1), (L0, L1), (L1, L0), (L0, BI),
                    (L1, BI), (BI, L0), (BI, L1), (BI, BI)][idx // 2]
            if idx % 2 == 0:
                parts = [((0, 0, 4, 2), "16x8_top"),
                         ((2, 0, 4, 2), "16x8_bot")]
            else:
                parts = [((0, 0, 2, 4), "8x16_left"),
                         ((0, 2, 2, 4), "8x16_right")]
            modes = list(pair)
        use0 = [m in (L0, BI) for m in modes]
        use1 = [m in (L1, BI) for m in modes]
        cst.direct[sl4] = False
        ris0 = [0] * len(parts)
        ris1 = [0] * len(parts)
        for pi, ((dy4, dx4, w4, h4), tag) in enumerate(parts):
            psl = (slice(by + dy4, by + dy4 + h4),
                   slice(bx + dx4, bx + dx4 + w4))
            if use0[pi] and self.num_ref > 1:
                ris0[pi] = rd.ref_idx(c, by + dy4, bx + dx4, lst=0)
            cst.ref[psl] = ris0[pi] if use0[pi] else 0
        for pi, ((dy4, dx4, w4, h4), tag) in enumerate(parts):
            psl = (slice(by + dy4, by + dy4 + h4),
                   slice(bx + dx4, bx + dx4 + w4))
            if use1[pi] and self.num_ref_l1 > 1:
                ris1[pi] = rd.ref_idx(c, by + dy4, bx + dx4, lst=1)
            cst.ref1[psl] = ris1[pi] if use1[pi] else 0
        mvs0 = [None] * len(parts)
        mvs1 = [None] * len(parts)
        for pi, ((dy4, dx4, w4, h4), tag) in enumerate(parts):
            psl = (slice(by + dy4, by + dy4 + h4),
                   slice(bx + dx4, bx + dx4 + w4))
            if use0[pi]:
                pmv = self.mvf.predict(by + dy4, bx + dx4, w4, h4,
                                       ris0[pi], tag)
                dx = rd.mvd(c, by + dy4, bx + dx4, 0, lst=0)
                dy = rd.mvd(c, by + dy4, bx + dx4, 1, lst=0)
                cst.mvd[psl] = (dx, dy)
                mv = pmv + np.array([dx, dy], np.int64)
                self.mvf.set_partition(by + dy4, bx + dx4, w4, h4, mv,
                                       ris0[pi])
                mvs0[pi] = mv
            else:
                cst.mvd[psl] = 0
                self.mvf.set_partition(by + dy4, bx + dx4, w4, h4,
                                       np.zeros(2, np.int64), -1)
        for pi, ((dy4, dx4, w4, h4), tag) in enumerate(parts):
            psl = (slice(by + dy4, by + dy4 + h4),
                   slice(bx + dx4, bx + dx4 + w4))
            if use1[pi]:
                pmv = self.mvf1.predict(by + dy4, bx + dx4, w4, h4,
                                        ris1[pi], tag)
                dx = rd.mvd(c, by + dy4, bx + dx4, 0, lst=1)
                dy = rd.mvd(c, by + dy4, bx + dx4, 1, lst=1)
                cst.mvd1[psl] = (dx, dy)
                mv = pmv + np.array([dx, dy], np.int64)
                self.mvf1.set_partition(by + dy4, bx + dx4, w4, h4, mv,
                                        ris1[pi])
                mvs1[pi] = mv
            else:
                cst.mvd1[psl] = 0
                self.mvf1.set_partition(by + dy4, bx + dx4, w4, h4,
                                        np.zeros(2, np.int64), -1)
        y0, x0 = mby * 16, mbx * 16
        for pi, ((dy4, dx4, w4, h4), tag) in enumerate(parts):
            py_, px_ = y0 + dy4 * 4, x0 + dx4 * 4
            bh, bw = h4 * 4, w4 * 4
            acc = []
            for lst, (mv, ris, refs) in enumerate(
                    ((mvs0[pi], ris0, self.refs),
                     (mvs1[pi], ris1, self.refs1))):
                if mv is None:
                    continue
                rp = refs[ris[pi]]
                acc.append((lst, ris[pi],
                            (rp.luma_block(py_, px_, bh, bw,
                                           int(mv[0]), int(mv[1])),
                             rp.chroma_block("u", py_ // 2, px_ // 2,
                                             bh // 2, bw // 2,
                                             int(mv[0]), int(mv[1])),
                             rp.chroma_block("v", py_ // 2, px_ // 2,
                                             bh // 2, bw // 2,
                                             int(mv[0]), int(mv[1])))))
            pl, pu, pv = self._wp_combine(acc)
            self.rec_y[py_:py_ + bh, px_:px_ + bw] = pl
            self.rec_u[py_ // 2:py_ // 2 + bh // 2,
                       px_ // 2:px_ // 2 + bw // 2] = pu
            self.rec_v[py_ // 2:py_ // 2 + bh // 2,
                       px_ // 2:px_ // 2 + bw // 2] = pv

    cbp = rd.cbp(c)
    cst.cbp[mby, mbx] = cbp
    cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
    t8 = False
    if cbp_luma > 0 and self.pps["transform_8x8"]:
        inference = self.sps.get("direct_8x8_inference", 1)
        if b_subs is not None:
            ok = all(sx in (1, 2, 3) or (sx == 0 and inference)
                     for sx in b_subs)
        elif mb_type == 0:
            ok = bool(inference)
        else:
            ok = True
        if ok:
            t8 = rd.transform_size_flag(c)
    self.transform8[mby, mbx] = t8
    qp = self._prev_qp(mb)
    if cbp > 0:
        qp = (qp + rd.mb_qp_delta(c) + 52) % 52
    else:
        cst.last_dqp = 0
    self.mb_qp[mby, mbx] = qp
    if t8:
        self._cabac_residual_luma8(mby, mbx, cbp_luma, qp, c)
    else:
        self._cabac_residual_luma(mby, mbx, cbp_luma, qp, c,
                                  intra16=False)
    self._cabac_residual_chroma(mby, mbx, cbp_chroma, qp, c, intra=False)


def _b_8x8_body_cabac(self, mb, subs):
    """B_8x8 with CABAC-read sub types/refs/mvds; reuses the per-cell MC
    of the CAVLC path's structures."""
    CB = self.CB
    rd = self.crd
    cst = self.cst
    mby, mbx = mb // self.mb_w, mb % self.mb_w
    by, bx = mby * 4, mbx * 4
    kinds = [_B_SUB[sx][0] for sx in subs]
    c = CB._Common(cst, mby, mbx, intra=False)

    if "direct" in kinds:
        ref0d, mv0d, ref1d, mv1d = self._b_direct_cells(mby, mbx)
    for b8 in range(4):
        dy8, dx8 = (b8 >> 1) * 2, (b8 & 1) * 2
        s8 = (slice(by + dy8, by + dy8 + 2), slice(bx + dx8, bx + dx8 + 2))
        if kinds[b8] == "direct":
            cst.direct[s8] = True
            cst.ref[s8] = 0
            cst.ref1[s8] = 0
            for cy in range(2):
                for cx4 in range(2):
                    cyy, cxx = dy8 + cy, dx8 + cx4
                    self.mvf.set_partition(by + cyy, bx + cxx, 1, 1,
                                           mv0d[cyy, cxx],
                                           int(ref0d[cyy, cxx]))
                    self.mvf1.set_partition(by + cyy, bx + cxx, 1, 1,
                                            mv1d[cyy, cxx],
                                            int(ref1d[cyy, cxx]))
        else:
            cst.direct[s8] = False

    ris0 = [0] * 4
    ris1 = [0] * 4
    for b8 in range(4):
        dy8, dx8 = (b8 >> 1) * 2, (b8 & 1) * 2
        s8 = (slice(by + dy8, by + dy8 + 2), slice(bx + dx8, bx + dx8 + 2))
        if kinds[b8] in ("l0", "bi"):
            if self.num_ref > 1:
                ris0[b8] = rd.ref_idx(c, by + dy8, bx + dx8, lst=0)
            cst.ref[s8] = ris0[b8]
        elif kinds[b8] != "direct":
            cst.ref[s8] = 0
    for b8 in range(4):
        dy8, dx8 = (b8 >> 1) * 2, (b8 & 1) * 2
        s8 = (slice(by + dy8, by + dy8 + 2), slice(bx + dx8, bx + dx8 + 2))
        if kinds[b8] in ("l1", "bi"):
            if self.num_ref_l1 > 1:
                ris1[b8] = rd.ref_idx(c, by + dy8, bx + dx8, lst=1)
            cst.ref1[s8] = ris1[b8]
        elif kinds[b8] != "direct":
            cst.ref1[s8] = 0

    mvs0 = {}
    mvs1 = {}
    for b8 in range(4):
        if kinds[b8] in ("l0", "bi"):
            dy8, dx8 = (b8 >> 1) * 2, (b8 & 1) * 2
            for gi, (sy, sx, w4, h4) in enumerate(_B_SUB[subs[b8]][1]):
                pby, pbx = by + dy8 + sy, bx + dx8 + sx
                pmv = self.mvf.predict(pby, pbx, w4, h4, ris0[b8], "none")
                dx = rd.mvd(c, pby, pbx, 0, lst=0)
                dy = rd.mvd(c, pby, pbx, 1, lst=0)
                cst.mvd[pby:pby + h4, pbx:pbx + w4] = (dx, dy)
                mv = pmv + np.array([dx, dy], np.int64)
                self.mvf.set_partition(pby, pbx, w4, h4, mv, ris0[b8])
                mvs0[(b8, gi)] = mv
        elif kinds[b8] != "direct":
            dy8, dx8 = (b8 >> 1) * 2, (b8 & 1) * 2
            self.mvf.set_partition(by + dy8, bx + dx8, 2, 2,
                                   np.zeros(2, np.int64), -1)
    for b8 in range(4):
        if kinds[b8] in ("l1", "bi"):
            dy8, dx8 = (b8 >> 1) * 2, (b8 & 1) * 2
            for gi, (sy, sx, w4, h4) in enumerate(_B_SUB[subs[b8]][1]):
                pby, pbx = by + dy8 + sy, bx + dx8 + sx
                pmv = self.mvf1.predict(pby, pbx, w4, h4, ris1[b8], "none")
                dx = rd.mvd(c, pby, pbx, 0, lst=1)
                dy = rd.mvd(c, pby, pbx, 1, lst=1)
                cst.mvd1[pby:pby + h4, pbx:pbx + w4] = (dx, dy)
                mv = pmv + np.array([dx, dy], np.int64)
                self.mvf1.set_partition(pby, pbx, w4, h4, mv, ris1[b8])
                mvs1[(b8, gi)] = mv
        elif kinds[b8] != "direct":
            dy8, dx8 = (b8 >> 1) * 2, (b8 & 1) * 2
            self.mvf1.set_partition(by + dy8, bx + dx8, 2, 2,
                                    np.zeros(2, np.int64), -1)

    self._b_8x8_mc(mb, subs, kinds, ris0, ris1, mvs0, mvs1)


_SliceDecoder._decode_b_mb_cabac = _b_decode_mb_cabac
_SliceDecoder._b_8x8_body_cabac = _b_8x8_body_cabac
