"""Standard H.264 decoder, CAVLC progressive (host model).

Decodes H.264 Annex-B streams bit-exactly: I/IDR and P slices (every P
partition and sub-partition type), B slices without direct prediction,
intra 4x4/16x16 and I_PCM, P_Skip, explicit weighted prediction,
multi-ref sliding-window DPB with long-term reference pictures (MMCO ops
1-6) and reference list modification, POC types 0/1/2 with display-order
output keyed by (idr_epoch, poc), multi-slice pictures (spec 6.4.11
slice-restricted availability), mb_qp_delta, data partitioning (NAL
2/3/4), HRD VUI, in-loop deblocking, and per-syntax-element bit statistics
(``bit_statistics``, the dec_statistics.c analogue).  The JM counterpart is
``JM/ldecod/src/{image.c:809 decode_one_frame, mb_read.c:1139,
read_comp_cavlc.c, mb_prediction.c}``.

Raise ``NotImplementedError``: CABAC, the 8x8 transform, scaling lists,
FMO, B direct prediction (B_Skip, B_Direct_16x16, B_8x8), MVC, error
concealment, fields/MBAFF, 4:2:2/4:4:4/>8-bit.

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
from .deblock import DeblockContext, deblock_frame


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
            raise NotImplementedError("scaling lists is not ported")
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
    p["second_chroma_qp_offset"] = p["chroma_qp_offset"]
    # more_rbsp_data: bits remain before the rbsp_stop_one_bit
    stop = int(np.flatnonzero(r._bits)[-1])
    if r.pos < stop:                        # High-profile PPS extension
        if r.u(1):                          # transform_8x8_mode_flag
            raise NotImplementedError("the 8x8 transform is not ported")
        if r.u(1):                          # pic_scaling_matrix_present
            raise NotImplementedError("scaling lists is not ported")
        p["second_chroma_qp_offset"] = r.se()
        if p["second_chroma_qp_offset"] != p["chroma_qp_offset"]:
            raise NotImplementedError("separate Cr QP offset")
    return p


def _slice_group_map(pps: dict, mb_w: int, mb_h: int,
                     change_cycle: int = 0) -> np.ndarray:
    """mapUnitToSliceGroupMap (spec 8.2.2.1-8.2.2.8) -> flat [n_mb];
    the full 7-type generator lives in models/resilience.py.  For types
    3..5 ``change_cycle`` is the slice-header slice_group_change_cycle."""
    raise NotImplementedError("FMO is not ported")


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
        """Decode all coded pictures; returns list of (y, u, v) uint8.

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
        if not pic["decoded"].all():
            # lost slices: MB-level concealment (erc_do_i/erc_do_p shape)
            raise NotImplementedError("error concealment is not ported")
        rec = pic["rec"]
        ctx = DeblockContext(pic["mb_w"], pic["mb_h"], pic["qp"],
                             pps["chroma_qp_offset"])
        ctx.mb_qp = pic["mb_qp"]
        ctx.mb_intra = pic["mb_intra"]
        ctx.nnz = pic["nnz"]
        ctx.mv = pic["mv"]
        ctx.ref = pic["ref"]
        ctx.alpha_off, ctx.beta_off = pic["a_off"], pic["b_off"]
        if pic["is_b"]:
            ctx.mv1 = pic["mv1"]
            ctx.ref1 = pic["ref1"]
        if pic["disable_dbl"] != 1:
            rec = deblock_frame(*rec, ctx)
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
        return frame

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
        if slice_type == 1:
            r.u(1)                          # direct_spatial_mv_pred_flag
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
        if pps["cabac"]:
            raise NotImplementedError("CABAC is not ported")
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
        refs1 = []
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
        def apply_reorder(lst, ops):
            # spec 8.2.4.3.1/8.2.4.3.2 modification processes
            max_pic_num = max_fn
            pic_num_pred = frame_num
            idx = 0
            lst = list(lst)
            for op, d in ops:
                if op in (4, 5):            # MVC inter-view ref (H.8.2.2.3)
                    raise NotImplementedError("MVC is not ported")
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
                            refs1=refs1, num_ref_l1=num_ref_l1, wp=wp,
                            gmap=gmap, mb_seq=mb_seq, r_b=r_b, r_c=r_c)
        dec.run()
        return done


class _SliceDecoder:
    def __init__(self, top, sps, pps, slice_type, qp, refs, r, mb_w, mb_h,
                 num_ref=1, first_mb=0, pic=None, refs1=None,
                 num_ref_l1=1, wp=None, gmap=None, mb_seq=None,
                 r_b=None, r_c=None):
        self.top = top
        # data partitioning (spec 7.4.1, NAL 2/3/4): category-2 syntax
        # reads from ``r`` (partition A), intra residual from B, inter
        # residual from C; without DP all three are the same reader
        self.r_b = r_b if r_b is not None else r
        self.r_c = r_c if r_c is not None else r
        self.wp = wp
        self.gmap = gmap                    # FMO slice-group map (flat)
        self.mb_seq = mb_seq                # this slice's MB decode order
        # refs arrive as DPB entry dicts (or bare RefPlanes in legacy use)
        self.ref_entries = refs
        refs = [e["rp"] if isinstance(e, dict) else e for e in refs]
        self.refs1_entries = refs1 or []
        self.refs1 = [e["rp"] for e in self.refs1_entries]
        self.num_ref_l1 = num_ref_l1
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
        self.i4_modes = np.full((mb_h * 4, mb_w * 4), -1, np.int64)
        self.mvf = INTER.MVField(mb_h, mb_w)
        # last set bit == rbsp_stop_one_bit; data remains while pos < it
        self._stop = int(np.flatnonzero(r._bits)[-1])

    def _mb_ok(self, mby, mbx):
        """Same-slice availability of a causal neighbor MB (spec 6.4.11;
        with FMO the neighbor must share this slice's group)."""
        mb = mby * self.mb_w + mbx
        if self.gmap is not None and \
                self.gmap[mb] != self.gmap[self.first_mb]:
            return False
        return mb >= self.first_mb

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
                        raise NotImplementedError(
                            "B direct prediction is not ported")
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
        qp = self._prev_qp(mby * self.mb_w + mbx)
        if cbp > 0:
            qp = (qp + self.top._tr(r, "mb_qp_delta", r.se()) + 52) % 52
        self.mb_qp[mby, mbx] = qp
        self._decode_residual_luma(mby, mbx, cbp_luma, qp, intra16=False)
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
            dc_deq = Q.dequant_dc16(dc_lev, qp)
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
            deq = Q.dequant4x4(ac, qp)
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
        deq = Q.dequant4x4(Q.unzigzag(zz), qp)
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
            deq = Q.dequant4x4(lev, qp)
            rec_b = Q.reconstruct(
                pred.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3),
                Q.idct4x4(deq))
            self.rec_y[y0:y0 + 16, x0:x0 + 16] = \
                rec_b.transpose(0, 2, 1, 3).reshape(16, 16)

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
                dc_deqs[ci] = Q.dequant_dc_chroma(dc_zz, qpc)
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
            deq = Q.dequant4x4(acs[ci], qpc) if cbp_chroma == 2 else \
                np.zeros((2, 2, 4, 4), np.int64)
            deq[:, :, 0, 0] = dc_deqs[ci]
            rec_b = Q.reconstruct(
                np.asarray(preds[ci]).reshape(2, 4, 2, 4).transpose(0, 2, 1, 3),
                Q.idct4x4(deq))
            rec_p[cy:cy + 8, cx:cx + 8] = \
                rec_b.transpose(0, 2, 1, 3).reshape(8, 8)


# ---------------------------------------------------------------------------
# B-slice parsing (CAVLC; spec 7.4.5 Table 7-14 subset + spatial direct)
# ---------------------------------------------------------------------------

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
    if mb_type in (0, 22):                   # B_Direct_16x16, B_8x8
        raise NotImplementedError("B direct prediction is not ported")
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
    qp = self._prev_qp(mb)
    if cbp > 0:
        qp = (qp + self.top._tr(r, "mb_qp_delta", r.se()) + 52) % 52
    self.mb_qp[mby, mbx] = qp
    self._decode_residual_luma(mby, mbx, cbp_luma, qp, intra16=False)
    self._decode_residual_chroma(mby, mbx, cbp_chroma, qp, intra=False)


_SliceDecoder._decode_b_mb = _b_decode_mb

