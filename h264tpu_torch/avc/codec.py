"""High-level conformant H.264 sequence encoder (the ``lencod``-shaped API).

Ties the avc layer together the way ``JM/lencod/src/lencod.c:876``
encode_sequence does: GOP scheduling (IDR period), multi-reference DPB,
deblocking, Annex-B assembly, per-frame stats — emitting streams that JM
18.5 ``ldecod`` (and :class:`h264tpu_torch.avc.slice_dec.AVCDecoder`)
decode bit-exactly.

The port's own copy of ``h264tpu/avc/codec.py``: host numpy, as there (no
``device`` argument; the per-MB search and mode decision stay on the host).
The weighted-prediction estimators live in ``avc/wp.py`` and are
re-exported here under the reference's names.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..bitstream.nal import annexb_parse, annexb_write
from .params import AVCParams, assemble_stream
from .slice_enc import (encode_i_frame, encode_p_frame, encode_b_frame,
                        encode_i_frame_pcm, lambda_mode)
from .slice_dec import AVCDecoder
from .deblock import DeblockContext, deblock_frame
from .inter import RefPlanes
from .wp import estimate_wp, estimate_wp_lms
from . import conformance
from . import sei as SEI


class WPRefPlanes:
    """Explicit-WP view of a RefPlanes (spec 8.4.2.3.2 unidirectional):
    luma_block/chroma_block outputs are weighted post-MC so the encoder's
    residual/recon math sees exactly what the decoder reconstructs; ``G``
    is a weighted integer plane so the motion search measures distortion
    against the weighted reference.  JM twin: weighted_prediction.c:31
    EstimateWPPSlice + mc_prediction weighted paths."""

    def __init__(self, rp: RefPlanes, entry, d_l: int, d_c: int):
        self.rp = rp
        self.e = entry              # (wy, oy, wu, ou, wv, ov)
        self.d_l, self.d_c = d_l, d_c
        self.h, self.w = rp.h, rp.w
        wy, oy = entry[0], entry[1]
        self.G = np.clip(((rp.G * wy + (1 << (d_l - 1))) >> d_l) + oy,
                         0, 255)

    @staticmethod
    def _t(pl, w_, o_, d):
        if d > 0:
            return np.clip(((pl * w_ + (1 << (d - 1))) >> d) + o_, 0, 255)
        return np.clip(pl * w_ + o_, 0, 255)

    def luma_block(self, *a):
        return self._t(self.rp.luma_block(*a), self.e[0], self.e[1],
                       self.d_l)

    def chroma_block(self, comp, *a):
        w_, o_ = (self.e[2], self.e[3]) if comp == "u" else \
            (self.e[4], self.e[5])
        return self._t(self.rp.chroma_block(comp, *a), w_, o_, self.d_c)


@dataclasses.dataclass
class AVCFrameResult:
    frame_type: str
    bits: int
    psnr_y: float
    recon: tuple          # (Y, U, V) uint8
    coded: tuple = None   # the coded picture, where the SPS crops it


class AVCCodec:
    """Sequence encoder for real H.264 Baseline/CAVLC streams."""

    def __init__(self, p: AVCParams, intra_period: int = 0,
                 search_range: int = 16, use_satd: bool = True,
                 check_conformance: bool = True, bframes: int = 0,
                 wp_method: str = "dc", open_gop: bool = False,
                 rd_picture_decision: bool = False,
                 lossless: bool = False, me_method: str = "full"):
        """``intra_period``: 0 = first frame IDR then all P (IPPP);
        N>0 = IDR every N frames.  ``bframes``: number of non-reference
        B pictures between anchors (IbbPbbP...; requires poc_type 0 and
        num_ref_frames >= 2 so both anchors stay in the DPB).
        ``wp_method``: explicit-WP estimator when p.weighted_pred —
        "dc" (DC ratio, weighted_prediction.c method 0) or "lms"
        (least-squares gain+offset, wp_lms.c).
        ``open_gop``: periodic intra pictures are coded as NON-IDR I
        slices with a recovery_point SEI instead of IDRs — the DPB is
        not flushed, so pictures after the I may still reference across
        it (JM pred_struct.c open-GOP shape; needs intra_period > 0,
        IPPP)."""
        self.p = p
        self.intra_period = intra_period
        self.sr = search_range
        self.use_satd = use_satd
        self.bframes = bframes
        if wp_method not in ("dc", "lms"):
            raise ValueError(f"wp_method {wp_method!r}")
        self.wp_method = wp_method
        # integer-ME family (mv_search.c:145-168 dispatch): "full" or
        # "umhex" (UMHexagonS-shaped pruning, me_umhex.c)
        if me_method not in ("full", "umhex"):
            raise ValueError(f"me_method {me_method!r}")
        self.me_method = me_method
        self.open_gop = open_gop
        if open_gop and (intra_period <= 0 or bframes > 0):
            raise ValueError("open_gop needs intra_period > 0 and no "
                             "B pictures (IPPP)")
        # Multi-pass picture decision (JM rdpicdecision.c /
        # RDPictureDecision): each P frame is coded at {qp-1, qp, qp+1}
        # and the pass with the lowest frame RD cost J = SSD_Y + lam*bits
        # (lam at the BASE qp, so passes are comparable) wins; the
        # winner's reconstruction drives the prediction chain
        self.rd_picture_decision = rd_picture_decision
        # Lossless coding: every picture is an all-I_PCM IDR
        # (reconstruction == source bit-exactly; JM's lossless surface)
        self.lossless = lossless
        if lossless and bframes > 0:
            raise ValueError("lossless (I_PCM) coding is all-intra")
        if p.cabac:
            # the host slice writers emit CAVLC syntax only; with
            # entropy_coding_mode_flag=1 in the PPS the stream would be
            # undecodable.  CABAC lives on the device path (DeviceAVCCodec
            # -> pack_cabac).
            raise ValueError("AVCCodec is CAVLC-only; use DeviceAVCCodec "
                             "for CABAC streams")
        if bframes > 0:
            if p.poc_type != 0:
                raise ValueError("bframes needs AVCParams(poc_type=0)")
            if p.num_ref_frames < 2:
                raise ValueError("bframes needs num_ref_frames >= 2")
            if p.profile_idc == 66:
                raise ValueError("B slices need Main profile (77)")
        if p.slice_groups > 1 and intra_period != 1:
            # encode_p_frame has no FMO support (one raster slice) while the
            # PPS would still signal num_slice_groups>1 — ldecod would walk
            # the FMO map and misdecode the P slices.  All-IDR sequences
            # (intra_period == 1) are the supported FMO configuration.
            raise ValueError(
                "slice_groups > 1 requires intra_period == 1 (all-IDR): "
                "P slices have no FMO support yet")
        if p.cropped:
            raise NotImplementedError("the host encoder codes whole "
                                      "macroblocks: no cropping")
        if check_conformance:
            conformance.check_params(p)

    def _is_idr(self, idx: int) -> bool:
        if idx == 0:
            return True
        return self.intra_period > 0 and idx % self.intra_period == 0

    def encode_sequence(self, frames, qp: int = None, verbose: bool = False,
                        force_intra=None):
        """frames: iterable of (Y, U, V) uint8.  ``force_intra``: optional
        callable idx -> [mb_h, mb_w] bool mask (errdo / intra refresh).
        Returns (results, Annex-B stream bytes)."""
        if self.bframes > 0:
            return self._encode_sequence_b(frames, qp, verbose)
        p = self.p
        qp = p.qp if qp is None else qp
        self.pic_qps = []             # chosen per-P QPs (RDPictureDecision)
        slices, results = [], []
        dpb = []                      # list0, most recent first
        dpb_means = []                # (dc_y, dc_u, dc_v) per entry (WP)
        frame_num = 0
        idr_pic_id = 0
        sei_at = []                   # slice indices of open-GOP I pictures
        for idx, yuv in enumerate(frames):
            idr = self._is_idr(idx)
            og_i = False
            if idr and idx > 0 and self.open_gop:
                idr, og_i = False, True
            ctx = DeblockContext(p.mb_w, p.mb_h, qp, p.chroma_qp_offset)
            if self.lossless:
                # all-I_PCM IDR: recon == source, deblock is a no-op by
                # spec (PCM MBs filter with QPY 0 -> thresholds 0)
                rbsp, rec, stats = encode_i_frame_pcm(
                    yuv, p, idr=True, idr_pic_id=idr_pic_id)
                idr_pic_id = (idr_pic_id + 1) & 0xFFFF
                slices.append((True, rbsp))
                rec8 = tuple(np.asarray(pl, np.uint8) for pl in rec)
                results.append(AVCFrameResult(
                    frame_type="IDR", bits=stats["bits"], psnr_y=99.99,
                    recon=rec8))
                if verbose:
                    print(f"frame {idx:3d} IDR bits {stats['bits']:7d} "
                          f"PSNR-Y  99.99 (PCM)")
                continue
            if idr:
                rbsp, rec, stats = encode_i_frame(yuv, p, qp=qp, frame_num=0,
                                                  idr=True,
                                                  idr_pic_id=idr_pic_id)
                idr_pic_id = (idr_pic_id + 1) & 0xFFFF
                frame_num = 1
                dpb = []
                dpb_means = []
                ftype = "IDR"
            elif og_i:
                # open GOP: non-IDR I picture — DPB survives, frame_num
                # keeps counting, a recovery_point SEI marks the random
                # access point (JM open-GOP / recovery-point pairing)
                sei_at.append(len(slices))
                rbsp, rec, stats = encode_i_frame(yuv, p, qp=qp,
                                                  frame_num=frame_num,
                                                  idr=False)
                frame_num = (frame_num + 1) % (1 << p.log2_max_frame_num)
                ftype = "I"
            else:
                fim = force_intra(idx) if force_intra else None
                wp = None
                refs_in = dpb
                if p.weighted_pred:
                    wp = (estimate_wp_lms(yuv, dpb)
                          if self.wp_method == "lms"
                          else estimate_wp(yuv, dpb_means))
                    refs_in = [WPRefPlanes(rp, e, wp["d_l"], wp["d_c"])
                               for rp, e in zip(dpb, wp["l0"])]
                if self.rd_picture_decision:
                    # rdpicdecision.c: code the picture at qp-1/qp/qp+1,
                    # lowest J = SSD_Y + lam(base qp)*bits wins
                    lam = lambda_mode(qp)
                    best = None
                    for dq in (0, -1, 1):
                        q2 = int(np.clip(qp + dq, 1, 51))
                        cand = encode_p_frame(
                            yuv, refs_in, p, qp=q2, frame_num=frame_num,
                            sr=self.sr, force_intra_mask=fim,
                            use_satd=self.use_satd, wp=wp,
                            me_method=self.me_method)
                        ssd = float(((np.asarray(yuv[0], np.float64)
                                      - np.asarray(cand[1][0], np.float64))
                                     ** 2).sum())
                        j = ssd + lam * cand[3]["bits"]
                        if best is None or j < best[0]:
                            best = (j, q2, cand)
                    _, pic_qp, (rbsp, rec, pctx, stats) = best
                    self.pic_qps.append(pic_qp)
                    if pic_qp != qp:
                        ctx = DeblockContext(p.mb_w, p.mb_h, pic_qp,
                                             p.chroma_qp_offset)
                else:
                    rbsp, rec, pctx, stats = encode_p_frame(
                        yuv, refs_in, p, qp=qp, frame_num=frame_num,
                        sr=self.sr, force_intra_mask=fim,
                        use_satd=self.use_satd, wp=wp,
                        me_method=self.me_method)
                if p.redundant_slices:
                    # coarser stand-alone re-encode of the same picture
                    # (same refs/frame_num), marked redundant_pic_cnt=1;
                    # its recon is discarded — the primary drives the
                    # prediction chain (JM RedundantPicture semantics)
                    red, _, _, rstats = encode_p_frame(
                        yuv, refs_in, p,
                        qp=min(qp + p.redundant_qp_offset, 51),
                        frame_num=frame_num, sr=self.sr,
                        force_intra_mask=fim, use_satd=self.use_satd,
                        wp=wp, redundant_pic_cnt=1,
                        me_method=self.me_method)
                    rbsp = ([rbsp] if not isinstance(rbsp, list)
                            else list(rbsp)) + [red]
                    stats = dict(stats, bits=stats["bits"] + rstats["bits"])
                ctx.mb_intra = pctx["mb_intra"]
                ctx.nnz = pctx["nnz"]
                ctx.mv = pctx["mvf"].mv
                ctx.ref = pctx["mvf"].ref
                frame_num = (frame_num + 1) % (1 << p.log2_max_frame_num)
                ftype = "P"
            if p.deblock:
                rec = deblock_frame(*rec, ctx)
            dpb.insert(0, RefPlanes(*rec))
            dpb = dpb[:max(p.num_ref_frames, 1)]
            dpb_means.insert(0, tuple(float(np.asarray(pl).mean())
                                      for pl in rec))
            dpb_means = dpb_means[:max(p.num_ref_frames, 1)]
            for r in (rbsp if isinstance(rbsp, list) else [rbsp]):
                slices.append((idr, r))
            rec8 = tuple(np.asarray(pl, np.uint8) for pl in rec)
            mse = ((np.asarray(yuv[0], np.float64) - rec8[0]) ** 2).mean()
            res = AVCFrameResult(
                frame_type=ftype, bits=stats["bits"],
                psnr_y=99.99 if mse == 0 else
                float(10 * np.log10(255.0 ** 2 / mse)),
                recon=rec8)
            results.append(res)
            if verbose:
                print(f"frame {idx:3d} {ftype:3s} bits {res.bits:7d} "
                      f"PSNR-Y {res.psnr_y:6.2f}")
        stream = assemble_stream(p, slices)
        if sei_at:
            # splice a recovery_point SEI before each open-GOP I slice
            nals, out, vcl = list(annexb_parse(stream)), [], 0
            for n in nals:
                if n.nal_type in (1, 5):
                    if vcl in sei_at:
                        out.append(SEI.sei_nalu(
                            [(SEI.RECOVERY_POINT,
                              SEI.recovery_point_payload(0))]))
                    vcl += 1
                out.append(n)
            stream = annexb_write(out)
        return results, stream

    def _encode_sequence_b(self, frames, qp=None, verbose=False):
        """IbbP GOP: anchors every (bframes+1) display positions, coded
        first; disposable B pictures (spatial direct) between them.
        Results return in DISPLAY order; the stream is in decode order
        (JM ``pred_struct.c`` populate_frm_struct IBBP shape)."""
        p = self.p
        qp = p.qp if qp is None else qp
        frames = list(frames)
        n = len(frames)
        G = self.bframes + 1
        anchors = sorted(set(list(range(0, n, G)) + [n - 1]))

        slices = []
        results = [None] * n
        anchor_data = {}              # disp idx -> (rec, motion(mv,ref))
        frame_num = 0
        prev_a = None
        for a in anchors:
            yuv = frames[a]
            ctx = DeblockContext(p.mb_w, p.mb_h, qp, p.chroma_qp_offset)
            if a == 0:
                rbsp, rec, stats = encode_i_frame(yuv, p, qp=qp,
                                                  frame_num=0, idr=True)
                slices.append((True, rbsp, 3))
                frame_num = 1
                motion = (np.zeros((p.mb_h * 4, p.mb_w * 4, 2), np.int64),
                          np.full((p.mb_h * 4, p.mb_w * 4), -1, np.int64))
                ftype = "IDR"
            else:
                ref_list = [anchor_data[prev_a]["rp"]]
                rbsp, rec, pctx, stats = encode_p_frame(
                    yuv, ref_list, p, qp=qp, frame_num=frame_num,
                    sr=self.sr, use_satd=self.use_satd, poc_lsb=2 * a)
                ctx.mb_intra = pctx["mb_intra"]
                ctx.nnz = pctx["nnz"]
                ctx.mv = pctx["mvf"].mv
                ctx.ref = pctx["mvf"].ref
                slices.append((False, rbsp, 2))
                frame_num += 1
                motion = (pctx["mvf"].mv.copy(), pctx["mvf"].ref.copy())
                ftype = "P"
            if p.deblock:
                rec = deblock_frame(*rec, ctx)
            rec8 = tuple(np.asarray(pl, np.uint8) for pl in rec)
            anchor_data[a] = dict(rp=RefPlanes(*rec), motion=motion,
                                  rec=rec8)
            mse = ((np.asarray(yuv[0], np.float64) - rec8[0]) ** 2).mean()
            results[a] = AVCFrameResult(
                frame_type=ftype, bits=stats["bits"],
                psnr_y=99.99 if mse == 0 else
                float(10 * np.log10(255.0 ** 2 / mse)), recon=rec8)

            if prev_a is not None:
                for b in range(prev_a + 1, a):
                    yuvb = frames[b]
                    rbsp, recb, bctx, stats = encode_b_frame(
                        yuvb, [anchor_data[prev_a]["rp"]],
                        [anchor_data[a]["rp"]], anchor_data[a]["motion"],
                        p, qp=qp, frame_num=frame_num, poc_lsb=2 * b,
                        sr=self.sr, use_satd=self.use_satd,
                        ref_pocs0=[2 * prev_a], ref_pocs1=[2 * a])
                    ctxb = DeblockContext(p.mb_w, p.mb_h, qp,
                                          p.chroma_qp_offset)
                    ctxb.mb_intra = bctx["mb_intra"]
                    ctxb.nnz = bctx["nnz"]
                    ctxb.mv = bctx["mv"]
                    ctxb.ref = bctx["ref"]
                    ctxb.mv1 = bctx["mv1"]
                    ctxb.ref1 = bctx["ref1"]
                    if p.deblock:
                        recb = deblock_frame(*recb, ctxb)
                    rec8b = tuple(np.asarray(pl, np.uint8) for pl in recb)
                    slices.append((False, rbsp, 0))
                    mse = ((np.asarray(yuvb[0], np.float64)
                            - rec8b[0]) ** 2).mean()
                    results[b] = AVCFrameResult(
                        frame_type="B", bits=stats["bits"],
                        psnr_y=99.99 if mse == 0 else
                        float(10 * np.log10(255.0 ** 2 / mse)),
                        recon=rec8b)
                    if verbose:
                        print(f"frame {b:3d} B   bits {stats['bits']:7d}")
            prev_a = a
        return results, assemble_stream(p, slices)

    @staticmethod
    def decode_sequence(stream: bytes, trace: bool = False):
        """Decode an Annex-B stream (ours or JM's); returns frame list
        (and the decoder, for .trace)."""
        dec = AVCDecoder(trace=trace)
        return dec.decode(stream), dec
