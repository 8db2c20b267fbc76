"""MVC stereo (2-view) on the conformant AVC path (port of
``h264tpu/avc/mvc.py``).

Annex H shape (JM twins: ``JM/lencod/src/pred_struct.c:885`` 2-view
interleave, ``JM/ldecod/src/mbuffer_mvc.c`` inter-view list handling):

* the BASE view is a plain AVC stream (SPS/PPS + IDR/P NALs) — any AVC
  decoder decodes it, skipping the MVC NAL types;
* view 1 rides in a subset SPS (NAL type 15, profile_idc 128 Stereo
  High with seq_parameter_set_mvc_extension) and coded-slice-extension
  NALs (type 20) carrying nal_unit_header_mvc_extension
  (non_idr/priority/view_id/temporal_id/anchor/inter_view, H.7.3.1.1);
* view-1 pictures predict from their own temporal references AND from
  the co-temporal base-view picture, appended to the end of RefPicList0
  per H.8.2.1 (inter-view prediction) — the encoder feeds the base
  view's reconstruction as an extra reference to the same device
  encoder (``DeviceAVCCodec.encode_frame``, R = 2).

``MVCStereoCodec`` encodes (view0, view1) frame pairs;
``AVCDecoder.decode_mvc`` (``slice_dec``) returns both views, with the
inter-view reference injected into the view-1 ref list derivation.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..entropy.bitio import BitWriter, BitReader
from ..bitstream.nal import NALU, annexb_parse, annexb_write, NAL_PPS
from .params import AVCParams, write_sps
from .slice_dec import parse_sps
from .. import trace
from .codec import AVCFrameResult  # noqa: F401  (the results' type)
from .device_codec import DeviceAVCCodec, _Picture

NAL_SUBSET_SPS = 15
NAL_SLICE_EXT = 20


def write_subset_sps(p: AVCParams, num_views: int = 2) -> bytes:
    """subset_seq_parameter_set_rbsp (spec 7.3.2.1.3) with the MVC
    extension for a 2-view stereo set (anchor and non-anchor view-1
    refs: one inter-view ref, view 0, in l0)."""
    pm = dataclasses.replace(p, profile_idc=128)   # Stereo High
    # re-emit the base SPS bit for bit up to its rbsp stop bit, then
    # continue the syntax
    bits = np.unpackbits(np.frombuffer(write_sps(pm), np.uint8))
    stop = int(np.flatnonzero(bits)[-1])
    w = BitWriter()
    w.u(bits[:stop].astype(np.int64), 1)
    # seq_parameter_set_mvc_extension (H.7.3.2.1.4)
    w.u(1, 1)                       # bit_equal_to_one
    w.ue(num_views - 1)             # num_views_minus1
    for v in range(num_views):
        w.ue(v)                     # view_id[i]
    for v in range(1, num_views):   # anchor refs
        w.ue(1)                     # num_anchor_refs_l0
        w.ue(0)                     # anchor_ref_l0: view 0
        w.ue(0)                     # num_anchor_refs_l1
    for v in range(1, num_views):   # non-anchor refs
        w.ue(1)                     # num_non_anchor_refs_l0
        w.ue(0)                     # non_anchor_ref_l0: view 0
        w.ue(0)                     # num_non_anchor_refs_l1
    w.ue(0)                         # num_level_values_signalled_minus1
    w.u(p.level_idc, 8)             # level_idc[0]
    w.ue(0)                         # num_applicable_ops_minus1
    w.u(0, 3)                       # applicable_op_temporal_id
    w.ue(0)                         # applicable_op_num_target_views_minus1
    w.ue(0)                         # applicable_op_target_view_id
    w.ue(0)                         # applicable_op_num_views_minus1
    w.u(0, 1)                       # mvc_vui_parameters_present_flag
    w.u(0, 1)                       # additional_extension2_flag
    w.u(1, 1)                       # rbsp stop
    return w.to_bytes()


def parse_subset_sps(rbsp: bytes) -> dict:
    """Parse the base-SPS part of a subset SPS (the MVC extension tail
    is validated structurally but only num_views/view ids are kept)."""
    return parse_sps(rbsp)          # the base-field parser reads a prefix


def mvc_ext_bytes(non_idr: bool, view_id: int, anchor: bool,
                  inter_view: bool, priority: int = 0,
                  temporal: int = 0) -> bytes:
    """nal_unit_header_mvc_extension (H.7.3.1.1), 3 bytes following the
    svc_extension_flag=0 position (packed MSB-first)."""
    w = BitWriter()
    w.u(0, 1)                       # svc_extension_flag
    w.u(1 if non_idr else 0, 1)
    w.u(priority, 6)
    w.u(view_id, 10)
    w.u(temporal, 3)
    w.u(1 if anchor else 0, 1)
    w.u(1 if inter_view else 0, 1)
    w.u(1, 1)                       # reserved_one_bit
    return w.to_bytes()             # 3 bytes


def parse_mvc_ext(b: bytes) -> dict:
    r = BitReader(b)
    r.u(1)
    return dict(non_idr=bool(r.u(1)), priority=r.u(6), view_id=r.u(10),
                temporal=r.u(3), anchor=bool(r.u(1)),
                inter_view=bool(r.u(1)))


class MVCStereoCodec:
    """2-view stereo encoder over the device encoder.

    View 0: plain IPPP AVC (base layer).  View 1: P pictures whose
    reference stack is [own previous reconstruction, co-temporal view-0
    reconstruction] — the device multi-ref ME/RD picks per-MB between
    temporal and inter-view prediction; the first view-1 picture is an
    anchor (inter-view only).  ``device``: None is the CUDA card (raises
    without one)."""

    def __init__(self, p: AVCParams, search_range: int = 8,
                 n_slices: int = 1, device=None):
        if p.cabac or p.transform_8x8:
            raise NotImplementedError("MVC path is CAVLC 4x4 for now")
        if p.cropped:
            raise NotImplementedError("MVC takes no cropping for now")
        self.p = p
        self.sr = search_range
        self.n_slices = n_slices
        self.base = DeviceAVCCodec(p, intra_period=0,
                                   search_range=search_range,
                                   n_slices=n_slices, device=device)
        self.device = self.base.device

    def encode_sequence(self, frames0, frames1, qp: int = None):
        """Returns (results0, results1, annex-b stream bytes)."""
        p = self.p
        qp = p.qp if qp is None else qp
        res0, base_stream = self.base.encode_sequence(frames0, qp=qp)

        # view-1 pictures through the same device encoder and host stage,
        # R = 2; their host spans carry a trace sequence of the view's own
        res1 = []
        v1_payloads = []
        prev1 = None
        frame_num = 0
        seq = trace.sequence()
        for i, yuv in enumerate(frames1):
            iv = self.base.prep(res0[i].recon)      # inter-view reference
            refs = [iv] if prev1 is None else [prev1, iv]
            out = self.base.encode_frame(yuv, refs, qp, n_refs=2)
            # once the view's temporal window holds 2 pictures, the
            # appended inter-view ref falls outside the active list:
            # emit the MVC ref-list modification (short-term prev at 0,
            # inter-view at 1; idc 5 = inter-view, H.7.3.3.1.1)
            reorder = [(0, 0), (5, 0)] if i >= 2 else None
            pic = _Picture(seq, i, "P", yuv, qp, dict(
                frame_num=frame_num, num_ref=len(refs), reorder_l0=reorder))
            self.base._host_stage(pic, *out)
            res, rbsps = self.base._finish(pic)
            res1.append(res)
            v1_payloads.append((i == 0, rbsps))
            prev1 = self.base.prep(pic.rec8)
            frame_num = (frame_num + 1) % (1 << p.log2_max_frame_num)

        # interleave into one Annex-B stream: subset SPS after the base
        # parameter sets; each access unit = base NALs then view-1 NAL20s
        out = []
        i_vcl = 0
        for n in annexb_parse(base_stream):
            out.append(n)
            if n.nal_type == NAL_PPS:
                out.append(NALU(NAL_SUBSET_SPS, 3, write_subset_sps(p)))
            if n.nal_type in (1, 5):
                # base emits n_slices VCL NALs per picture
                i_vcl += 1
                if i_vcl % self.n_slices == 0:
                    anchor, rbsps = v1_payloads[i_vcl // self.n_slices - 1]
                    ext = mvc_ext_bytes(non_idr=True, view_id=1,
                                        anchor=anchor, inter_view=False)
                    for rb in rbsps:
                        out.append(NALU(NAL_SLICE_EXT, 2, ext + rb))
        return res0, res1, annexb_write(out)
