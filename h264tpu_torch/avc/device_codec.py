"""Sequence encoder for the conformant H.264 encoder on one device.

Port of ``h264tpu/avc/tpu_codec.py`` ``TPUAVCCodec``: every frame's
decisions and residuals come from ``avc/device_enc.py`` on the device; the
host packs the slices and applies the spec deblocking filter with the
native C++ stages (``avc/native.py``), and assembles the Annex-B stream.
As in ``TPUAVCCodec``, P slices with P_8x8 sub-partitions are packed by the
numpy packer (``avc/pack.py``): the C packer has no ``sub_mb_type``; CABAC
slices by the Python packer ``avc/pack_cabac.py``.
Reference pictures stay on the device as phase-split quarter-pel planes.
In IPPP a frame's symbols come to the host at the same sync as its
reconstruction, which the deblock needs before the next frame can start;
its slices are packed after the next frame's device work has been queued.

Ported: IPPP with periodic IDR, CAVLC and CABAC, full-RD mode decision with
adaptive rounding and RD-gated decimation, row-band slices, multiple
reference frames, High profile's per-MB 8x8 transform, P_8x8
sub-partitions (``sub8x8``) and the spec default scaling lists, explicit
weighted prediction (CAVLC IPPP; ``wp_method`` "dc" or "lms"), quadratic
rate control (``encode_sequence(rate_control=...)``, with one QP per
row-band slice in ``rc_mode`` 3), data partitioning (CAVLC IPPP), and B
pictures (``bframes``: IbbP, or the dyadic hierarchical GOP of 4 with
``hierarchical=True``) with spatial direct, under CAVLC or CABAC, and a
device mesh (``mesh=``: the row-band slices of every I, P and B picture split
over the slots of one ``parallel.Mesh`` axis, byte-identical to the unsharded
stream).  The option pairs ``TPUAVCCodec`` refuses raise
``NotImplementedError``, as there: WP or basic-unit rate control with a mesh
among them.

A visible size that is not a multiple of 16 (1920x1080) is coded as the next
one (1920x1088), as JM's ``auto_crop_bottom`` codes it: the source is padded
by repeating its last row and column, the SPS crops the padding off, and the
reference pictures, the deblock and the stream hold the coded picture while
PSNR and the reported reconstruction cover the visible one.  IPPP takes such
a size; B pictures, the mesh, WP, basic-unit rate control and MVC raise
``NotImplementedError``.

Reference: ``JM/lencod/src/lencod.c:876`` encode_sequence.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from .. import resolve_device, trace
from . import conformance
from . import device_enc as DE
from . import native as AN
from . import pack as PK
from . import pack_cabac as PKC
from .deblock import DeblockContext
from .params import AVCParams, assemble_stream, crop_window, SLICE_I, SLICE_P
from .wp import estimate_wp, estimate_wp_lms
from .codec import AVCFrameResult


# symbol fields and their per-MB widths, as TPUAVCCodec transfers them; t8,
# sub and mvd_s come only from the options that make them (t8: the 8x8
# transform, sub/mvd_s: sub-8x8 partitions), the last four only from B
# frames (which have no "ri"/"mvd")
_SYM_KEYS = (("win", 1), ("ri", 1), ("mvd", 8), ("i4flags", 32),
             ("i16mode", 1), ("i16dc", 16), ("cmode", 1), ("cbp_luma", 1),
             ("cbp_chroma", 1), ("zz", 256), ("cdc", 8), ("cac", 120),
             ("mb_intra", 1), ("t8", 1), ("sub", 4), ("mvd_s", 32),
             ("ri0", 1), ("ri1", 1), ("mvd0", 2), ("mvd1", 2))
_SYM_SHAPES = {"mvd": (4, 2), "i4flags": (16, 2), "zz": (16, 16),
               "cdc": (2, 4), "cac": (2, 2, 2, 15), "mvd_s": (4, 4, 2)}


def host_symbols(sym: dict, dtype=torch.int16) -> dict:
    """Device symbols -> the host arrays the packer reads, in one transfer:
    int16 of the shapes ``tpu_codec._unpack_sym`` gives (I and P frames),
    or int32 as ``TPUAVCCodec`` downloads a B frame's."""
    nmb = sym["win"].shape[0]
    keys = [(k, w) for k, w in _SYM_KEYS if k in sym]
    flat = torch.cat([sym[k].reshape(nmb, -1).to(dtype)
                      for k, w in keys], 1).cpu().numpy()
    out, off = {}, 0
    for k, w in keys:
        a = flat[:, off:off + w]
        off += w
        out[k] = a[:, 0] if w == 1 else \
            a.reshape(nmb, *_SYM_SHAPES.get(k, (w,)))
    return out


def host_context(ctx: dict, rec) -> tuple:
    """Device deblocking context and reconstruction -> host numpy, as the
    JAX package's ``tpu_codec._unpack_ctx_rec`` gives them."""
    out = dict(nnz=ctx["nnz"].to(torch.int16).cpu().numpy(),
               mv=ctx["mv"].to(torch.int16).cpu().numpy(),
               ref=ctx["ref"].to(torch.int16).cpu().numpy(),
               mb_intra=ctx["mb_intra"].cpu().numpy().astype(bool),
               t8=(ctx["t8"].cpu().numpy().astype(bool) if "t8" in ctx
                   else np.zeros(ctx["mb_intra"].shape, bool)))
    return out, tuple(pl.to(torch.uint8).cpu().numpy().astype(np.int64)
                      for pl in rec)


def deblock_context(ctx_np: dict, mb_h: int, mb_w: int, qp: int,
                    chroma_qp_offset: int, idr: bool,
                    slice_qps=None, pocs=None) -> DeblockContext:
    """The deblocking context of a frame from its host ``ctx``, as
    ``TPUAVCCodec`` builds it: inter state for P and B frames, and for 8x8-
    transform MBs the four 4x4 counts of each 8x8 summed over its cells
    (bS tests the 8x8 block's coded status; internal 4x4 edges skip).
    ``slice_qps``: one QP per row-band slice (basic-unit rate control; the
    filter averages neighbour MB QPs across the band edge).  ``pocs``: a B
    picture's (list-0 POC, list-1 POC), to which its two MV fields' ref
    index 0 maps (-1 where a list is unused)."""
    ctx = DeblockContext(mb_w, mb_h, qp, chroma_qp_offset)
    if slice_qps is not None:
        rows = mb_h // len(slice_qps)
        for s, q in enumerate(slice_qps):
            ctx.mb_qp[s * rows:(s + 1) * rows, :] = q
    if not idr:
        ctx.mb_intra = np.asarray(ctx_np["mb_intra"], bool)
        ctx.nnz = np.asarray(ctx_np["nnz"], np.int64)
        if pocs is None:
            ctx.mv = np.asarray(ctx_np["mv"], np.int64)
            ctx.ref = np.asarray(ctx_np["ref"], np.int64)
        else:
            ctx.mv, ctx.mv1 = ctx_np["mv0"], ctx_np["mv1"]
            ctx.ref, ctx.ref1 = (np.where(ctx_np["ref" + x] == 0, poc, -1)
                                 for x, poc in zip("01", pocs))
    t8 = ctx_np.get("t8")
    if t8 is not None and t8.any():
        ctx.transform8 = t8
        q = ctx.nnz.reshape(mb_h * 2, 2, mb_w * 2, 2).sum(axis=(1, 3))
        q = np.repeat(np.repeat(q, 2, 0), 2, 1)
        m8 = np.repeat(np.repeat(t8, 4, 0), 4, 1)
        ctx.nnz = np.where(m8, q, ctx.nnz)
    return ctx


_HOST_SPANS = dict(pack="avc.pack", deblock="avc.host_deblock")


def pad_edge(pl: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """A [rows, cols] plane padded to [h, w] by repeating its last column,
    then its last row (JM ``PaddAutoCropBorders``)."""
    rows, cols = pl.shape
    if w > cols:
        pl = torch.cat([pl, pl[:, -1:].expand(rows, w - cols)], 1)
    if h > rows:
        pl = torch.cat([pl, pl[-1:].expand(h - rows, w)], 0)
    return pl


@dataclasses.dataclass
class _Picture:
    """A picture between its device encode and its result: its trace
    ``(seq, idx)`` (``idx`` in display order), type ("IDR", "P" or "B"),
    source, frame QP, per-slice QPs (basic-unit rate control), slice-header
    arguments of its packer, a B picture's list POCs, and once downloaded,
    its host symbols and uint8 reconstruction."""
    seq: int
    idx: int
    ftype: str
    yuv: tuple
    qp: int
    hdr: dict
    qps: list = None
    pocs: tuple = None
    sym: dict = None
    rec8: tuple = None


class DeviceAVCCodec:
    """Baseline/Main/High H.264 encoder with all pixel work on one device."""

    def __init__(self, p: AVCParams, intra_period: int = 0,
                 search_range: int = 16, n_slices: int = 1, mesh=None,
                 mesh_axis: str = "slice", bframes: int = 0,
                 hierarchical: bool = False, sub8x8: bool = False,
                 data_partitioning: bool = False, wp_method: str = "dc",
                 device=None):
        """``n_slices``: equal row-band slices per picture (must divide
        mb_h); the decision scan runs them side by side.
        ``data_partitioning``: P slices as NAL 2/3/4 partitions (CAVLC
        IPPP).  ``wp_method``: the explicit-WP estimator when
        ``p.weighted_pred`` — "dc" (DC ratio) or "lms" (least-squares gain
        and offset over host copies of the recent reconstructions).
        ``mesh``: a ``parallel.Mesh``; each picture's ``n_slices`` slices
        are split over the slots of its axis ``mesh_axis`` (``n_slices`` a
        multiple of their count), each slot encoding its bands on its own
        device (``device_enc.make_sharded_encode``); the stream is
        byte-identical to the unsharded one.
        ``device``: None is the CUDA card (raises without one), or the
        mesh's first slot when a mesh is given; pass "cpu" for the plain
        PyTorch path on the host."""
        # TPUAVCCodec's own limits
        if wp_method not in ("dc", "lms"):
            raise ValueError(f"wp_method {wp_method!r}")
        if sub8x8 and (p.cabac or bframes > 0):
            raise NotImplementedError("P8x8 sub-partitions are "
                                      "CAVLC-IPPP for now")
        if data_partitioning and (p.cabac or bframes > 0):
            raise NotImplementedError("data partitioning is CAVLC "
                                      "P/I only (spec 7.4.1)")
        if p.scaling_matrix is not None:
            if p.scaling_matrix != "default":
                raise NotImplementedError("only the spec default "
                                          "matrices are supported")
            if p.profile_idc < 100:
                raise ValueError("scaling lists need High profile")
            if bframes > 0:
                raise NotImplementedError("scaling lists in the B "
                                          "driver are not wired")
        if bframes > 0:
            if p.poc_type != 0:
                raise ValueError("bframes needs AVCParams(poc_type=0)")
            if p.profile_idc == 66:
                raise ValueError("B slices need Main profile (77)")
            if hierarchical and bframes != 3:
                raise ValueError("hierarchical GOP supports bframes=3 "
                                 "(dyadic GOP of 4) for now")
            if hierarchical and p.num_ref_frames < 3:
                # the decoder's DPB must hold {prev anchor, ref B, anchor}
                raise ValueError("hierarchical GOP needs "
                                 "num_ref_frames >= 3")
        if p.transform_8x8 and bframes > 0:
            raise NotImplementedError("8x8 transform in the B driver "
                                      "is not wired yet")
        if p.weighted_pred and (bframes > 0 or p.cabac
                                or mesh is not None):
            raise NotImplementedError("device WP is CAVLC-IPPP "
                                      "single-mesh for now")
        if p.slice_groups != 1:
            raise ValueError("the device path has no FMO")
        if p.mb_h % n_slices:
            raise ValueError(f"n_slices {n_slices} must divide {p.mb_h}")
        if p.cropped and (bframes > 0 or mesh is not None
                          or p.weighted_pred):
            raise NotImplementedError(
                f"cropping ({p.width}x{p.height} coded as "
                f"{p.coded_width}x{p.coded_height}) is IPPP without a mesh "
                "or WP for now")
        if mesh is not None:
            DE.band_slots(mesh, mesh_axis, p.mb_h, n_slices)
        self.device = resolve_device(
            device if device is not None or mesh is None
            else mesh.devices.flat[0])
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self._sharded = {}
        self.p = p
        self.intra_period = intra_period
        self.sr = search_range
        self.n_slices = n_slices
        self.sub8x8 = sub8x8
        self.bframes = bframes
        self.hierarchical = hierarchical
        self.data_partitioning = data_partitioning
        self.wp_method = wp_method
        conformance.check_params(p)
        self._dummy = None
        # host milliseconds per frame of the slice packer and the deblock
        self.host_ms = dict(pack=[], deblock=[])

    def _frame_encoder(self, kind: str):
        """The frame encoder of "I", "P" or "B" pictures:
        ``device_enc.encode_frame`` or ``encode_frame_b``, or its
        mesh-sharded twin (made once per kind)."""
        p = self.p
        kw = dict(mb_h=p.mb_h, mb_w=p.mb_w, sr=self.sr, n_slices=self.n_slices,
                  chroma_qp_offset=p.chroma_qp_offset)
        if kind != "B":
            kw.update(intra_only=kind == "I", transform8=p.transform_8x8,
                      sub8x8=self.sub8x8,
                      scaling_default=p.scaling_matrix == "default")
        if self.mesh is None:
            return lambda *a: (DE.encode_frame_b if kind == "B"
                               else DE.encode_frame)(*a, **kw)
        if kind not in self._sharded:
            self._sharded[kind] = (DE.make_sharded_encode_b if kind == "B"
                                   else DE.make_sharded_encode)(
                self.mesh, self.mesh_axis, **kw)
        return self._sharded[kind]

    def _is_idr(self, idx: int) -> bool:
        return idx == 0 or (self.intra_period > 0
                            and idx % self.intra_period == 0)

    def _dummy_refs(self):
        """Zero reference stack for intra frames (R = 1)."""
        if self._dummy is None:
            p, sr, dev = self.p, self.sr, self.device
            P, PC = DE.luma_pad(sr), DE.chroma_pad(sr)
            H, W = p.coded_height, p.coded_width
            self._dummy = (
                torch.zeros((1, 4, 4, H + 2 * P, W + 2 * P), dtype=torch.uint8,
                            device=dev),
                torch.zeros((1, H // 2 + 2 * PC, W // 2 + 2 * PC),
                            dtype=torch.int32, device=dev),
                torch.zeros((1, H // 2 + 2 * PC, W // 2 + 2 * PC),
                            dtype=torch.int32, device=dev))
        return self._dummy

    def planes(self, yuv):
        """(Y, U, V) uint8 planes of the visible size -> int32 tensors of
        the coded size on the codec's device (span ``avc.upload``): the
        visible planes are copied, then padded there by ``pad_edge``."""
        p = self.p
        with trace.span("avc.upload", self.device):
            out = tuple(torch.as_tensor(np.ascontiguousarray(pl, np.uint8))
                        .to(self.device).to(torch.int32) for pl in yuv)
            if p.cropped:
                h, w = p.coded_height, p.coded_width
                out = tuple(pad_edge(pl, h >> (c > 0), w >> (c > 0))
                            for c, pl in enumerate(out))
            return out

    def prep(self, rec8):
        """``prep_ref`` of a deblocked (Y, U, V) uint8 reconstruction (span
        ``avc.prep``)."""
        with trace.span("avc.prep", self.device):
            return DE.prep_ref(*(torch.as_tensor(pl).to(self.device)
                                 for pl in rec8), self.sr)

    def encode_frame(self, yuv, refs, qp, force=None, n_refs=None, wp=None):
        """Device encode of one frame against ``refs`` (a list of
        ``prep_ref`` entries, newest first; empty for an IDR), stacked to
        ``n_refs`` entries (default ``num_ref_frames``).  ``qp``: the frame
        QP, or one QP per slice.  ``wp``: the P frame's explicit-WP table
        (``estimate_wp``'s dict, one ``l0`` entry per stacked reference):
        each reference's luma planes are weighted here, its chroma weights
        go to the decision scan.  Returns the device (sym, rec, ctx) of
        ``device_enc.encode_frame``.  Span: ``avc.frame``."""
        with trace.span("avc.frame", self.device):
            p = self.p
            y, u, v = self.planes(yuv)
            if force is None:
                force = torch.zeros((p.mb_h, p.mb_w), dtype=torch.bool,
                                    device=self.device)
            if not refs:
                return self._frame_encoder("I")(
                    y, u, v, *self._dummy_refs(), qp, 0, force)
            R = max(p.num_ref_frames, 1) if n_refs is None else n_refs
            n_valid = min(len(refs), R)
            sel = [refs[min(i, n_valid - 1)] for i in range(R)]
            stacks = [torch.stack([r[k] for r in sel]) for k in range(3)]
            wp_c = None
            if wp is not None:
                stacks[0] = torch.stack([DE.weight_luma(r[0], e[0], e[1])
                                         for r, e in zip(sel, wp["l0"])])
                wp_c = torch.as_tensor(np.array([e[2:6] for e in wp["l0"]],
                                                np.int32)).to(self.device)
            return self._frame_encoder("P")(y, u, v, *stacks, qp, n_valid,
                                             force, wp_c)

    def _pack(self, pic: _Picture) -> list:
        """The slices of a picture: the one place a packer is chosen.  The
        native CAVLC packer writes no sub_mb_type, data partitions or list
        reordering, and a B-GOP sequence packs every picture in numpy (POC
        LSB, MMCO); CABAC slices go to the Python packers."""
        p, h, idr = self.p, pic.hdr, pic.ftype == "IDR"
        rows = p.mb_h // self.n_slices
        native = not (p.cabac or self.bframes or "reorder_l0" in h) and (
            idr or not (self.sub8x8 or self.data_partitioning))
        if pic.ftype == "B":
            fn = PKC.pack_b_slice_cabac if p.cabac else PK.pack_b_slice
        elif idr:
            fn = PKC.pack_i_slice_cabac if p.cabac else PK.pack_i_slice
        else:
            fn = PKC.pack_p_slice_cabac if p.cabac else PK.pack_p_slice
        rbsps = []
        for s in range(self.n_slices):
            q = pic.qp if pic.qps is None else pic.qps[s]
            band = dict(row0=s * rows, n_rows=rows)
            if native and idr:
                rb = AN.pack_slice(pic.sym, p, SLICE_I, q, 0, True,
                                   h["idr_pic_id"], 1, **band)
            elif native:
                rb = AN.pack_slice(pic.sym, p, SLICE_P, q, h["frame_num"],
                                   False, 0, h["num_ref"], **band,
                                   wp=h.get("wp"))
            else:
                if self.data_partitioning:
                    band["dp_slice_id"] = s
                rb = fn(pic.sym, p, q, **band, **h)
            rbsps.append(rb)
        return rbsps

    @contextlib.contextmanager
    def _host_timed(self, key: str, frame):
        """A picture's host pack or deblock: its span (``avc.pack``,
        ``avc.host_deblock``) and its ``host_ms[key]`` entry."""
        with trace.span(_HOST_SPANS[key], frame=frame):
            t0 = time.perf_counter()
            yield
            self.host_ms[key].append((time.perf_counter() - t0) * 1e3)

    def _host_stage(self, pic: _Picture, sym, rec, tctx) -> dict:
        """The first half of a picture's host stage: the downloads of its
        device outputs (span ``avc.wait``, ``avc.b.wait`` for a B picture)
        and the host deblock (span ``avc.host_deblock``, one
        ``host_ms["deblock"]`` entry).  Sets ``pic.sym`` and ``pic.rec8``;
        returns the host deblocking context."""
        p, frame = self.p, (pic.seq, pic.idx)
        if pic.ftype == "B":
            with trace.span("avc.b.wait", frame=frame):
                pic.sym = host_symbols(sym, torch.int32)
                ctx_np = {k: v.cpu().numpy().astype(np.int64)
                          for k, v in tctx.items()}
                rec_np = tuple(pl.cpu().numpy().astype(np.int64)
                               for pl in rec)
        else:
            with trace.span("avc.wait", frame=frame):
                pic.sym = host_symbols(sym)
                ctx_np, rec_np = host_context(tctx, rec)
        if p.deblock:
            with self._host_timed("deblock", frame):
                ctx = deblock_context(ctx_np, p.mb_h, p.mb_w, pic.qp,
                                      p.chroma_qp_offset, pic.ftype == "IDR",
                                      pic.qps, pic.pocs)
                rec_np = AN.deblock_frame(*rec_np, ctx)
        pic.rec8 = tuple(np.asarray(pl, np.uint8) for pl in rec_np)
        return ctx_np

    def _finish(self, pic: _Picture, verbose: bool = False) -> tuple:
        """The second half: the pack (span ``avc.pack``, one
        ``host_ms["pack"]`` entry), then the picture's result with its bits
        and PSNR, and ``trace.frame_done``.  Returns (result, slices)."""
        with self._host_timed("pack", (pic.seq, pic.idx)):
            rbsps = self._pack(pic)
        p = self.p
        recon = crop_window(pic.rec8, p.crop_offsets)
        mse = ((np.asarray(pic.yuv[0], np.float64) - recon[0]) ** 2).mean()
        res = AVCFrameResult(
            frame_type=pic.ftype,
            bits=sum(len(x) for rb in rbsps
                     for x in (rb if isinstance(rb, tuple) else (rb,))) * 8,
            psnr_y=99.99 if mse == 0 else
            float(10 * np.log10(255.0 ** 2 / mse)), recon=recon,
            coded=pic.rec8 if p.cropped else None)
        trace.frame_done(pic.seq, pic.idx, pic.ftype)
        if verbose:
            print(f"frame {pic.idx:3d} {pic.ftype:3s} "
                  f"bits {res.bits:7d} PSNR-Y {res.psnr_y:6.2f}")
        return res, rbsps

    def encode_sequence(self, frames, qp: int = None, verbose: bool = False,
                        force_intra=None, rate_control=None):
        """frames: iterable of (Y, U, V) uint8.  Returns (results, Annex-B
        stream bytes) like ``TPUAVCCodec.encode_sequence``.

        ``rate_control``: a ``models.ratectl.QuadraticRateControl``; the
        QP of every frame after the first comes from its quadratic R-Q
        model instead of ``qp``.  With ``rc_mode=3`` and more than one
        slice, each row-band slice is a basic unit: QP becomes one value
        per slice (the frame target split by the previous frame's measured
        per-unit MAD), each slice header carries its own slice_qp_delta,
        and the frame QP is their rounded mean.  B sequences
        (``bframes``) take no rate control, as in ``TPUAVCCodec``: the
        controller is not consulted there.  Each call is one ``trace``
        sequence (frames taken as the iterator yields them, done once
        packed); the host spans are ``avc.wait`` (the symbols' and the
        reconstruction's downloads), ``avc.host_deblock`` and ``avc.pack``.
        A frame is downloaded and deblocked at once, and packed once the
        next frame's device work is queued."""
        p = self.p
        qp = p.qp if qp is None else qp
        if self.bframes > 0:
            return self._encode_sequence_b(frames, qp, verbose)
        rc = rate_control
        bu = (rc is not None and getattr(rc, "rc_mode", 1) == 3
              and self.n_slices > 1)
        if bu:
            if self.mesh is not None:
                raise NotImplementedError(
                    "basic-unit RC is not mesh-sharded yet")
            if p.cropped:
                raise NotImplementedError(
                    "basic-unit RC does not take cropping yet")
            rc.basic_units = self.n_slices     # BU = one row-band slice
        R = max(p.num_ref_frames, 1)
        rows = p.mb_h // self.n_slices
        slices, results, dpb = [], [], []
        dpb_means, dpb_recs = [], []   # per-entry (dc_y, dc_u, dc_v); rec8s
        frame_num = idr_pic_id = 0
        pending = None
        seq = trace.sequence()

        def finalize(pic):
            """Pack ``pic``, and feed its bits to the rate controller."""
            res, rbsps = self._finish(pic, verbose)
            slices.extend((pic.ftype == "IDR", rb) for rb in rbsps)
            results.append(res)
            if rc is not None:
                mse_y = 255.0 ** 2 / (10.0 ** (res.psnr_y / 10.0))
                rc.update(res.bits, pic.qp, float(np.sqrt(mse_y)),
                          ftype="P" if pic.ftype == "P" else "I")

        for idx, yuv in enumerate(frames):
            trace.frame_taken(seq, idx)
            idr = self._is_idr(idx)
            qp_s = None                      # per-slice QPs (basic-unit RC)
            if rc is not None and idx > 0:
                # rate control needs the previous frame's bits now
                if pending is not None:
                    finalize(pending)
                    if bu and pending.ftype == "P":
                        # the measured per-unit MAD (reconstruction error)
                        # feeds this frame's per-unit target split
                        d = np.abs(np.asarray(pending.yuv[0], np.int64)
                                   - pending.rec8[0].astype(np.int64))
                        rc.update_basic_units(
                            [float(d[s * rows * 16:(s + 1) * rows * 16]
                                   .mean()) for s in range(self.n_slices)])
                    pending = None
                if bu and not idr:
                    qp_s = [int(v) for v in rc.basic_unit_qps(self.n_slices)]
                    qp = int(round(np.mean(qp_s)))
                else:
                    qp = rc.frame_qp("I" if idr else "P")
            wp = None
            if idr:
                dpb, dpb_means, dpb_recs = [], [], []
                hdr = dict(frame_num=0, idr=True, idr_pic_id=idr_pic_id)
                idr_pic_id = (idr_pic_id + 1) & 0xFFFF
                fim = None
            else:
                n_valid = min(len(dpb), R)
                if p.weighted_pred:
                    pad = [min(i, n_valid - 1) for i in range(R)]
                    wp = (estimate_wp_lms(yuv, [dpb_recs[i] for i in pad])
                          if self.wp_method == "lms" else
                          estimate_wp(yuv, [dpb_means[i] for i in pad]))
                hdr = dict(frame_num=frame_num, num_ref=n_valid)
                if wp is not None:
                    hdr["wp"] = wp
                fim = force_intra(idx) if force_intra else None
                if fim is not None:
                    fim = torch.as_tensor(np.asarray(fim, bool)).to(self.device)
            pic = _Picture(seq, idx, "IDR" if idr else "P", yuv, qp, hdr,
                           qps=qp_s)
            out = self.encode_frame(yuv, dpb, qp if qp_s is None else qp_s,
                                    fim, wp=wp)
            frame_num = 1 if idr else (frame_num + 1) % (1 << p.log2_max_frame_num)

            # pack the previous frame once this frame's work is queued
            if pending is not None:
                finalize(pending)
            self._host_stage(pic, *out)
            dpb.insert(0, self.prep(pic.rec8))
            dpb = dpb[:R]
            if p.weighted_pred:
                dpb_means.insert(0, tuple(float(pl.mean()) for pl in pic.rec8))
                dpb_means = dpb_means[:R]
                if self.wp_method == "lms":
                    dpb_recs.insert(0, pic.rec8)
                    dpb_recs = dpb_recs[:R]
            pending = pic
        if pending is not None:
            finalize(pending)
        return results, assemble_stream(p, slices)

    def _encode_sequence_b(self, frames, qp: int, verbose: bool = False):
        """B-GOP sequence encode (port of ``tpu_codec._tpu_b_sequence``).

        ``bframes`` disposable B pictures between anchors (IbbP), or with
        ``hierarchical`` the dyadic GOP of 4 of ``JM/lencod/src/
        pred_struct.c`` populate_frm_struct: anchor P, then a reference B
        at the midpoint (its own DPB slot, dropped by MMCO at the next
        anchor), then the two leaf Bs predicting from it; QP cascade
        anchor qp, reference B qp+1, leaf B qp+2.  Anchors predict from the
        previous anchor alone.  The stream is in decode order, the results
        in display order.  Like ``TPUAVCCodec``'s B sequences it takes no
        rate control: ``encode_sequence`` hands the call here before it
        reads ``rate_control``, so a controller is never consulted.

        The source is read one GOP ahead, as a live encoder buffers it: the
        IDR is taken and coded, then up to ``bframes + 1`` frames are taken
        and coded as one GOP whose anchor is the last of them, and so on;
        a source that ends inside a GOP makes its last frame the anchor
        (the anchors of ``TPUAVCCodec``: every ``bframes + 1``-th frame and
        the last).  One ``trace`` sequence: a frame is taken when it is
        read from the source and done once packed; the spans are
        ``avc.b.frame`` (a B picture's device encode), ``avc.b.wait`` and
        ``avc.wait`` (a B picture's and an anchor's downloads),
        ``avc.host_deblock`` and ``avc.pack``.  Each picture is downloaded,
        deblocked and packed at once."""
        p = self.p
        G = self.bframes + 1
        mb_h, mb_w = p.mb_h, p.mb_w
        max_fn = 1 << p.log2_max_frame_num
        max_poc = 1 << p.log2_max_poc_lsb
        slices, results = [], []
        fn_state = dict(frame_num=0)
        seq = trace.sequence()
        source = iter(frames)
        held = {}                       # display index -> frame not yet coded

        def take() -> bool:
            """Read the source's next frame into ``held``; False at its
            end."""
            yuv = next(source, held)
            if yuv is held:
                return False
            idx = len(results)
            trace.frame_taken(seq, idx)
            held[idx] = yuv
            results.append(None)
            return True

        def finish(pic, out, ref_idc):
            """The picture's host stage; returns its host context."""
            ctx_np = self._host_stage(pic, *out)
            results[pic.idx], rbsps = self._finish(pic, verbose)
            slices.extend((pic.ftype == "IDR", rb, ref_idc) for rb in rbsps)
            return ctx_np

        def encode_b(disp, prep0, poc0, prep1, poc1, col_motion, fqp,
                     ref_pic=False):
            with trace.span("avc.b.frame", self.device, frame=(seq, disp)):
                y, u, v = self.planes(held[disp])
                col_mv, col_ref = (torch.as_tensor(np.asarray(a, np.int32))
                                   .to(self.device) for a in col_motion)
                out = self._frame_encoder("B")(
                    y, u, v, *(x[None] for x in prep0),
                    *(x[None] for x in prep1), col_mv, col_ref, fqp, 1, 1)
            pic = _Picture(seq, disp, "B", held.pop(disp), fqp, dict(
                frame_num=fn_state["frame_num"] % max_fn, num_ref0=1,
                num_ref1=1, poc_lsb=(2 * disp) % max_poc, ref_pic=ref_pic),
                pocs=(poc0, poc1))
            ctx_np = finish(pic, out, 2 if ref_pic else 0)
            if ref_pic:
                fn_state["frame_num"] += 1
            return pic.rec8, (ctx_np["mv0"], ctx_np["ref0"])

        prev = None
        pending_bref_fn = None
        while take():
            # the IDR alone, then up to G frames: a GOP, the last its anchor
            while prev is not None and len(held) < G and take():
                pass
            a = len(results) - 1
            idr = prev is None
            out = self.encode_frame(held[a], [] if idr else [prev["prep"]],
                                    qp, n_refs=1)
            if idr:
                hdr = dict(frame_num=0, idr=True, idr_pic_id=0)
                fn_state["frame_num"] = 1
                anchor_fn = 0
            else:
                frame_num = fn_state["frame_num"]
                mmco = reorder = None
                if pending_bref_fn is not None:
                    # the reference B outranks the previous anchor in the
                    # default list-0 order (higher frame_num): pick the
                    # anchor explicitly (spec 8.2.4.3.1) and drop the
                    # reference B by MMCO once this picture is decoded
                    mmco = [(1, (frame_num - pending_bref_fn - 1) % max_fn)]
                    adiff = (frame_num - prev["fn"] - 1) % max_fn
                    if adiff:
                        reorder = [(0, adiff)]
                hdr = dict(frame_num=frame_num % max_fn, num_ref=1,
                           poc_lsb=(2 * a) % max_poc, mmco=mmco,
                           reorder_l0=reorder)
                pending_bref_fn = None
                anchor_fn = frame_num
                fn_state["frame_num"] += 1
            pic = _Picture(seq, a, "IDR" if idr else "P", held.pop(a), qp, hdr)
            ctx_np = finish(pic, out, 3 if idr else 2)
            motion = ((np.zeros((mb_h * 4, mb_w * 4, 2), np.int64),
                       np.full((mb_h * 4, mb_w * 4), -1, np.int64)) if idr
                      else (ctx_np["mv"].astype(np.int64),
                            ctx_np["ref"].astype(np.int64)))
            cur = dict(prep=self.prep(pic.rec8), motion=motion, poc=2 * a,
                       fn=anchor_fn, disp=a)

            if prev is not None:
                gap = a - prev["disp"]
                if self.hierarchical and gap == 4:
                    m = prev["disp"] + 2
                    bref8, bref_motion = encode_b(
                        m, prev["prep"], prev["poc"], cur["prep"], cur["poc"],
                        cur["motion"], qp + 1, ref_pic=True)
                    pending_bref_fn = fn_state["frame_num"] - 1
                    brefp = self.prep(bref8)
                    encode_b(prev["disp"] + 1, prev["prep"], prev["poc"],
                             brefp, 2 * m, bref_motion, qp + 2)
                    encode_b(prev["disp"] + 3, brefp, 2 * m, cur["prep"],
                             cur["poc"], cur["motion"], qp + 2)
                else:
                    for b in range(prev["disp"] + 1, a):
                        encode_b(b, prev["prep"], prev["poc"], cur["prep"],
                                 cur["poc"], cur["motion"], qp)
            prev = cur
        return results, assemble_stream(p, slices)
