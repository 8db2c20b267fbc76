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

Reference: ``JM/lencod/src/lencod.c:876`` encode_sequence.
"""

from __future__ import annotations

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
from .params import AVCParams, assemble_stream, SLICE_I, SLICE_P
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
                    slice_qps=None) -> DeblockContext:
    """The deblocking context of a frame from its host ``ctx``, as
    ``TPUAVCCodec`` builds it: inter state for P frames, and for 8x8-
    transform MBs the four 4x4 counts of each 8x8 summed over its cells
    (bS tests the 8x8 block's coded status; internal 4x4 edges skip).
    ``slice_qps``: one QP per row-band slice (basic-unit rate control; the
    filter averages neighbour MB QPs across the band edge)."""
    ctx = DeblockContext(mb_w, mb_h, qp, chroma_qp_offset)
    if slice_qps is not None:
        rows = mb_h // len(slice_qps)
        for s, q in enumerate(slice_qps):
            ctx.mb_qp[s * rows:(s + 1) * rows, :] = q
    if not idr:
        ctx.mb_intra = ctx_np["mb_intra"]
        ctx.nnz = np.asarray(ctx_np["nnz"], np.int64)
        ctx.mv = np.asarray(ctx_np["mv"], np.int64)
        ctx.ref = np.asarray(ctx_np["ref"], np.int64)
    t8 = ctx_np["t8"]
    if t8.any():
        ctx.transform8 = t8
        q = ctx.nnz.reshape(mb_h * 2, 2, mb_w * 2, 2).sum(axis=(1, 3))
        q = np.repeat(np.repeat(q, 2, 0), 2, 1)
        m8 = np.repeat(np.repeat(t8, 4, 0), 4, 1)
        ctx.nnz = np.where(m8, q, ctx.nnz)
    return ctx


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

    def _encode_fn(self, intra_only: bool):
        """The frame encoder of I or P pictures: ``device_enc.encode_frame``,
        or its mesh-sharded twin (made once per kind)."""
        p = self.p
        kw = dict(mb_h=p.mb_h, mb_w=p.mb_w, sr=self.sr, n_slices=self.n_slices,
                  intra_only=intra_only, chroma_qp_offset=p.chroma_qp_offset,
                  transform8=p.transform_8x8, sub8x8=self.sub8x8,
                  scaling_default=p.scaling_matrix == "default")
        if self.mesh is None:
            return lambda *a: DE.encode_frame(*a, **kw)
        if intra_only not in self._sharded:
            self._sharded[intra_only] = DE.make_sharded_encode(
                self.mesh, self.mesh_axis, **kw)
        return self._sharded[intra_only]

    def _encode_fn_b(self):
        """The B frame encoder: ``device_enc.encode_frame_b`` or its
        mesh-sharded twin."""
        p = self.p
        kw = dict(mb_h=p.mb_h, mb_w=p.mb_w, sr=self.sr, n_slices=self.n_slices,
                  chroma_qp_offset=p.chroma_qp_offset)
        if self.mesh is None:
            return lambda *a: DE.encode_frame_b(*a, **kw)
        if "b" not in self._sharded:
            self._sharded["b"] = DE.make_sharded_encode_b(
                self.mesh, self.mesh_axis, **kw)
        return self._sharded["b"]

    def _is_idr(self, idx: int) -> bool:
        return idx == 0 or (self.intra_period > 0
                            and idx % self.intra_period == 0)

    def _dummy_refs(self):
        """Zero reference stack for intra frames (R = 1)."""
        if self._dummy is None:
            p, sr, dev = self.p, self.sr, self.device
            P, PC = DE.luma_pad(sr), DE.chroma_pad(sr)
            H, W = p.height, p.width
            self._dummy = (
                torch.zeros((1, 4, 4, H + 2 * P, W + 2 * P), dtype=torch.uint8,
                            device=dev),
                torch.zeros((1, H // 2 + 2 * PC, W // 2 + 2 * PC),
                            dtype=torch.int32, device=dev),
                torch.zeros((1, H // 2 + 2 * PC, W // 2 + 2 * PC),
                            dtype=torch.int32, device=dev))
        return self._dummy

    def planes(self, yuv):
        """(Y, U, V) uint8 planes -> int32 tensors on the codec's device."""
        return tuple(torch.as_tensor(np.ascontiguousarray(pl, np.uint8))
                     .to(self.device).to(torch.int32) for pl in yuv)

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
                return self._encode_fn(True)(y, u, v, *self._dummy_refs(),
                                             qp, 0, force)
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
            return self._encode_fn(False)(y, u, v, *stacks, qp, n_valid, force,
                                          wp_c)

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
        reconstruction's downloads), ``avc.host_deblock`` and ``avc.pack``."""
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
            rc.basic_units = self.n_slices     # BU = one row-band slice
        R = max(p.num_ref_frames, 1)
        mb_h, mb_w = p.mb_h, p.mb_w
        rows = mb_h // self.n_slices
        slices, results, dpb = [], [], []
        dpb_means, dpb_recs = [], []   # per-entry (dc_y, dc_u, dc_v); rec8s
        frame_num = idr_pic_id = 0
        pending = None
        seq = trace.sequence()

        def pack(pend):
            """The slices of frame ``pend``."""
            sym = pend["sym"]
            fqps = pend["qps"]
            if pend["idr"] and p.cabac:
                rbsps = [PKC.pack_i_slice_cabac(
                    sym, p, fqps[s], frame_num=0, idr=True,
                    idr_pic_id=pend["idr_pic_id"], row0=s * rows, n_rows=rows)
                    for s in range(self.n_slices)]
            elif pend["idr"]:
                rbsps = [AN.pack_slice(sym, p, SLICE_I, fqps[s], 0, True,
                                       pend["idr_pic_id"], 1,
                                       row0=s * rows, n_rows=rows)
                         for s in range(self.n_slices)]
            elif p.cabac:
                rbsps = [PKC.pack_p_slice_cabac(
                    sym, p, fqps[s], frame_num=pend["frame_num"],
                    num_ref=pend["n_valid"], row0=s * rows, n_rows=rows)
                    for s in range(self.n_slices)]
            elif self.data_partitioning or self.sub8x8:
                # partitions A/B/C; the C packer has no sub_mb_type
                rbsps = [PK.pack_p_slice(
                    sym, p, fqps[s], frame_num=pend["frame_num"],
                    num_ref=pend["n_valid"], row0=s * rows, n_rows=rows,
                    wp=pend["wp"],
                    dp_slice_id=s if self.data_partitioning else None)
                    for s in range(self.n_slices)]
            else:
                rbsps = [AN.pack_slice(sym, p, SLICE_P, fqps[s],
                                       pend["frame_num"], False, 0,
                                       pend["n_valid"], row0=s * rows,
                                       n_rows=rows, wp=pend["wp"])
                         for s in range(self.n_slices)]
            return rbsps

        def finalize(pend):
            with trace.span("avc.pack", frame=(seq, pend["idx"])):
                t0 = time.perf_counter()
                rbsps = pack(pend)
                self.host_ms["pack"].append((time.perf_counter() - t0) * 1e3)
            slices.extend((pend["idr"], rb) for rb in rbsps)
            res = AVCFrameResult(
                frame_type=pend["ftype"],
                bits=sum(len(x) for rb in rbsps
                         for x in (rb if isinstance(rb, tuple) else (rb,))) * 8,
                psnr_y=pend["psnr_y"], recon=pend["rec8"])
            results.append(res)
            trace.frame_done(seq, pend["idx"], pend["ftype"])
            if verbose:
                print(f"frame {pend['idx']:3d} {pend['ftype']:3s} "
                      f"bits {res.bits:7d} PSNR-Y {res.psnr_y:6.2f}")
            return res

        def rc_update(pend):
            """Pack ``pend`` and feed its bits to the controller."""
            res = finalize(pend)
            mse_y = 255.0 ** 2 / (10.0 ** (res.psnr_y / 10.0))
            rc.update(res.bits, pend["qp"], float(np.sqrt(mse_y)),
                      ftype="P" if pend["ftype"] == "P" else "I")

        for idx, yuv in enumerate(frames):
            trace.frame_taken(seq, idx)
            idr = self._is_idr(idx)
            qp_s = None                      # per-slice QPs (basic-unit RC)
            if rc is not None and idx > 0:
                # rate control needs the previous frame's bits now
                if pending is not None:
                    rc_update(pending)
                    if pending.get("bu_mads") is not None:
                        rc.update_basic_units(pending["bu_mads"])
                    pending = None
                if bu and not idr:
                    qp_s = [int(v) for v in rc.basic_unit_qps(self.n_slices)]
                    qp = int(round(np.mean(qp_s)))
                else:
                    qp = rc.frame_qp("I" if idr else "P")
            meta = dict(idx=idx, idr=idr, qp=qp,
                        qps=qp_s if qp_s is not None else [qp] * self.n_slices)
            wp = None
            if idr:
                dpb, dpb_means, dpb_recs = [], [], []
                meta.update(ftype="IDR", idr_pic_id=idr_pic_id)
                idr_pic_id = (idr_pic_id + 1) & 0xFFFF
                fim = None
            else:
                n_valid = min(len(dpb), R)
                if p.weighted_pred:
                    pad = [min(i, n_valid - 1) for i in range(R)]
                    wp = (estimate_wp_lms(yuv, [dpb_recs[i] for i in pad])
                          if self.wp_method == "lms" else
                          estimate_wp(yuv, [dpb_means[i] for i in pad]))
                meta.update(ftype="P", frame_num=frame_num, n_valid=n_valid,
                            wp=wp)
                fim = force_intra(idx) if force_intra else None
                if fim is not None:
                    fim = torch.as_tensor(np.asarray(fim, bool)).to(self.device)
            sym, rec, tctx = self.encode_frame(
                yuv, dpb, qp if qp_s is None else qp_s, fim, wp=wp)
            frame_num = 1 if idr else (frame_num + 1) % (1 << p.log2_max_frame_num)

            # pack the previous frame once this frame's work is queued
            if pending is not None:
                finalize(pending)
            with trace.span("avc.wait"):
                sym_np = host_symbols(sym)
                ctx_np, rec_np = host_context(tctx, rec)
            if p.deblock:
                with trace.span("avc.host_deblock"):
                    t0 = time.perf_counter()
                    ctx = deblock_context(ctx_np, mb_h, mb_w, qp,
                                          p.chroma_qp_offset, idr, qp_s)
                    rec_np = AN.deblock_frame(*rec_np, ctx)
                    self.host_ms["deblock"].append(
                        (time.perf_counter() - t0) * 1e3)
            rec8 = tuple(np.asarray(pl, np.uint8) for pl in rec_np)
            dpb.insert(0, self.prep(rec8))
            dpb = dpb[:R]
            if p.weighted_pred:
                dpb_means.insert(0, tuple(float(pl.mean()) for pl in rec8))
                dpb_means = dpb_means[:R]
                if self.wp_method == "lms":
                    dpb_recs.insert(0, rec8)
                    dpb_recs = dpb_recs[:R]
            mse = ((np.asarray(yuv[0], np.float64) - rec8[0]) ** 2).mean()
            meta.update(sym=sym_np, rec8=rec8,
                        psnr_y=99.99 if mse == 0 else
                        float(10 * np.log10(255.0 ** 2 / mse)))
            if bu and not idr:
                # the measured per-unit MAD (reconstruction error) feeds the
                # next frame's per-unit target split
                d = np.abs(np.asarray(yuv[0], np.int64)
                           - rec8[0].astype(np.int64))
                meta["bu_mads"] = [float(d[s * rows * 16:(s + 1) * rows * 16]
                                         .mean())
                                   for s in range(self.n_slices)]
            pending = meta
        if pending is not None:
            if rc is not None:
                rc_update(pending)
            else:
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
        reads ``rate_control``, so a controller is never consulted.  One
        ``trace`` sequence: a frame is taken when its encode starts (the
        frames are read in whole first) and done once packed."""
        p = self.p
        frames = list(frames)
        n = len(frames)
        G = self.bframes + 1
        anchors = sorted(set(list(range(0, n, G)) + [n - 1]))
        mb_h, mb_w = p.mb_h, p.mb_w
        rows = mb_h // self.n_slices
        max_fn = 1 << p.log2_max_frame_num
        max_poc = 1 << p.log2_max_poc_lsb
        slices, results = [], [None] * n
        fn_state = dict(frame_num=0)
        packi = PKC.pack_i_slice_cabac if p.cabac else PK.pack_i_slice
        packp = PKC.pack_p_slice_cabac if p.cabac else PK.pack_p_slice
        packb = PKC.pack_b_slice_cabac if p.cabac else PK.pack_b_slice
        seq = trace.sequence()
        spans = dict(pack="avc.pack", deblock="avc.host_deblock")

        def timed(key, fn, *a, **kw):
            with trace.span(spans[key]):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                self.host_ms[key].append((time.perf_counter() - t0) * 1e3)
            return out

        def pack_slices(fn, *a, **kw):
            return [fn(*a, row0=s * rows, n_rows=rows, **kw)
                    for s in range(self.n_slices)]

        def finish(rec_np, disp, ftype, rbsps, ref_idc, idr=False):
            slices.extend((idr, rb, ref_idc) for rb in rbsps)
            rec8 = tuple(np.asarray(pl, np.uint8) for pl in rec_np)
            mse = ((np.asarray(frames[disp][0], np.float64) - rec8[0])
                   ** 2).mean()
            results[disp] = AVCFrameResult(
                frame_type=ftype, bits=sum(len(rb) for rb in rbsps) * 8,
                psnr_y=99.99 if mse == 0 else
                float(10 * np.log10(255.0 ** 2 / mse)), recon=rec8)
            trace.frame_done(seq, disp, ftype)
            if verbose:
                print(f"frame {disp:3d} {ftype:3s} bits "
                      f"{results[disp].bits:7d} PSNR-Y "
                      f"{results[disp].psnr_y:6.2f}")
            return rec8

        def encode_b(disp, prep0, poc0, prep1, poc1, col_motion, fqp,
                     ref_pic=False):
            trace.frame_taken(seq, disp)
            y, u, v = self.planes(frames[disp])
            col_mv, col_ref = (torch.as_tensor(np.asarray(a, np.int32)).to(
                self.device) for a in col_motion)
            sym, rec, tctx = self._encode_fn_b()(
                y, u, v, *(x[None] for x in prep0), *(x[None] for x in prep1),
                col_mv, col_ref, fqp, 1, 1)
            sym_np = host_symbols(sym, torch.int32)
            ctx_np = {k: v.cpu().numpy().astype(np.int64)
                      for k, v in tctx.items()}
            rec_np = tuple(pl.cpu().numpy().astype(np.int64) for pl in rec)
            rbsps = timed("pack", pack_slices, packb, sym_np, p, fqp,
                          frame_num=fn_state["frame_num"] % max_fn,
                          num_ref0=1, num_ref1=1,
                          poc_lsb=(2 * disp) % max_poc, ref_pic=ref_pic)
            if p.deblock:
                ctx = DeblockContext(mb_w, mb_h, fqp, p.chroma_qp_offset)
                ctx.mb_intra = ctx_np["mb_intra"].astype(bool)
                ctx.nnz = ctx_np["nnz"]
                ctx.mv = ctx_np["mv0"]
                ctx.ref = np.where(ctx_np["ref0"] == 0, poc0, -1)
                ctx.mv1 = ctx_np["mv1"]
                ctx.ref1 = np.where(ctx_np["ref1"] == 0, poc1, -1)
                rec_np = timed("deblock", AN.deblock_frame, *rec_np, ctx)
            rec8 = finish(rec_np, disp, "B", rbsps, 2 if ref_pic else 0)
            if ref_pic:
                fn_state["frame_num"] += 1
            return rec8, (ctx_np["mv0"], ctx_np["ref0"])

        prev = None
        pending_bref_fn = None
        for a in anchors:
            trace.frame_taken(seq, a)
            fqp = qp
            if a == 0:
                sym, rec, tctx = self.encode_frame(frames[a], [], fqp)
                rbsps = timed("pack", pack_slices, packi, host_symbols(sym),
                              p, fqp, frame_num=0, idr=True)
                ctx_np, rec_np = host_context(tctx, rec)
                idr = True
                fn_state["frame_num"] = 1
                motion = (np.zeros((mb_h * 4, mb_w * 4, 2), np.int64),
                          np.full((mb_h * 4, mb_w * 4), -1, np.int64))
                anchor_fn = 0
            else:
                sym, rec, tctx = self.encode_frame(frames[a], [prev["prep"]],
                                                   fqp, n_refs=1)
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
                rbsps = timed("pack", pack_slices, packp, host_symbols(sym),
                              p, fqp, frame_num=frame_num % max_fn,
                              num_ref=1, poc_lsb=(2 * a) % max_poc,
                              mmco=mmco, reorder_l0=reorder)
                pending_bref_fn = None
                ctx_np, rec_np = host_context(tctx, rec)
                idr = False
                anchor_fn = frame_num
                fn_state["frame_num"] += 1
                motion = (ctx_np["mv"].astype(np.int64),
                          ctx_np["ref"].astype(np.int64))
            if p.deblock:
                ctx = deblock_context(ctx_np, mb_h, mb_w, fqp,
                                      p.chroma_qp_offset, idr)
                rec_np = timed("deblock", AN.deblock_frame, *rec_np, ctx)
            rec8 = finish(rec_np, a, "IDR" if idr else "P", rbsps,
                          3 if idr else 2, idr)
            cur = dict(prep=self.prep(rec8), motion=motion, poc=2 * a,
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
