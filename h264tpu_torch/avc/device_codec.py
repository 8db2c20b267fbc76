"""Sequence encoder for the conformant H.264 encoder on one device.

Port of the IPPP branch of ``h264tpu/avc/tpu_codec.py`` ``TPUAVCCodec``:
every frame's decisions and residuals come from ``avc/device_enc.py`` on the
device; the host packs the CAVLC slices (``avc/pack.py``), applies the spec
deblocking filter (``avc/deblock.py``) and assembles the Annex-B stream.
Reference pictures stay on the device as phase-split quarter-pel planes.
A frame's symbols come to the host at the same sync as its reconstruction,
which the deblock needs before the next frame can start; its slices are
packed after the next frame's device work has been queued.

Ported: IPPP with periodic IDR, CAVLC, the 4x4 transform, full-RD mode
decision with adaptive rounding and RD-gated decimation, row-band slices,
multiple reference frames.  The other options of ``TPUAVCCodec`` raise
``NotImplementedError``.

Reference: ``JM/lencod/src/lencod.c:876`` encode_sequence.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import resolve_device
from . import conformance
from . import device_enc as DE
from . import pack as PK
from .deblock import DeblockContext, deblock_frame
from .params import AVCParams, assemble_stream


@dataclasses.dataclass
class AVCFrameResult:
    frame_type: str
    bits: int
    psnr_y: float
    recon: tuple          # (Y, U, V) uint8


# symbol fields of the ported path and their per-MB widths, as
# TPUAVCCodec transfers them
_SYM_KEYS = (("win", 1), ("ri", 1), ("mvd", 8), ("i4flags", 32),
             ("i16mode", 1), ("i16dc", 16), ("cmode", 1), ("cbp_luma", 1),
             ("cbp_chroma", 1), ("zz", 256), ("cdc", 8), ("cac", 120),
             ("mb_intra", 1))
_SYM_SHAPES = {"mvd": (4, 2), "i4flags": (16, 2), "zz": (16, 16),
               "cdc": (2, 4), "cac": (2, 2, 2, 15)}


def host_symbols(sym: dict) -> dict:
    """Device symbols -> the host arrays the packer reads: int16 of the
    shapes ``tpu_codec._unpack_sym`` gives, in one transfer."""
    nmb = sym["win"].shape[0]
    flat = torch.cat([sym[k].reshape(nmb, -1).to(torch.int16)
                      for k, w in _SYM_KEYS], 1).cpu().numpy()
    out, off = {}, 0
    for k, w in _SYM_KEYS:
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
               mb_intra=ctx["mb_intra"].cpu().numpy().astype(bool))
    return out, tuple(pl.to(torch.uint8).cpu().numpy().astype(np.int64)
                      for pl in rec)


class DeviceAVCCodec:
    """Baseline/CAVLC H.264 encoder with all pixel work on one device."""

    def __init__(self, p: AVCParams, intra_period: int = 0,
                 search_range: int = 16, n_slices: int = 1, mesh=None, bframes: int = 0,
                 hierarchical: bool = False, sub8x8: bool = False,
                 data_partitioning: bool = False, device=None):
        """``n_slices``: equal row-band slices per picture (must divide
        mb_h); the decision scan runs them side by side.  ``device``: None
        is the CUDA card (raises without one); pass "cpu" for the plain
        PyTorch path on the host."""
        unported = [
            ("CABAC", p.cabac), ("B frames", bframes > 0 or hierarchical),
            ("the 8x8 transform", p.transform_8x8),
            ("sub-8x8 partitions", sub8x8),
            ("weighted prediction", p.weighted_pred),
            ("a device mesh", mesh is not None),
            ("data partitioning", data_partitioning),
            ("scaling lists", p.scaling_matrix is not None)]
        for what, asked in unported:
            if asked:
                raise NotImplementedError(f"{what} is not ported")
        if p.slice_groups != 1:
            raise ValueError("the device path has no FMO")
        if p.mb_h % n_slices:
            raise ValueError(f"n_slices {n_slices} must divide {p.mb_h}")
        self.device = resolve_device(device)
        self.p = p
        self.intra_period = intra_period
        self.sr = search_range
        self.n_slices = n_slices
        conformance.check_params(p)
        self._dummy = None
        # host milliseconds per frame of the slice packer and the deblock
        self.host_ms = dict(pack=[], deblock=[])

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

    def encode_frame(self, yuv, refs, qp: int, force=None):
        """Device encode of one frame against ``refs`` (a list of
        ``prep_ref`` entries, newest first; empty for an IDR).  Returns the
        device (sym, rec, ctx) of ``device_enc.encode_frame``."""
        p = self.p
        y, u, v = (torch.as_tensor(np.ascontiguousarray(pl, np.uint8))
                   .to(self.device).to(torch.int32) for pl in yuv)
        if force is None:
            force = torch.zeros((p.mb_h, p.mb_w), dtype=torch.bool,
                                device=self.device)
        kw = dict(mb_h=p.mb_h, mb_w=p.mb_w, sr=self.sr, n_slices=self.n_slices,
                  chroma_qp_offset=p.chroma_qp_offset)
        if not refs:
            return DE.encode_frame(y, u, v, *self._dummy_refs(), qp, 0, force,
                                   intra_only=True, **kw)
        R = max(p.num_ref_frames, 1)
        n_valid = min(len(refs), R)
        sel = [refs[min(i, n_valid - 1)] for i in range(R)]
        stacks = [torch.stack([r[k] for r in sel]) for k in range(3)]
        return DE.encode_frame(y, u, v, *stacks, qp, n_valid, force,
                               intra_only=False, **kw)

    def encode_sequence(self, frames, qp: int = None, verbose: bool = False,
                        force_intra=None, rate_control=None):
        """frames: iterable of (Y, U, V) uint8.  Returns (results, Annex-B
        stream bytes) like ``TPUAVCCodec.encode_sequence``."""
        if rate_control is not None:
            raise NotImplementedError("rate control is not ported")
        p = self.p
        qp = p.qp if qp is None else qp
        R = max(p.num_ref_frames, 1)
        mb_h, mb_w = p.mb_h, p.mb_w
        rows = mb_h // self.n_slices
        slices, results, dpb = [], [], []
        frame_num = idr_pic_id = 0
        pending = None

        def finalize(pend):
            t0 = time.perf_counter()
            sym = pend["sym"]
            if pend["idr"]:
                rbsps = [PK.pack_i_slice(sym, p, qp, frame_num=0, idr=True,
                                         idr_pic_id=pend["idr_pic_id"],
                                         row0=s * rows, n_rows=rows)
                         for s in range(self.n_slices)]
            else:
                rbsps = [PK.pack_p_slice(sym, p, qp,
                                         frame_num=pend["frame_num"],
                                         num_ref=pend["n_valid"],
                                         row0=s * rows, n_rows=rows)
                         for s in range(self.n_slices)]
            self.host_ms["pack"].append((time.perf_counter() - t0) * 1e3)
            slices.extend((pend["idr"], rb) for rb in rbsps)
            res = AVCFrameResult(frame_type=pend["ftype"],
                                 bits=sum(len(rb) for rb in rbsps) * 8,
                                 psnr_y=pend["psnr_y"], recon=pend["rec8"])
            results.append(res)
            if verbose:
                print(f"frame {pend['idx']:3d} {pend['ftype']:3s} "
                      f"bits {res.bits:7d} PSNR-Y {res.psnr_y:6.2f}")

        for idx, yuv in enumerate(frames):
            idr = self._is_idr(idx)
            meta = dict(idx=idx, idr=idr)
            if idr:
                dpb = []
                meta.update(ftype="IDR", idr_pic_id=idr_pic_id)
                idr_pic_id = (idr_pic_id + 1) & 0xFFFF
                fim = None
            else:
                meta.update(ftype="P", frame_num=frame_num,
                            n_valid=min(len(dpb), R))
                fim = force_intra(idx) if force_intra else None
                if fim is not None:
                    fim = torch.as_tensor(np.asarray(fim, bool)).to(self.device)
            sym, rec, tctx = self.encode_frame(yuv, dpb, qp, fim)
            frame_num = 1 if idr else (frame_num + 1) % (1 << p.log2_max_frame_num)

            # pack the previous frame once this frame's work is queued
            if pending is not None:
                finalize(pending)
            sym_np = host_symbols(sym)
            ctx_np, rec_np = host_context(tctx, rec)
            if p.deblock:
                t0 = time.perf_counter()
                ctx = DeblockContext(mb_w, mb_h, qp, p.chroma_qp_offset)
                if not idr:
                    ctx.mb_intra = ctx_np["mb_intra"]
                    ctx.nnz = np.asarray(ctx_np["nnz"], np.int64)
                    ctx.mv = np.asarray(ctx_np["mv"], np.int64)
                    ctx.ref = np.asarray(ctx_np["ref"], np.int64)
                rec_np = deblock_frame(*rec_np, ctx)
                self.host_ms["deblock"].append((time.perf_counter() - t0) * 1e3)
            rec8 = tuple(np.asarray(pl, np.uint8) for pl in rec_np)
            dpb.insert(0, DE.prep_ref(*(torch.as_tensor(pl).to(self.device)
                                        for pl in rec8), self.sr))
            dpb = dpb[:R]
            mse = ((np.asarray(yuv[0], np.float64) - rec8[0]) ** 2).mean()
            meta.update(sym=sym_np, rec8=rec8,
                        psnr_y=99.99 if mse == 0 else
                        float(10 * np.log10(255.0 ** 2 / mse)))
            pending = meta
        if pending is not None:
            finalize(pending)
        return results, assemble_stream(p, slices)
