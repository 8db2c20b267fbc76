"""Fractal + H.264 hybrid video codec — frame pipeline + FVC bitstream.

Port of ``h264tpu/models/fractal_codec.py``: every
``intra_period``-th frame is coded intra (9-mode wavefront), all others are
P frames, fractal by default:

  fractal search (Y, U, V trees) -> fractal reconstruction -> residual
  DCT/quant -> final reconstruction -> [deblock] -> next reference,

and the tree + residual levels are entropy-coded on the host into the FVC
stream, byte for byte as the JAX package writes it.  ``encode_sequence``
keeps the reference's software pipeline: frame N's host entropy coding runs
while frame N+1's device work is queued.  A frame's host-bound outputs are
copied into pinned host memory as soon as they are queued, and the host
waits on that copy's event alone.

The options: classic H.264-style inter (``inter_mode="classic"``, frame type
2: integer full search, sub-pel refinement, block MC), rate control (the
quadratic model of ``models/ratectl.py``), Annex-B and RTP containers with
frame-copy concealment in the decoder, CABAC and Exp-Golomb residuals, 3-view
coding with a second reference frame for the side views
(:meth:`FractalCodec.encode_sequence_views`) and region coding with
alpha-plane masks (``num_regions=2``, frame type 3).  With a device mesh
(``FractalCodec(cfg, mesh=)``) fractal P frames run as row tiles over its
slots (``parallel/tiled_search.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device, mark as _mark
from ..utils.config import CodecConfig
from ..utils.yuv import psnr
from ..ops import fractal as F
from ..ops import transform as T
from ..ops import intra as IN
from ..ops import deblock as DB
from ..ops import me as ME
from ..ops import region as RG
from ..ops import segment as SG
from ..entropy.bitio import BitWriter, BitReader
from ..entropy import fractal_syntax as FS
from ..bitstream import nal, rtp
from ..parallel.tiled_search import tiled_p_step
from .ratectl import QuadraticRateControl

_MAP_KEYS = ("a", "beta", "dx", "dy", "ref", "shape")


def _pad16_np(h: int, w: int):
    return h + ((-h) % 16), w + ((-w) % 16)


def _pad16(plane: torch.Tensor) -> torch.Tensor:
    """Edge-replicate a plane up to multiples of 16."""
    h, w = plane.shape
    hp, wp = _pad16_np(h, w)
    if (hp, wp) == (h, w):
        return plane
    rows = torch.clamp(torch.arange(hp, device=plane.device), max=h - 1)
    cols = torch.clamp(torch.arange(wp, device=plane.device), max=w - 1)
    return plane[rows][:, cols]


def _as_planes(planes, device) -> tuple:
    """(Y, U, V) as int32 tensors on ``device`` from numpy arrays or tensors."""
    return tuple(_as_tensor(p, device) for p in planes)


def _as_tensor(a, device) -> torch.Tensor:
    """An int32 tensor on ``device`` from a numpy array or a tensor."""
    t = a if torch.is_tensor(a) else torch.from_numpy(np.array(a, np.int32))
    return t.to(device=device, dtype=torch.int32)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _classic_strengths(zz, mvx, mvy, cell: int, h: int, w: int):
    """bS maps of a classic P plane from its levels and per-block MVs
    (``cell`` 4x4 cells per block side: 4 for luma, 2 for chroma)."""
    nz = (zz != 0).any(dim=-1).reshape(h // 4, w // 4)

    def up(m):
        return m.repeat_interleave(cell, dim=0).repeat_interleave(cell, dim=1)

    return DB.strengths_inter(up(mvx), up(mvy), nz)


@dataclasses.dataclass
class FrameResult:
    frame_type: str
    psnr_y: float
    psnr_u: float
    psnr_v: float
    bits: int
    recon: tuple  # (Y, U, V) uint8 numpy
    recon_dev: tuple = None  # (Y, U, V) int32 device tensors (next frame's ref)
    qp: int = 0


class FractalCodec:
    """Sequence encoder with fractal (or classic) P frames."""

    def __init__(self, cfg: CodecConfig, device=None, mesh=None):
        """``device``: None is the CUDA card (raises without one), or the
        first slot of ``mesh`` when one is given; "cpu" runs the plain
        PyTorch path.  ``mesh``: a ``parallel.Mesh`` with axes ("gop",
        "tile") and a gop axis of 1: fractal P frames with one reference
        then run the row-tile step (``parallel/tiled_search.py``) over its
        tile slots, and the stream is byte-identical to the unsharded one
        (the deblock bands come from ``cfg.tile_rows``, a multiple of the
        tile count).  I frames, classic inter and the 3-view side views
        keep the unsharded step."""
        self.cfg = cfg.validate()
        self.device = resolve_device(
            device if device is not None or mesh is None
            else mesh.devices.flat[0])
        fr = cfg.fractal
        # tol_4 is faithfully unused: the reference's 4x4 comparison is
        # commented out (FR/src/block_enc.c:1681)
        self._search_kw = dict(
            search_range=fr.search_range, tol16=fr.tol_16, tol8=fr.tol_8,
            use_halfpel=fr.use_halfpel_refs, search_mode=int(fr.search_mode),
            chun_lo=fr.chun_lo, chun_hi=fr.chun_hi,
            bounds=(int(round(fr.min_alpha * 100)),
                    int(round(fr.max_alpha * 100)),
                    int(round(fr.min_beta)), int(round(fr.max_beta))))
        self._groups = max(cfg.tile_rows, 1)
        self.mesh = mesh
        if mesh is not None:
            if cfg.tile_rows % mesh.shape["tile"]:
                raise ValueError("cfg.tile_rows must be a multiple of the "
                                 "mesh 'tile' axis size")
            if mesh.shape.get("gop") != 1:
                raise ValueError("FractalCodec shards one frame at a time: "
                                 "the mesh's 'gop' axis must be 1")
            self._tiled = tiled_p_step(
                mesh, deblock=cfg.deblock, tile_rows=cfg.tile_rows,
                **self._search_kw)

    # -- intra step (wavefront 4x4 intra, ops/intra.py) ---------------------
    def _i_step(self, y, u, v, qp):
        cqp = T.chroma_qp(qp)
        modes_l, zzs, outs = [], [], []
        for plane, q, luma in ((y, qp, True), (u, cqp, False), (v, cqp, False)):
            modes, zz, rec = IN.encode_plane(plane, q)
            if self.cfg.deblock:
                h, w = plane.shape
                bs_v, bs_h = DB.strengths_intra(h, w, plane.device)
                rec = DB.deblock_plane_grouped(rec, bs_v, bs_h, q, luma,
                                               self._groups)
            modes_l.append(modes)
            outs.append(rec)
            zzs.append(zz)
        return modes_l, zzs, outs

    # -- fractal P step -----------------------------------------------------
    def _p_plane(self, org, ref, qp, is_luma, ref2=None, marks=None):
        """One fractal P plane; ``marks`` (see :func:`_mark`) gets an event
        after the search, the fractal reconstruction, the residual coding
        and the deblock."""
        h, w = org.shape
        orgp = _pad16(org)
        refp = _pad16(ref)
        ref2p = None if ref2 is None else _pad16(ref2)
        hp, wp = orgp.shape
        tree = F.search_plane(orgp, refp, **self._search_kw,
                              extra_ref_ctx=ref2p)
        _mark(marks, org.device)
        maps = F.leaf_maps(tree, hp, wp)
        frec = F.reconstruct_from_maps(maps, refp, hp, wp,
                                       self.cfg.fractal.use_halfpel_refs,
                                       ref2p)[:h, :w]
        _mark(marks, org.device)
        zz, rec = T.residual_code_plane(org, frec, qp, is_luma)
        _mark(marks, org.device)
        if self.cfg.deblock:
            nz = (zz != 0).any(dim=-1).reshape(h // 4, w // 4)
            bs_v, bs_h = DB.strengths_fractal(
                {k: m[:h // 4, :w // 4] for k, m in maps.items()}, nz)
            rec = DB.deblock_plane_grouped(rec, bs_v, bs_h, qp, is_luma,
                                           self._groups)
        _mark(marks, org.device)
        return maps, zz, rec

    def _p_step(self, y, u, v, ref_y, ref_u, ref_v, qp, ref2=None,
                marks=None):
        cqp = T.chroma_qp(qp)
        r2 = (None, None, None) if ref2 is None else ref2
        all_maps, zzs, recs = [], [], []
        for org, ref, q, is_luma, x2 in ((y, ref_y, qp, True, r2[0]),
                                         (u, ref_u, cqp, False, r2[1]),
                                         (v, ref_v, cqp, False, r2[2])):
            maps, zz, rec = self._p_plane(org, ref, q, is_luma, x2, marks)
            all_maps.append(maps)
            zzs.append(zz)
            recs.append(rec)
        return all_maps, zzs, recs

    # -- classic H.264-style inter step (ops/me.py) --------------------------
    def _c_step(self, y, u, v, ref_y, ref_u, ref_v, qp, marks=None):
        """One classic P frame; ``marks`` (see :func:`_mark`) gets an event
        after the full search, the sub-pel refinement, motion compensation
        with residual coding of the three planes, and the deblock."""
        cqp = T.chroma_qp(qp)
        lam = 1  # flat MV-cost weight, as in the reference
        h, w = y.shape
        me0 = ME.full_search_int(y, ref_y, 16, self.cfg.me_search_range, lam)
        _mark(marks, y.device)
        up_y = ME.sixtap_halfpel(ref_y)
        me1 = ME.subpel_refine(y, up_y, me0, 16, lam)
        _mark(marks, y.device)
        pred_y = ME.motion_compensate(up_y, me1.mv_x, me1.mv_y, 16, h, w)
        zz_y, rec_y = T.residual_code_plane(y, pred_y, qp, True)
        zzs, recs = [zz_y], [rec_y]
        mv_c = (me1.mv_x >> 1, me1.mv_y >> 1)   # luma 1/4 pel -> chroma
        for org, ref in ((u, ref_u), (v, ref_v)):
            hc, wc = org.shape
            pred = ME.motion_compensate(ME.sixtap_halfpel(ref), *mv_c, 8,
                                        hc, wc)
            zz, rec = T.residual_code_plane(org, pred, cqp, False)
            zzs.append(zz)
            recs.append(rec)
        _mark(marks, y.device)
        if self.cfg.deblock:
            # the reference's encoder deblocks the whole plane (no row
            # bands), its decoder by cfg.tile_rows bands: with tile_rows > 1
            # the two differ, and the port keeps both as they are
            for i, (mvs, cell, q, luma) in enumerate((
                    ((me1.mv_x, me1.mv_y), 4, qp, True),
                    (mv_c, 2, cqp, False), (mv_c, 2, cqp, False))):
                ph, pw = recs[i].shape
                bs_v, bs_h = _classic_strengths(zzs[i], *mvs, cell, ph, pw)
                recs[i] = DB.deblock_plane(recs[i], bs_v, bs_h, q, luma)
        _mark(marks, y.device)
        return (me1.mv_x, me1.mv_y), zzs, recs

    # -- frame / sequence ----------------------------------------------------
    def is_intra(self, frame_idx: int) -> bool:
        if frame_idx == 0:
            return True
        ip = self.cfg.intra_period
        return ip > 0 and frame_idx % ip == 0

    def dispatch_frame(self, yuv, ref=None, frame_idx: int = 0,
                       qp: int = None, ref2=None, marks=None) -> dict:
        """Queue all device work for one frame; returns a pending handle.

        The host does not wait here: the frame's host-bound outputs are
        copied to pinned memory behind an event that :meth:`finalize_frame`
        waits on.  ``ref`` (and ``ref2``, the second reference frame of a
        3-view side view) may be numpy (uint8 or int32) or device tensors;
        ``qp`` overrides the config's (rate control); ``marks`` collects
        the CUDA events of a P frame's stages (``_p_plane``, ``_c_step``;
        on a mesh, the four stages of every tile of every plane).
        """
        orgs = _as_planes(yuv, self.device)
        dims = [tuple(p.shape) for p in orgs]
        intra = self.is_intra(frame_idx) or ref is None
        if qp is None:
            qp = self.cfg.qp_i if intra else self.cfg.qp
        qp = int(qp)
        classic = not intra and self.cfg.inter_mode == "classic"

        host = {}
        if intra:
            kind = "i"
            modes_l, zzs, recs = self._i_step(*orgs, qp)
            for i in range(3):
                host[f"{i}_modes"] = modes_l[i]
        elif classic:
            kind = "c"
            (host["mvx"], host["mvy"]), zzs, recs = self._c_step(
                *orgs, *_as_planes(ref, self.device), qp, marks)
        else:
            kind = "p"
            refs = _as_planes(ref, self.device)
            if self.mesh is not None and ref2 is None:
                maps_b, zzs_b, recs_b = self._tiled(
                    *(p[None] for p in orgs + refs), qp, marks=marks)
                maps = [{k: m[0] for k, m in d.items()} for d in maps_b]
                zzs = [z[0] for z in zzs_b]
                recs = [r[0] for r in recs_b]
            else:
                # the 3-view side views (ref2) keep the unsharded step: the
                # tiled step has no second reference
                r2 = None if ref2 is None else _as_planes(ref2, self.device)
                maps, zzs, recs = self._p_step(*orgs, *refs, qp, ref2=r2,
                                               marks=marks)
            for i in range(3):
                for f in _MAP_KEYS:
                    host[f"{i}_{f}"] = maps[i][f]
        for i in range(3):
            host[f"{i}_zz"] = zzs[i]
            host[f"{i}_rec"] = recs[i].to(torch.uint8)
            host[f"{i}_sse"] = ((recs[i] - orgs[i]).to(torch.int64) ** 2).sum()
        ready = None
        if self.device.type == "cuda":
            pinned = {}
            for k, t in host.items():
                pinned[k] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                pinned[k].copy_(t, non_blocking=True)
            host = pinned
            ready = torch.cuda.Event()
            ready.record()
        return dict(intra=intra, kind=kind, dims=dims, host=host, ready=ready,
                    recs=tuple(recs), qp=qp, dual_ref=ref2 is not None)

    def finalize_frame(self, pending: dict):
        """Wait for the frame's host copy and entropy-code it.

        Returns (FrameResult, payload bytes)."""
        cfg = self.cfg
        kind = pending["kind"]
        dims = pending["dims"]
        if pending["ready"] is not None:
            pending["ready"].synchronize()
        h = {k: t.numpy() for k, t in pending["host"].items()}

        w = BitWriter()
        w.u({"i": 0, "p": 1, "c": 2}[kind], 8)
        w.u(int(pending["qp"]), 8)
        for i, (ph, pw) in enumerate(dims):
            if kind == "i":
                FS.write_intra_modes(w, h[f"{i}_modes"])
            elif kind == "c":
                if i == 0:
                    w.se(h["mvx"].reshape(-1))
                    w.se(h["mvy"].reshape(-1))
            else:
                FS.write_tree(w, {f: h[f"{i}_{f}"] for f in _MAP_KEYS},
                              cfg.fractal.search_range,
                              cfg.fractal.use_halfpel_refs,
                              ref_bits=3 if pending["dual_ref"] else None)
            FS.write_residual(w, h[f"{i}_zz"], ph // 4, pw // 4,
                              int(cfg.entropy))
        payload = w.to_bytes()

        psnrs = []
        for i, (ph, pw) in enumerate(dims):
            mse = float(h[f"{i}_sse"]) / (ph * pw)
            psnrs.append(99.99 if mse == 0 else
                         10.0 * np.log10(255.0 * 255.0 / mse))
        res = FrameResult(
            frame_type="I" if pending["intra"] else "P", psnr_y=psnrs[0],
            psnr_u=psnrs[1], psnr_v=psnrs[2], bits=len(payload) * 8,
            recon=tuple(h[f"{i}_rec"] for i in range(3)),
            recon_dev=pending["recs"], qp=int(pending["qp"]))
        return res, payload

    def encode_frame(self, yuv, ref=None, frame_idx: int = 0, qp: int = None):
        """Encode one frame; returns (FrameResult, frame_payload_bytes)."""
        return self.finalize_frame(self.dispatch_frame(yuv, ref, frame_idx, qp))

    def encode_sequence(self, frames, verbose: bool = False):
        """Encode an iterable of (Y, U, V) uint8 frames.

        Software-pipelined: frame N's host entropy coding overlaps frame
        N+1's device work (the recon feedback stays on the device).  With
        rate control the loop is sequential (frame N's bits decide frame
        N+1's QP); with ``num_regions == 2`` it is the region coder.
        Returns (results, bitstream bytes)."""
        if self.cfg.num_regions == 2:
            res, stream, _masks = self.encode_sequence_region(
                list(frames), verbose=verbose)
            return res, stream
        if self.cfg.rate_control and self.cfg.target_bitrate > 0:
            return self._encode_sequence_rc(frames, verbose)
        results = []
        payloads = []
        pending = None
        ref = None
        for idx, yuv in enumerate(frames):
            disp = self.dispatch_frame(yuv, ref, idx)
            ref = disp["recs"]
            if pending is not None:
                results.append(self._emit(pending, payloads, verbose))
            pending = disp
        if pending is not None:
            results.append(self._emit(pending, payloads, verbose))
        return results, self._assemble(payloads, len(results))

    def _encode_sequence_rc(self, frames, verbose: bool):
        """Rate-controlled sequence encode (quadratic model, models/ratectl).

        The controller sees the luma RMS error ``sqrt(mse_y)`` written from
        the frame's PSNR in the reference's float64 expression order; the
        port's SSE is exact, as the reference's float32 sum is below
        2^24."""
        cfg = self.cfg
        rc = QuadraticRateControl(cfg.target_bitrate, cfg.frame_rate, cfg.qp)
        results = []
        payloads = []
        ref = None
        for idx, yuv in enumerate(frames):
            intra = self.is_intra(idx) or ref is None
            qp = cfg.qp_i if intra else rc.frame_qp()
            res, payload = self.encode_frame(yuv, ref, idx, qp=qp)
            ref = res.recon_dev
            results.append(res)
            payloads.append(payload)
            if not intra:
                mse_y = 255.0 ** 2 / (10.0 ** (res.psnr_y / 10.0))
                rc.update(res.bits, qp, float(np.sqrt(mse_y)))
            if verbose:
                print(f"frame {idx:3d} {res.frame_type} qp {qp:2d}  "
                      f"PSNR Y {res.psnr_y:6.2f}  bits {res.bits}")
        return results, self._assemble(payloads, len(results))

    def _assemble(self, payloads, num_frames: int, views: int = None) -> bytes:
        """Wrap frame payloads in the configured container (cfg.container):
        raw FVC concatenation, Annex-B NAL stream, or an RTP packet file."""
        cfg = self.cfg
        if views is not None and views != cfg.views:
            cfg = dataclasses.replace(cfg, views=views)
        hdr = BitWriter()
        FS.write_header(hdr, cfg, num_frames)
        header_bytes = hdr.to_bytes()
        if cfg.container == "annexb":
            return nal.wrap_stream(cfg, header_bytes, payloads)
        if cfg.container == "rtp":
            return rtp.packetize(cfg, header_bytes, payloads)
        return header_bytes + b"".join(payloads)

    def _emit(self, pending, payloads, verbose):
        res, payload = self.finalize_frame(pending)
        payloads.append(payload)
        if verbose:
            idx = len(payloads) - 1
            print(f"frame {idx:3d} {res.frame_type}  "
                  f"PSNR Y {res.psnr_y:6.2f}  U {res.psnr_u:6.2f}  "
                  f"V {res.psnr_v:6.2f}  bits {res.bits}")
        return res

    # -- region (object) coding, num_regions == 2 ----------------------------
    def encode_sequence_region(self, frames, masks=None, verbose=False):
        """Region-coded sequence: luma P frames take the per-object masked
        fractal search (ops/region) with alpha-plane masks, chroma the
        fractal path.  ``masks`` are side information (the reference reads
        them from Infile_*_plane files, FR/src/image.c:96-103); without them
        the temporal-differencing segmenter (ops/segment) derives them.

        Returns (results, stream, masks) — the decoder needs the masks."""
        if masks is None:
            masks = [m.cpu().numpy() for m in SG.segment_sequence(
                [f[0] for f in frames], self.device)]
        masks_dev = [_as_tensor(m, self.device) for m in masks]
        results, payloads = [], []
        ref = None
        for idx, yuv in enumerate(frames):
            if self.is_intra(idx) or ref is None:
                res, payload = self.encode_frame(yuv, None, 0)
            else:
                res, payload = self.encode_region_frame(
                    yuv, ref, masks_dev[idx], masks_dev[idx - 1])
                if verbose:
                    print(f"frame {idx:3d} R  PSNR Y {res.psnr_y:6.2f}  "
                          f"bits {res.bits}")
            results.append(res)
            payloads.append(payload)
            ref = res.recon_dev
        return results, self._assemble(payloads, len(frames)), masks

    def encode_region_frame(self, yuv, ref, mask_cur, mask_ref, marks=None):
        """One region-coded P frame (type 3) against the reference frame
        ``ref`` and the alpha planes of this frame and the reference's.
        ``marks`` (see :func:`_mark`) gets an event after the region search,
        the region reconstruction, the luma residual coding and the chroma
        planes' fractal path.  Returns (FrameResult, payload bytes)."""
        fr = self.cfg.fractal
        y, u, v = _as_planes(yuv, self.device)
        ref = _as_planes(ref, self.device)
        m_cur = _as_tensor(mask_cur, self.device)
        m_ref = _as_tensor(mask_ref, self.device)
        qp = self.cfg.qp
        cqp = T.chroma_qp(qp)
        params = RG.region_search_plane(y, ref[0], m_cur, m_ref,
                                        search_range=fr.search_range,
                                        use_halfpel=fr.use_halfpel_refs)
        _mark(marks, y.device)
        frec = RG.region_reconstruct(params, ref[0], m_cur, m_ref,
                                     use_halfpel=fr.use_halfpel_refs)
        _mark(marks, y.device)
        zz_y, rec_y = T.residual_code_plane(y, frec, qp, True)
        _mark(marks, y.device)
        chroma = [self._p_plane(org, rf, cqp, False)
                  for org, rf in ((u, ref[1]), (v, ref[2]))]
        _mark(marks, y.device)

        w = BitWriter()
        w.u(3, 8)
        w.u(qp, 8)
        FS.write_region_params(w, {k: _host(t) for k, t in params.items()},
                               fr.search_range, fr.use_halfpel_refs)
        FS.write_residual(w, _host(zz_y), y.shape[0] // 4, y.shape[1] // 4,
                          int(self.cfg.entropy))
        recs = [rec_y]
        for org, (maps, zz, rec) in zip((u, v), chroma):
            FS.write_tree(w, {k: _host(m) for k, m in maps.items()},
                          fr.search_range, fr.use_halfpel_refs)
            FS.write_residual(w, _host(zz), org.shape[0] // 4,
                              org.shape[1] // 4, int(self.cfg.entropy))
            recs.append(rec)
        payload = w.to_bytes()
        rec_np = tuple(_host(r).astype(np.uint8) for r in recs)
        res = FrameResult(
            frame_type="R", psnr_y=psnr(_host(yuv[0]), rec_np[0]),
            psnr_u=psnr(_host(yuv[1]), rec_np[1]),
            psnr_v=psnr(_host(yuv[2]), rec_np[2]), bits=len(payload) * 8,
            recon=rec_np, recon_dev=tuple(recs), qp=qp)
        return res, payload

    # -- stereo / 3-view coding ----------------------------------------------
    def encode_sequence_views(self, view_frames, verbose: bool = False):
        """Encode 1 or 3 views (C[, R, L]) as the reference does
        (``FR/src/code.c:171-306``): every view is intra on I frames; on P
        frames the centre view predicts from its own previous
        reconstruction, the side views from their own previous
        reconstruction AND the centre's current one, the chosen frame
        signalled per leaf (3-bit ref: planes 0-3 own previous C/H/M/N,
        4-7 centre current).

        ``view_frames``: list over views of lists of (Y, U, V) frames.
        Returns (results [view][frame], stream bytes)."""
        n_views = len(view_frames)
        if n_views not in (1, 3):
            raise ValueError(f"1 or 3 views, not {n_views}")
        num_frames = len(view_frames[0])
        results = [[] for _ in range(n_views)]
        payloads = []
        ref_c = None
        prev_views = [None] * n_views
        queue = []
        for idx in range(num_frames):
            intra = self.is_intra(idx) or ref_c is None
            disp_c = self.dispatch_frame(view_frames[0][idx],
                                         None if intra else ref_c, idx)
            disps = [disp_c]
            for vi in range(1, n_views):
                disps.append(self.dispatch_frame(
                    view_frames[vi][idx], None if intra else prev_views[vi],
                    idx, ref2=None if intra else disp_c["recs"]))
            ref_c = disp_c["recs"]
            prev_views = [d["recs"] for d in disps]
            queue.append(disps)
            if len(queue) > 1:
                self._emit_views(queue.pop(0), results, payloads, verbose)
        while queue:
            self._emit_views(queue.pop(0), results, payloads, verbose)
        return results, self._assemble(payloads, num_frames, views=n_views)

    def _emit_views(self, disps, results, payloads, verbose):
        for vi, disp in enumerate(disps):
            res, payload = self.finalize_frame(disp)
            results[vi].append(res)
            payloads.append(payload)
            if verbose:
                print(f"frame {len(results[vi]) - 1:3d} view {vi} "
                      f"{res.frame_type}  PSNR Y {res.psnr_y:6.2f}  "
                      f"bits {res.bits}")


class FractalDecoder:
    """Decoder for FVC streams in any container: I (type 0), fractal P (1),
    classic P (2) and region P (3) frames, one or three views; mirrors the
    encoder's in-loop reconstruction bit-exactly."""

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def _i_plane(self, modes, zz, h, w, qp, deblock, luma, groups):
        rec = IN.decode_plane(modes, zz, h, w, qp)
        if deblock:
            bs_v, bs_h = DB.strengths_intra(h, w, self.device)
            rec = DB.deblock_plane_grouped(rec, bs_v, bs_h, qp, luma, groups)
        return rec

    @staticmethod
    def _add_residual(pred, zz, h, w, qp):
        deq = T.dequant4x4(T.zigzag_unscan(zz), qp)
        rec = T.reconstruct(T.frame_to_blocks(pred, 4), T.idct4x4(deq))
        return T.blocks_to_frame(rec, h, w)

    def _p_plane(self, maps, zz, ref, h, w, qp, use_hp, deblock, luma, groups,
                 ref2=None):
        refp = _pad16(ref)
        hp, wp = refp.shape
        ref2p = None if ref2 is None else _pad16(ref2)
        frec = F.reconstruct_from_maps(maps, refp, hp, wp, use_hp,
                                       ref2p)[:h, :w]
        rec = self._add_residual(frec, zz, h, w, qp)
        if deblock:
            nz = (zz != 0).any(dim=-1).reshape(h // 4, w // 4)
            bs_v, bs_h = DB.strengths_fractal(
                {k: m[:h // 4, :w // 4] for k, m in maps.items()}, nz)
            rec = DB.deblock_plane_grouped(rec, bs_v, bs_h, qp, luma, groups)
        return rec

    def _c_plane(self, mvx, mvy, zz, ref, h, w, qp, deblock, luma, groups):
        bs = 16 if luma else 8
        pred = ME.motion_compensate(ME.sixtap_halfpel(ref), mvx, mvy, bs, h, w)
        rec = self._add_residual(pred, zz, h, w, qp)
        if deblock:
            bs_v, bs_h = _classic_strengths(zz, mvx, mvy, 4 if luma else 2,
                                            h, w)
            rec = DB.deblock_plane_grouped(rec, bs_v, bs_h, qp, luma, groups)
        return rec

    @staticmethod
    def detect_container(stream: bytes) -> str:
        if stream[:4] == b"FVC1":
            return "fvc"
        if stream[:3] == b"\x00\x00\x01" or stream[:4] == b"\x00\x00\x00\x01":
            return "annexb"
        return "rtp"

    def decode(self, stream: bytes, verbose: bool = False, masks=None):
        """Decode a stream in any container (auto-detected); returns a list
        of (Y, U, V) uint8 frames, or one such list per view.  In Annex-B
        and RTP streams a lost frame unit is concealed by a copy of the
        previous frame (mid-grey planes when there is none; the simplest
        mode of the reference's ``erc_do_p.c``).  ``masks``: the alpha
        plane of every frame, needed for region-coded (type 3) frames."""
        self._masks = masks
        kind = self.detect_container(stream)
        if kind == "fvc":
            r = BitReader(stream)
            hdr = FS.read_header(r)

            def unit_reader(i):
                return r                  # one sequential reader
        else:
            unwrap = nal.unwrap_stream if kind == "annexb" else rtp.depacketize
            _, _, header_bytes, payloads = unwrap(stream)
            hdr = FS.read_header(BitReader(header_bytes))

            def unit_reader(i):
                return BitReader(payloads[i]) if i in payloads else None
        return self._decode_units(hdr, unit_reader, verbose)

    def _decode_region_y(self, r, hdr, ref_y, fidx, fqp):
        W, H = hdr["width"], hdr["height"]
        params = FS.read_region_params(r, H // 16, W // 16,
                                       hdr["search_range"], hdr["use_halfpel"])
        frec = RG.region_reconstruct(
            {k: _as_tensor(params[k], self.device)
             for k in ("a", "beta", "dx", "dy", "ref")}, ref_y,
            _as_tensor(self._masks[fidx], self.device),
            _as_tensor(self._masks[fidx - 1], self.device),
            use_halfpel=hdr["use_halfpel"])
        zz = FS.read_residual(r, H // 4, W // 4, hdr["entropy"])
        return self._add_residual(frec, _as_tensor(zz, self.device), H, W, fqp)

    def _decode_units(self, hdr: dict, unit_reader, verbose: bool = False):
        W, H = hdr["width"], hdr["height"]
        sr = hdr["search_range"]
        use_hp = hdr["use_halfpel"]
        dbl = hdr["deblock"]
        ent = hdr["entropy"]
        grp = max(hdr.get("tile_rows", 1), 1)
        plane_dims = [(H, W, True), (H // 2, W // 2, False),
                      (H // 2, W // 2, False)]
        n_views = max(hdr.get("views", 1), 1)

        def dev(a):
            return _as_tensor(a, self.device)

        def conceal(ref):
            """Frame copy for a lost unit (erc_do_p analogue); mid-grey
            planes when there is no reference yet (erc_do_i)."""
            if ref is not None:
                return 1, tuple(p.clone() for p in ref)
            return 0, tuple(torch.full((h, w), 128, dtype=torch.int32,
                                       device=self.device)
                            for h, w, _ in plane_dims)

        def decode_one(r, ref, fidx=0, ref2=None):
            """Parse and reconstruct one view's payload; ``ref`` its
            reference frame (None for intra), ``ref2`` the second reference
            frame (side views: the centre's current frame)."""
            if r is None:
                return conceal(ref)
            ftype = r.u(8)
            fqp = r.u(8)
            cqp = T.chroma_qp(fqp)
            qps = (fqp, cqp, cqp)
            planes = []
            if ftype == 0:
                for (h, w, luma), q in zip(plane_dims, qps):
                    modes = FS.read_intra_modes(r, h // 4, w // 4)
                    zz = FS.read_residual(r, h // 4, w // 4, ent)
                    planes.append(self._i_plane(dev(modes), dev(zz), h, w, q,
                                                dbl, luma, grp))
            elif ftype == 2:
                nmby, nmbx = H // 16, W // 16
                mvx = dev(r.se_array(nmby * nmbx).reshape(nmby, nmbx))
                mvy = dev(r.se_array(nmby * nmbx).reshape(nmby, nmbx))
                for pi, ((h, w, luma), q) in enumerate(zip(plane_dims, qps)):
                    zz = FS.read_residual(r, h // 4, w // 4, ent)
                    mx, my = (mvx, mvy) if luma else (mvx >> 1, mvy >> 1)
                    planes.append(self._c_plane(mx, my, dev(zz), ref[pi], h, w,
                                                q, dbl, luma, grp))
            elif ftype in (1, 3):
                if ftype == 3:            # region-coded luma
                    planes.append(self._decode_region_y(r, hdr, ref[0], fidx,
                                                        fqp))
                for pi, ((h, w, luma), q) in enumerate(zip(plane_dims, qps)):
                    if pi < len(planes):
                        continue
                    hp, wp = _pad16_np(h, w)
                    maps = FS.read_tree(r, hp, wp, sr, use_hp,
                                        ref_bits=None if ref2 is None else 3)
                    zz = FS.read_residual(r, h // 4, w // 4, ent)
                    planes.append(self._p_plane(
                        {k: dev(m) for k, m in maps.items()}, dev(zz),
                        ref[pi], h, w, q, use_hp, dbl, luma, grp,
                        None if ref2 is None else ref2[pi]))
            else:
                raise ValueError(f"unknown frame type {ftype}")
            r.byte_align()
            return ftype, tuple(planes)

        def out(planes):
            return tuple(p.to(torch.uint8).cpu().numpy() for p in planes)

        frames = [[] for _ in range(n_views)]
        ref_c = None
        prev_views = [None] * n_views
        for fi in range(hdr["num_frames"]):
            ftype, planes_c = decode_one(unit_reader(fi * n_views), ref_c,
                                         fidx=fi)
            ref_c = planes_c
            frames[0].append(out(planes_c))
            new_prev = [planes_c]
            for vi in range(1, n_views):
                # side views: own previous frame, and the centre's current
                # frame as the second reference (intra frames ignore both)
                _, planes_v = decode_one(
                    unit_reader(fi * n_views + vi), prev_views[vi],
                    ref2=None if ftype == 0 else planes_c)
                frames[vi].append(out(planes_v))
                new_prev.append(planes_v)
            prev_views = new_prev
            if verbose:
                print(f"decoded frame {fi} type {ftype}")
        return frames[0] if n_views == 1 else frames
