"""Fractal + H.264 hybrid video codec — frame pipeline + FVC bitstream.

Port of ``h264tpu/models/fractal_codec.py`` for the IPPP path: every
``intra_period``-th frame is coded intra (9-mode wavefront), all others are
fractal P frames:

  fractal search (Y, U, V trees) -> fractal reconstruction -> residual
  DCT/quant -> final reconstruction -> [deblock] -> next reference,

and the tree + residual levels are entropy-coded on the host into the FVC
stream, byte for byte as the JAX package writes it.  ``encode_sequence``
keeps the reference's software pipeline: frame N's host entropy coding runs
while frame N+1's device work is queued.  A frame's host-bound outputs are
copied into pinned host memory as soon as they are queued, and the host
waits on that copy's event alone.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..utils.config import CodecConfig, EntropyMode
from ..ops import fractal as F
from ..ops import transform as T
from ..ops import intra as IN
from ..ops import deblock as DB
from ..entropy.bitio import BitWriter, BitReader
from ..entropy import fractal_syntax as FS

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
    return tuple((p if torch.is_tensor(p)
                  else torch.from_numpy(np.array(p, dtype=np.int32)))
                 .to(device=device, dtype=torch.int32) for p in planes)


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
    """Sequence encoder with fractal P frames, IPPP with the FVC container."""

    def __init__(self, cfg: CodecConfig, device=None):
        self.cfg = cfg.validate()
        self.device = resolve_device(device)
        _check_ported(cfg.inter_mode == "classic",
                      "inter_mode='classic' (ops/me.py)")
        _check_ported(cfg.rate_control, "rate control (models/ratectl.py)")
        _check_ported(cfg.num_regions == 2,
                      "num_regions=2 (ops/region.py, ops/segment.py)")
        _check_ported(cfg.views == 3, "views=3 (dual-reference search)")
        _check_ported(cfg.container != "fvc",
                      f"container={cfg.container!r} (bitstream/nal.py, rtp.py)")
        _check_ported(cfg.entropy != EntropyMode.CAVLC,
                      f"entropy={cfg.entropy!r} (entropy/cabac_eng.py)")
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
    def _p_plane(self, org, ref, qp, is_luma):
        h, w = org.shape
        orgp = _pad16(org)
        refp = _pad16(ref)
        hp, wp = orgp.shape
        tree = F.search_plane(orgp, refp, **self._search_kw)
        maps = F.leaf_maps(tree, hp, wp)
        frec = F.reconstruct_from_maps(maps, refp, hp, wp,
                                       self.cfg.fractal.use_halfpel_refs)[:h, :w]
        zz, rec = T.residual_code_plane(org, frec, qp, is_luma)
        if self.cfg.deblock:
            nz = (zz != 0).any(dim=-1).reshape(h // 4, w // 4)
            bs_v, bs_h = DB.strengths_fractal(
                {k: m[:h // 4, :w // 4] for k, m in maps.items()}, nz)
            rec = DB.deblock_plane_grouped(rec, bs_v, bs_h, qp, is_luma,
                                           self._groups)
        return maps, zz, rec

    def _p_step(self, y, u, v, ref_y, ref_u, ref_v, qp):
        cqp = T.chroma_qp(qp)
        all_maps, zzs, recs = [], [], []
        for org, ref, q, is_luma in ((y, ref_y, qp, True), (u, ref_u, cqp, False),
                                     (v, ref_v, cqp, False)):
            maps, zz, rec = self._p_plane(org, ref, q, is_luma)
            all_maps.append(maps)
            zzs.append(zz)
            recs.append(rec)
        return all_maps, zzs, recs

    # -- frame / sequence ----------------------------------------------------
    def is_intra(self, frame_idx: int) -> bool:
        if frame_idx == 0:
            return True
        ip = self.cfg.intra_period
        return ip > 0 and frame_idx % ip == 0

    def dispatch_frame(self, yuv, ref=None, frame_idx: int = 0,
                       qp: int = None) -> dict:
        """Queue all device work for one frame; returns a pending handle.

        The host does not wait here: the frame's host-bound outputs are
        copied to pinned memory behind an event that :meth:`finalize_frame`
        waits on.  ``ref`` may be numpy (uint8 or int32) or device tensors.
        """
        orgs = _as_planes(yuv, self.device)
        dims = [tuple(p.shape) for p in orgs]
        intra = self.is_intra(frame_idx) or ref is None
        if qp is None:
            qp = self.cfg.qp_i if intra else self.cfg.qp
        qp = int(qp)

        if intra:
            modes_l, zzs, recs = self._i_step(*orgs, qp)
        else:
            maps, zzs, recs = self._p_step(*orgs, *_as_planes(ref, self.device),
                                           qp)
        host = {}
        for i in range(3):
            if intra:
                host[f"{i}_modes"] = modes_l[i]
            else:
                for f in _MAP_KEYS:
                    host[f"{i}_{f}"] = maps[i][f]
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
        return dict(intra=intra, dims=dims, host=host, ready=ready,
                    recs=tuple(recs), qp=qp)

    def finalize_frame(self, pending: dict):
        """Wait for the frame's host copy and entropy-code it.

        Returns (FrameResult, payload bytes)."""
        cfg = self.cfg
        intra = pending["intra"]
        dims = pending["dims"]
        if pending["ready"] is not None:
            pending["ready"].synchronize()
        h = {k: t.numpy() for k, t in pending["host"].items()}

        w = BitWriter()
        w.u(0 if intra else 1, 8)
        w.u(int(pending["qp"]), 8)
        for i, (ph, pw) in enumerate(dims):
            if intra:
                FS.write_intra_modes(w, h[f"{i}_modes"])
            else:
                FS.write_tree(w, {f: h[f"{i}_{f}"] for f in _MAP_KEYS},
                              cfg.fractal.search_range,
                              cfg.fractal.use_halfpel_refs)
            FS.write_residual(w, h[f"{i}_zz"], ph // 4, pw // 4,
                              int(cfg.entropy))
        payload = w.to_bytes()

        psnrs = []
        for i, (ph, pw) in enumerate(dims):
            mse = float(h[f"{i}_sse"]) / (ph * pw)
            psnrs.append(99.99 if mse == 0 else
                         10.0 * np.log10(255.0 * 255.0 / mse))
        res = FrameResult(
            frame_type="I" if intra else "P", psnr_y=psnrs[0],
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
        N+1's device work (the recon feedback stays on the device).
        Returns (results, bitstream bytes)."""
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

    def _assemble(self, payloads, num_frames: int) -> bytes:
        """Raw FVC container: header + concatenated frame payloads."""
        hdr = BitWriter()
        FS.write_header(hdr, self.cfg, num_frames)
        return hdr.to_bytes() + b"".join(payloads)

    def _emit(self, pending, payloads, verbose):
        res, payload = self.finalize_frame(pending)
        payloads.append(payload)
        if verbose:
            idx = len(payloads) - 1
            print(f"frame {idx:3d} {res.frame_type}  "
                  f"PSNR Y {res.psnr_y:6.2f}  U {res.psnr_u:6.2f}  "
                  f"V {res.psnr_v:6.2f}  bits {res.bits}")
        return res


def _check_ported(asked: bool, what: str):
    if asked:
        raise NotImplementedError(f"{what} is not ported to h264tpu_torch yet")


class FractalDecoder:
    """Decoder for FVC streams with I (type 0) and fractal P (type 1) frames;
    mirrors the encoder's in-loop reconstruction bit-exactly."""

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def _i_plane(self, modes, zz, h, w, qp, deblock, luma, groups):
        rec = IN.decode_plane(modes, zz, h, w, qp)
        if deblock:
            bs_v, bs_h = DB.strengths_intra(h, w, self.device)
            rec = DB.deblock_plane_grouped(rec, bs_v, bs_h, qp, luma, groups)
        return rec

    def _p_plane(self, maps, zz, ref, h, w, qp, use_hp, deblock, luma, groups):
        refp = _pad16(ref)
        hp, wp = refp.shape
        frec = F.reconstruct_from_maps(maps, refp, hp, wp, use_hp)[:h, :w]
        deq = T.dequant4x4(T.zigzag_unscan(zz), qp)
        rec = T.reconstruct(T.frame_to_blocks(frec, 4), T.idct4x4(deq))
        rec = T.blocks_to_frame(rec, h, w)
        if deblock:
            nz = (zz != 0).any(dim=-1).reshape(h // 4, w // 4)
            bs_v, bs_h = DB.strengths_fractal(
                {k: m[:h // 4, :w // 4] for k, m in maps.items()}, nz)
            rec = DB.deblock_plane_grouped(rec, bs_v, bs_h, qp, luma, groups)
        return rec

    def decode(self, stream: bytes, verbose: bool = False):
        """Decode an FVC stream; returns a list of (Y, U, V) uint8 frames."""
        if stream[:4] != b"FVC1":
            raise NotImplementedError(
                "only the raw FVC container is ported; Annex-B and RTP "
                "streams (bitstream/nal.py, rtp.py) come in a later slice")
        r = BitReader(stream)
        hdr = FS.read_header(r)
        if hdr["views"] != 1:
            raise NotImplementedError("multi-view streams are not ported yet")
        return self._decode_units(hdr, r, verbose)

    def _decode_units(self, hdr: dict, r: BitReader, verbose: bool = False):
        W, H = hdr["width"], hdr["height"]
        sr = hdr["search_range"]
        use_hp = hdr["use_halfpel"]
        dbl = hdr["deblock"]
        grp = max(hdr.get("tile_rows", 1), 1)
        plane_dims = [(H, W, True), (H // 2, W // 2, False),
                      (H // 2, W // 2, False)]

        def dev(a):
            return torch.as_tensor(a).to(device=self.device, dtype=torch.int32)

        frames = []
        ref = None
        for fi in range(hdr["num_frames"]):
            ftype = r.u(8)
            fqp = r.u(8)
            cqp = T.chroma_qp(fqp)
            planes = []
            for pi, ((h, w, luma), q) in enumerate(zip(plane_dims,
                                                       (fqp, cqp, cqp))):
                if ftype == 0:
                    modes = FS.read_intra_modes(r, h // 4, w // 4)
                    zz = FS.read_residual(r, h // 4, w // 4, hdr["entropy"])
                    rec = self._i_plane(dev(modes), dev(zz), h, w, q, dbl,
                                        luma, grp)
                elif ftype == 1:
                    hp, wp = _pad16_np(h, w)
                    maps = FS.read_tree(r, hp, wp, sr, use_hp)
                    zz = FS.read_residual(r, h // 4, w // 4, hdr["entropy"])
                    rec = self._p_plane({k: dev(m) for k, m in maps.items()},
                                        dev(zz), ref[pi], h, w, q, use_hp,
                                        dbl, luma, grp)
                else:
                    raise NotImplementedError(
                        f"frame type {ftype} (classic inter / region-coded) "
                        "is not ported yet")
                planes.append(rec)
            r.byte_align()
            ref = planes
            frames.append(tuple(p.to(torch.uint8).cpu().numpy() for p in planes))
            if verbose:
                print(f"decoded frame {fi} type {'I' if ftype == 0 else 'P'}")
        return frames
