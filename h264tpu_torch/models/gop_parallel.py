"""GOP-parallel encode distribution + per-GOP checkpoint/resume (the port's
copy of ``h264tpu/models/gop_parallel.py``; host code, it imports nothing
from ``h264tpu``).

The reference's only inter-frame dependency is the reconstruction chain,
which breaks at every IDR (``FR/src/code.c:155`` I_Frame period;
SURVEY §2.3 "inter-frame / GOP parallelism" and §5 checkpoint/resume:
IDR periods delimit independent GOPs).  This module turns that structure
into the multi-host axis:

* :func:`split_gops` — IDR-aligned work units.
* :class:`GOPEncoder` — encodes work units independently (each starts
  with its own IDR, so any unit can run on any host/chip with no
  communication), optionally fanned out over a worker pool — the DCN
  distribution shape: hosts pull GOP units, push encoded payloads, and
  the coordinator concatenates in display order.  The concatenated stream is
  byte-identical to the sequential encode of the same codec (tested).
* checkpoint/resume — each finished GOP's slices are written to a
  checkpoint directory; a restarted encode skips finished units (the
  codec-domain analog of step checkpointing; SURVEY §5).

On one card the workers share it: threads launch onto the card from one
interpreter (the AVC decision scan captures its CUDA graphs in thread-local
mode on a side stream, ``avc/device_enc.py`` ``_capture``, so one thread's
syncs and allocations do not break another's capture), and spawned
processes each open their own CUDA context.  The factories of
:mod:`h264tpu_torch.models.gop_workers` build the port's codecs on a given
device.
"""

from __future__ import annotations

import os
import pickle
from concurrent.futures import ThreadPoolExecutor


def _encode_unit_task(codec_factory, ckpt, gi: int, frames):
    """Top-level (picklable) GOP work item for process workers."""
    enc = GOPEncoder(codec_factory, intra_period=0, checkpoint_dir=ckpt)
    return enc._encode_unit(gi, frames)


def split_gops(n_frames: int, intra_period: int):
    """[(start, stop)] display-index ranges, each starting at an IDR.

    intra_period <= 0 means a single GOP (only frame 0 is an IDR)."""
    if intra_period <= 0 or intra_period >= n_frames:
        return [(0, n_frames)]
    return [(s, min(s + intra_period, n_frames))
            for s in range(0, n_frames, intra_period)]


class GOPEncoder:
    """Distribute IDR-delimited GOPs of a sequence over independent codec
    instances.

    ``codec_factory()`` must return a fresh encoder whose
    ``encode_sequence(frames)`` starts with an IDR (any of the package's
    codecs with their default first-frame-IDR behavior qualifies).
    """

    def __init__(self, codec_factory, intra_period: int,
                 checkpoint_dir: str = None):
        self.codec_factory = codec_factory
        self.intra_period = intra_period
        self.ckpt = checkpoint_dir
        if checkpoint_dir:
            os.makedirs(checkpoint_dir, exist_ok=True)

    def _unit_path(self, gi: int) -> str:
        return os.path.join(self.ckpt, f"gop_{gi:05d}.pkl")

    def _encode_unit(self, gi: int, frames):
        if self.ckpt:
            path = self._unit_path(gi)
            if os.path.exists(path):
                with open(path, "rb") as f:
                    return pickle.load(f)            # resume: skip work
        codec = self.codec_factory()
        results, stream = codec.encode_sequence(frames)
        out = dict(stream=stream,
                   psnr=[r.psnr_y for r in results],
                   bits=[r.bits for r in results])
        if self.ckpt:
            tmp = self._unit_path(gi) + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(out, f)
            os.replace(tmp, self._unit_path(gi))     # atomic commit
        return out

    def encode(self, frames, workers: int = 1, processes: bool = False):
        """Encode all GOPs (``workers`` > 1 fans units out concurrently —
        the per-host worker shape; on one card they share it).  Returns
        (units, stream) where ``stream`` is the display-order concatenation
        with a single parameter-set prefix.

        ``processes=True`` runs each worker as a SEPARATE spawned
        process — real host isolation (own interpreter, own CUDA context,
        work and results crossing a process boundary exactly like a DCN
        hop).  ``codec_factory`` must then be picklable (a top-level
        function or ``functools.partial`` of one; see
        :mod:`h264tpu_torch.models.gop_workers`).
        """
        frames = list(frames)
        spans = split_gops(len(frames), self.intra_period)
        if workers <= 1:
            units = [self._encode_unit(gi, frames[s:e])
                     for gi, (s, e) in enumerate(spans)]
        elif processes:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor
            with ProcessPoolExecutor(
                    max_workers=workers,
                    mp_context=mp.get_context("spawn")) as ex:
                futs = [ex.submit(_encode_unit_task, self.codec_factory,
                                  self.ckpt, gi, frames[s:e])
                        for gi, (s, e) in enumerate(spans)]
                units = [f.result() for f in futs]
        else:
            with ThreadPoolExecutor(max_workers=workers) as ex:
                futs = [ex.submit(self._encode_unit, gi, frames[s:e])
                        for gi, (s, e) in enumerate(spans)]
                units = [f.result() for f in futs]
        stream = self._concatenate([u["stream"] for u in units])
        return units, stream

    @staticmethod
    def _concatenate(streams):
        """Join per-GOP Annex-B streams: keep the first stream whole,
        strip the (identical) SPS/PPS prefix from the rest.  Non-Annex-B
        containers (raw FVC) are byte-concatenated for transport only —
        each GOP unit remains the independently decodable work product
        (the DCN distribution granule)."""
        if not streams:
            return b""
        if not (streams[0][:3] == b"\x00\x00\x01"
                or streams[0][:4] == b"\x00\x00\x00\x01"):
            return b"".join(streams)
        out = bytearray(streams[0])
        for s in streams[1:]:
            out += GOPEncoder._strip_parameter_sets(s)
        return bytes(out)

    @staticmethod
    def _strip_parameter_sets(stream: bytes) -> bytes:
        from ..bitstream.nal import annexb_parse, NAL_SPS, NAL_PPS, \
            annexb_write
        keep = [n for n in annexb_parse(stream)
                if n.nal_type not in (NAL_SPS, NAL_PPS)]
        return annexb_write(keep)
