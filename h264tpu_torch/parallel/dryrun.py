"""Dry run of the sharded paths over an ``n_slots`` mesh (the port's
``__graft_entry__.dryrun_multichip``, stages 1-4; its stage 5, the GOP
processes, is ``models/gop_parallel.GOPEncoder``).

    python3 -c "from h264tpu_torch.parallel.dryrun import dryrun_multichip;
                dryrun_multichip(8)"

runs on the card(s): slot i on card ``i % torch.cuda.device_count()``.
Pass ``devices=["cpu"] * n`` for CPU slots.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import Mesh
from .tiled_search import tiled_p_step


def mesh_devices(n_slots: int, devices=None) -> list:
    """``devices`` as ``torch.device``s, or by default ``n_slots`` slots
    over the cards, slot i on card ``i % device_count`` (raises with no
    card)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the dry run's default mesh needs a CUDA "
                               "device; pass devices=['cpu'] * n for CPU "
                               "slots")
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", i % count) for i in range(n_slots)]
    if len(devices) != n_slots:
        raise ValueError(f"{len(devices)} devices for {n_slots} slots")
    return [torch.device(d) for d in devices]


def dryrun_multichip(n_slots: int, devices=None) -> dict:
    """Run the sharded paths over a mesh of ``n_slots`` slots:

    1. the raw tiled fractal P step on a (gop, tile) mesh at 128x128, equal
       to the same step on one slot;
    2. ``FractalCodec.encode_sequence`` at CIF with deblocking over a
       (1, t) mesh, t in {1, 3, 9} (chroma tiles stay 16-row aligned);
    3. ``DeviceAVCCodec`` IPPP over the n-slot "slice" mesh (two row-band
       slices per slot), byte-identical to the unsharded encode;
    4. hierarchical-B CABAC over the same mesh, byte-identical too.

    Returns the stream sizes of stages 2-4; raises on any mismatch."""
    from ..utils.config import CodecConfig, FractalConfig
    from ..models.fractal_codec import FractalCodec
    from ..avc.params import AVCParams
    from ..avc.device_codec import DeviceAVCCodec

    devs = mesh_devices(n_slots, devices)
    rng = np.random.default_rng(0)

    def mk(shape):
        return rng.integers(0, 256, shape).astype(np.uint8)

    # stage 1: factor n_slots into (gop, tile)
    tile = next(t for t in (4, 2, 1) if n_slots % t == 0)
    gop = n_slots // tile
    mesh = Mesh(np.array(devs, dtype=object).reshape(gop, tile),
                ("gop", "tile"))
    h, w = 128, 128     # chroma tiles stay 16-row multiples for tile <= 4
    args = [torch.as_tensor(mk(s), dtype=torch.int32).to(devs[0])
            for s in ((gop, h, w), (gop, h // 2, w // 2),
                      (gop, h // 2, w // 2)) * 2]
    kw = dict(search_range=3, tol16=10.5, tol8=8.0, use_halfpel=True,
              deblock=True, tile_rows=tile)
    out = tiled_p_step(mesh, **kw)(*args, 28)
    one = tiled_p_step(Mesh([[devs[0]]], ("gop", "tile")), **kw)(*args, 28)
    for a, b in zip(out[-1], one[-1]):
        if a.shape[0] != gop or not torch.equal(a, b):
            raise AssertionError("dryrun stage 1: the tiled step's "
                                 "reconstruction differs from one slot's")
    print(f"dryrun_multichip stage 1 OK on mesh (gop={gop}, tile={tile}); "
          f"recon Y shape {tuple(out[-1][0].shape)}", flush=True)

    # stage 2: the fractal codec at CIF, deblock on, over a (1, t) mesh;
    # tile_rows divides CIF's 18 MB rows and is a multiple of t
    tile2 = 9 if n_slots >= 9 else (3 if n_slots >= 3 else 1)
    tmesh = Mesh([devs[:tile2]], ("gop", "tile"))
    cfg = CodecConfig(width=352, height=288, qp=28, intra_period=8,
                      deblock=True, tile_rows={1: 3, 3: 9, 9: 9}[tile2],
                      fractal=FractalConfig(search_range=3))
    frames = [tuple(mk(s) for s in ((288, 352), (144, 176), (144, 176)))
              for _ in range(2)]
    results, stream = FractalCodec(cfg, mesh=tmesh).encode_sequence(frames)
    if not stream or len(results) != 2:
        raise AssertionError("dryrun stage 2: no sharded CIF stream")
    print(f"dryrun_multichip stage 2 OK: sharded CIF encode_sequence with "
          f"deblock over (1, {tile2}) mesh -> {len(stream)} stream bytes",
          flush=True)

    # stage 3: the conformant encoder, two row-band slices per slot
    ah, ns = 32 * n_slots, 2 * n_slots
    amesh = Mesh(devs, ("slice",))
    p = AVCParams(width=176, height=ah, qp=30, num_ref_frames=1)
    frames_a = [tuple(mk(s) for s in ((ah, 176), (ah // 2, 88), (ah // 2, 88)))
                for _ in range(2)]
    _, s_ref = DeviceAVCCodec(p, search_range=4, n_slices=ns,
                              device=devs[0]).encode_sequence(frames_a)
    _, s_sh = DeviceAVCCodec(p, search_range=4, n_slices=ns,
                             mesh=amesh).encode_sequence(frames_a)
    if s_sh != s_ref:
        raise AssertionError("dryrun stage 3: sharded AVC stream != 1-way")
    print(f"dryrun_multichip stage 3 OK: AVC encode over {n_slots}-slot "
          f"slice mesh, {len(s_sh)} bytes, byte-identical to 1-way",
          flush=True)

    # stage 4: hierarchical-B CABAC, anchors and B pictures sharded
    pb = AVCParams(width=176, height=ah, qp=30, profile_idc=77, poc_type=0,
                   num_ref_frames=3, cabac=True)
    frames_b = [tuple(mk(s) for s in ((ah, 176), (ah // 2, 88), (ah // 2, 88)))
                for _ in range(5)]
    bkw = dict(search_range=4, n_slices=ns, bframes=3, hierarchical=True)
    _, sb_ref = DeviceAVCCodec(pb, device=devs[0], **bkw).encode_sequence(
        frames_b)
    _, sb_sh = DeviceAVCCodec(pb, mesh=amesh, **bkw).encode_sequence(frames_b)
    if sb_sh != sb_ref:
        raise AssertionError("dryrun stage 4: sharded hier-B stream != "
                             "1-way")
    print(f"dryrun_multichip stage 4 OK: hierarchical-B CABAC over "
          f"{n_slots}-slot mesh, {len(sb_sh)} bytes, byte-identical",
          flush=True)
    return dict(fractal_bytes=len(stream), avc_bytes=len(s_sh),
                hierb_bytes=len(sb_sh))
