"""Row-tile sharding of the fractal P step over a (gop, tile) mesh.

Port of ``h264tpu/parallel/tiled_search.py``.  The fractal P path has no
MB-to-MB dependency inside a frame: search and reconstruction read only the
previous reconstruction.  So each frame is cut into horizontal MB-row tiles
along the mesh's ``tile`` axis, and the frames of a batch are spread along
its ``gop`` axis.  The only communication is a halo of ``search_range + 1``
reference rows from each tile's neighbours (:func:`halo_exchange_rows`, an
explicit copy to the tile's device where the JAX package uses ``ppermute``).

Shard invariance: with the frame border edge-replicated, per-tile domain-row
validity bounds and the deblock in row bands fixed by ``tile_rows`` (not by
the slot count; ``ops.deblock.deblock_plane_grouped``), the tiled step
returns exactly the trees, coefficients and reconstruction of the whole-frame
step, and the codec the same stream (``tests/test_torch_parallel.py``).
"""

from __future__ import annotations

import torch

from .. import trace
from ..ops import deblock as DB
from ..ops import fractal as F
from ..ops import transform as T
from .mesh import Mesh, gather, split_rows

_MAP_KEYS = ("a", "beta", "dx", "dy", "ref", "shape")


def halo_exchange_rows(tiles, halo: int) -> list:
    """The row tiles [hl, W] of one plane, in tile order, each on its slot's
    device -> [hl + 2*halo, W] tiles on the same devices: the neighbours'
    rows above and below, copied to the tile's device, and at the frame
    border (the first tile's top, the last tile's bottom) the edge row
    replicated, as ``ops.fractal.halfpel_planes`` replicates it."""
    n = len(tiles)
    out = []
    for i, x in enumerate(tiles):
        if halo > x.shape[0]:
            raise ValueError(f"halo {halo} exceeds the tile height "
                             f"{x.shape[0]}")
        top = tiles[i - 1][-halo:].to(x.device) if i > 0 else \
            x[:1].expand(halo, -1)
        bot = tiles[i + 1][:halo].to(x.device) if i < n - 1 else \
            x[-1:].expand(halo, -1)
        out.append(torch.cat([top, x, bot]))
    return out


def _local_plane_step(org, ext, qp: int, *, tile: int, n_tiles: int,
                      search_range: int, tol16: float, tol8: float,
                      use_halfpel: bool, is_luma: bool, deblock: bool,
                      local_groups: int, search_mode: int = 0,
                      chun_lo: float = 0.9, chun_hi: float = 1.0, bounds=None):
    """Encode one plane tile: search, fractal reconstruction, residual coding
    and the banded deblock of its ``local_groups`` bands, in the spans
    ``fractal.tile.search``, ``.recon``, ``.residual`` and ``.deblock`` on
    the tile's device.  ``ext`` is the tile's reference with its halo rows
    (:func:`halo_exchange_rows`)."""
    sr = search_range
    halo = sr + 1
    hl, W = org.shape
    dev = org.device
    y_lo = 0 if tile == 0 else -sr
    y_hi = hl if tile == n_tiles - 1 else hl + sr
    with trace.span("fractal.tile.search", dev):
        tree = F.search_plane(org, ext, search_range=sr, tol16=tol16,
                              tol8=tol8, use_halfpel=use_halfpel,
                              search_mode=search_mode, chun_lo=chun_lo,
                              chun_hi=chun_hi, bounds=bounds, halo=halo,
                              y_lo=y_lo, y_hi=y_hi)
    with trace.span("fractal.tile.recon", dev):
        maps = F.leaf_maps(tree, hl, W)
        frec = F.reconstruct_from_maps(maps, ext, hl, W, use_halfpel,
                                       halo=halo)
    with trace.span("fractal.tile.residual", dev):
        zz, rec = T.residual_code_plane(org, frec, qp, is_luma)
    if deblock:
        with trace.span("fractal.tile.deblock", dev):
            nz = (zz != 0).any(dim=-1).reshape(hl // 4, W // 4)
            bs_v, bs_h = DB.strengths_fractal(maps, nz)
            rec = DB.deblock_plane_grouped(rec, bs_v, bs_h, qp, is_luma,
                                           local_groups)
    return maps, zz, rec


def tiled_p_step(mesh: Mesh, search_range: int, tol16: float, tol8: float,
                 use_halfpel: bool = True, deblock: bool = False,
                 tile_rows: int = None, search_mode: int = 0,
                 chun_lo: float = 0.9, chun_hi: float = 1.0, bounds=None):
    """The sharded fractal P step over ``mesh`` with axes ("gop", "tile").

    Returns ``step(y, u, v, ref_y, ref_u, ref_v, qp)`` over
    batched planes [B, H, W] / [B, H/2, W/2] (B a multiple of the gop
    axis; frame b goes to gop slot b // (B / gop)), with ``qp`` the luma QP.
    Tile heights (H and H/2 over the tile count) must be multiples of 16.
    It returns ((maps_y, maps_u, maps_v) dicts of [B, h/4, w/4] int32,
    (zz_y, zz_u, zz_v) [B, h/4 * w/4, 16], (rec_y, rec_u, rec_v) [B, h, w])
    on the device of ``y``.  ``tile_rows`` (default: the tile count) is the
    config-fixed deblock band grid, a multiple of the tile count.
    """
    if set(mesh.axis_names) != {"gop", "tile"}:
        raise ValueError("tiled_p_step needs a mesh with axes ('gop', "
                         f"'tile'), not {mesh.axis_names}")
    n_gop, n_tiles = mesh.shape["gop"], mesh.shape["tile"]
    tile_rows = n_tiles if tile_rows is None else tile_rows
    if tile_rows % n_tiles:
        raise ValueError("tile_rows must be a multiple of the mesh tile axis")
    g_ax = mesh.axis_names.index("gop")
    kw = dict(n_tiles=n_tiles, search_range=search_range, tol16=tol16,
              tol8=tol8, use_halfpel=use_halfpel, deblock=deblock,
              local_groups=tile_rows // n_tiles, search_mode=search_mode,
              chun_lo=chun_lo, chun_hi=chun_hi, bounds=bounds)

    def slot(g: int, t: int) -> torch.device:
        return mesh.devices[(g, t) if g_ax == 0 else (t, g)]

    def plane(org_b, ref_b, qp: int, is_luma: bool):
        """One plane of every frame of the batch."""
        B, H, W = org_b.shape
        if B % n_gop:
            raise ValueError(f"batch {B} does not split over the gop axis "
                             f"of {n_gop}")
        if (H // n_tiles) % 16 or W % 16:
            raise ValueError(f"a [{H}, {W}] plane over {n_tiles} tiles does "
                             "not give tiles of whole 16-row MB rows")
        home = org_b.device
        maps, zzs, recs = [], [], []
        for b in range(B):
            g = b // (B // n_gop)
            devs = [slot(g, t) for t in range(n_tiles)]
            orgs = [x.to(d) for x, d in zip(split_rows(org_b[b], n_tiles),
                                             devs)]
            refs = [x.to(d) for x, d in zip(split_rows(ref_b[b], n_tiles),
                                             devs)]
            exts = halo_exchange_rows(refs, search_range + 1)
            outs = [_local_plane_step(o, e, qp, tile=t, is_luma=is_luma,
                                      **kw)
                    for t, (o, e) in enumerate(zip(orgs, exts))]
            maps.append({k: gather([m[k] for m, _, _ in outs], home)
                         for k in _MAP_KEYS})
            zzs.append(gather([z for _, z, _ in outs], home))
            recs.append(gather([r for _, _, r in outs], home))
        return ({k: torch.stack([m[k] for m in maps]) for k in _MAP_KEYS},
                torch.stack(zzs), torch.stack(recs))

    def step(y, u, v, ref_y, ref_u, ref_v, qp: int):
        cqp = T.chroma_qp(qp)
        outs = [plane(o, r, q, luma)
                for o, r, q, luma in ((y, ref_y, qp, True),
                                      (u, ref_u, cqp, False),
                                      (v, ref_v, cqp, False))]
        return tuple(tuple(o[i] for o in outs) for i in range(3))

    return step
