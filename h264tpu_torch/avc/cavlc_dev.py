"""CAVLC residual bit costs on tensors, for the encoder's RD decisions.

Port of ``h264tpu/avc/cavlc_jax.py``: the number of bits that
``avc.cavlc.write_block`` would emit for a candidate block, as array math over
``[..., n]`` zig-zag level vectors.  ``block_bits`` is exact (the level-VLC
adaptation chain is a loop over scan ranks); ``block_bits_est`` is the
chain-free estimate the mode decision uses.  Bit lengths are taken by integer
shifts and compares, never by a float logarithm.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device_const
from ..entropy.cavlc import (COEFF_TOKEN_LEN, TOTAL_ZEROS_LEN,
                             RUN_BEFORE_LEN, INC_VLC)
from .tables import CHROMA_DC_TOKEN_LEN, CHROMA_DC_TZ_LEN

_TABLES = {
    "cavlc_token_len": np.asarray(COEFF_TOKEN_LEN, np.int32),     # [3,4,17]
    "cavlc_tz_len": np.asarray(TOTAL_ZEROS_LEN, np.int32),        # [15,16]
    "cavlc_rb_len": np.asarray(RUN_BEFORE_LEN, np.int32),         # [7,16]
    "cavlc_inc": np.asarray(INC_VLC, np.int32),                   # [7]
    "cavlc_cdc_token_len": np.asarray(CHROMA_DC_TOKEN_LEN, np.int32),
    "cavlc_cdc_tz_len": np.asarray(CHROMA_DC_TZ_LEN, np.int32),
}


def _t(name: str, device) -> torch.Tensor:
    return device_const(name, _TABLES[name], device)


def bitlen(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) + 1 for x >= 1 and 0 for x <= 0, int32, by a binary
    search over right shifts (exact for every int32)."""
    x = torch.clamp(x.to(torch.int32), min=0)
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        hi = (x >> s) > 0
        x = torch.where(hi, x >> s, x)
        n = n + torch.where(hi, s, 0)
    return n + (x > 0).to(torch.int32)


def _level_len(labs, sign, vlcnum):
    """Length of one level code (labs >= 1), int32 tensors."""
    l0 = torch.where(
        labs < 8, 2 * labs - 1 + sign,
        torch.where(labs < 16, 19,
                    28 + 2 * torch.clamp(bitlen(labs + 2032) - 12, min=0)))
    shift = vlcnum - 1
    escape = 15 << torch.clamp(shift, min=0)
    labn = labs - 1
    ln = (labn >> torch.clamp(shift, min=0)) + 1 + vlcnum
    lesc = labn - escape + 2048
    lesc_len = 28 + 2 * torch.clamp(bitlen(torch.clamp(lesc, min=1)) - 12, min=0)
    lN = torch.where(labn < escape, ln, lesc_len)
    return torch.where(vlcnum == 0, l0, lN)


def block_fields(zz: torch.Tensor) -> dict:
    """CAVLC fields of [..., n] zig-zag levels: total, t1, total_zeros,
    lev_by_rank (levels by scan rank) and run_by_rank (zeros before each
    nonzero, by rank)."""
    n = zz.shape[-1]
    zz = zz.to(torch.int32)
    nz = zz != 0
    total = nz.sum(-1, dtype=torch.int32)
    idx = torch.arange(n, dtype=torch.int32, device=zz.device)
    last_pos = torch.where(nz, idx, -1).amax(-1)
    total_zeros = last_pos + 1 - total
    # nonzero positions first, each group in scan order (unique keys)
    order = torch.argsort(torch.where(nz, idx, idx + n), dim=-1)
    lev_by_rank = torch.gather(zz, -1, order)
    pos_by_rank = order.to(torch.int32)
    prev_pos = torch.cat([torch.full_like(pos_by_rank[..., :1], -1),
                          pos_by_rank[..., :-1]], dim=-1)
    run_by_rank = pos_by_rank - prev_pos - 1
    rank = idx.expand(zz.shape)
    rev_rank = total[..., None] - 1 - rank
    non_one = (torch.abs(lev_by_rank) != 1) & (rank < total[..., None])
    m = torch.where(non_one, rev_rank, n).amin(-1)
    t1 = torch.minimum(torch.clamp(m, max=3), total)
    return dict(total=total, t1=t1, total_zeros=total_zeros,
                lev_by_rank=lev_by_rank, run_by_rank=run_by_rank)


def _token_bits(total, t1, nc, chroma_dc: bool, device):
    if chroma_dc:
        return _t("cavlc_cdc_token_len", device)[t1.long(), total.long()]
    if not isinstance(nc, torch.Tensor):
        nc = torch.full_like(total, nc)      # no host copy (graph capture)
    vt = torch.where(nc < 2, 0, torch.where(nc < 4, 1, torch.where(nc < 8, 2, 3)))
    tbl = _t("cavlc_token_len", device)[torch.clamp(vt, max=2).long(),
                                         t1.long(), total.long()]
    return torch.where(vt == 3, 6, tbl)


def _tz_bits(total, tz, max_coeff: int, chroma_dc: bool, device):
    has_tz = (total > 0) & (total < max_coeff)
    if chroma_dc:
        tz_len = _t("cavlc_cdc_tz_len", device)[
            torch.clamp(total - 1, 0, 2).long(), torch.clamp(tz, 0, 3).long()]
    else:
        tz_len = _t("cavlc_tz_len", device)[
            torch.clamp(total - 1, 0, 14).long(), torch.clamp(tz, 0, 15).long()]
    return torch.where(has_tz, tz_len, 0)


def block_bits(zz: torch.Tensor, nc, max_coeff: int,
               chroma_dc: bool = False) -> torch.Tensor:
    """Exact bit cost of ``avc.cavlc.write_block(w, zz, nc, max_coeff)``.

    zz [..., max_coeff] int levels in scan order; nc [...] (ignored when
    ``chroma_dc``).  Returns [...] int32 bit counts."""
    dev = zz.device
    f = block_fields(zz)
    total, t1, tz = f["total"], f["t1"], f["total_zeros"]
    lev, runs = f["lev_by_rank"], f["run_by_rank"]
    n = zz.shape[-1]
    bits = _token_bits(total, t1, nc, chroma_dc, dev) + t1

    # level VLC chain over coding order (rank total-1-t1 down to 0)
    vlcnum = torch.where((total > 10) & (t1 < 3), 1, 0).to(torch.int32)
    lth = ~((total > 3) & (t1 == 3))
    first_rank = total - 1 - t1
    inc_tab = _t("cavlc_inc", dev)
    for i in range(n):
        k = first_rank - i
        active = k >= 0
        lv = torch.gather(lev, -1, torch.clamp(k, min=0).long()[..., None])[..., 0]
        labs = torch.abs(lv)
        sign = (lv < 0).to(torch.int32)
        adj = torch.where(lth & active, labs - 1, labs) if i == 0 else labs
        ln = _level_len(torch.clamp(adj, min=1), sign, vlcnum)
        bits = bits + torch.where(active & (adj > 0), ln, 0)
        bits = bits + torch.where(active & (adj == 0), sign, 0)
        inc = (labs > inc_tab[torch.clamp(vlcnum, max=6).long()]).to(torch.int32)
        vlcnum = torch.where(active, vlcnum + inc, vlcnum)
        if i == 0:
            vlcnum = torch.where(active & (labs > 3),
                                 torch.clamp(vlcnum, min=2), vlcnum)

    bits = bits + _tz_bits(total, tz, max_coeff, chroma_dc, dev)

    rb_tab = _t("cavlc_rb_len", dev)
    zerosleft = tz
    for i in range(n - 1):
        k = total - 1 - i
        active = (k >= 1) & (zerosleft > 0)
        run = torch.gather(runs, -1, torch.clamp(k, min=0).long()[..., None])[..., 0]
        rl = rb_tab[torch.clamp(zerosleft - 1, 0, 6).long(),
                    torch.clamp(run, 0, 15).long()]
        bits = bits + torch.where(active, rl, 0)
        zerosleft = torch.where(active, zerosleft - run, zerosleft)
    return bits


def block_bits_est(zz: torch.Tensor, nc, max_coeff: int,
                   chroma_dc: bool = False) -> torch.Tensor:
    """Chain-free CAVLC bit estimate for the encoder's RD costs.

    Exact: token / total_zeros table lengths, trailing-one signs, the level
    adjustment of the first coded level, and the run_before zerosleft rows.
    Approximate: the level-VLC adaptation is init + 1 after the first coded
    level + one increment per earlier level with |l| > 3, capped at 6.  The
    emitted stream is unaffected (decisions only)."""
    dev = zz.device
    f = block_fields(zz)
    total, t1, tz = f["total"], f["t1"], f["total_zeros"]
    lev, runs = f["lev_by_rank"], f["run_by_rank"]
    n = zz.shape[-1]
    bits = _token_bits(total, t1, nc, chroma_dc, dev) + t1

    rank = torch.arange(n, dtype=torch.int32, device=dev)
    first_rank = (total - 1 - t1)[..., None]
    coded = (rank <= torch.clamp(first_rank, min=-1)) \
        & (rank < (total - t1)[..., None])
    labs = torch.abs(lev)
    sign = (lev < 0).to(torch.int32)

    init = torch.where((total > 10) & (t1 < 3), 1, 0).to(torch.int32)
    is_first = rank == first_rank
    lth = ~((total > 3) & (t1 == 3))
    labs_adj = torch.where(is_first & lth[..., None] & coded,
                           torch.clamp(labs - 1, min=1), labs)
    big = (labs > 3) & coded
    csum = torch.cumsum(big.to(torch.int32), dim=-1, dtype=torch.int32)
    big_after = csum[..., -1:] - csum
    any_after = (first_rank - rank) > 0
    first_big = torch.gather(labs, -1, torch.clamp(first_rank, min=0).long()) > 3
    first_inc = torch.where(init[..., None] == 0, 1, first_big.to(torch.int32))
    later_big = big_after - torch.where(any_after & first_big, 1, 0)
    vlc = init[..., None] + torch.where(any_after & coded, first_inc + later_big, 0)
    vlc = torch.where(any_after & coded & first_big, torch.clamp(vlc, min=2), vlc)
    vlc = torch.clamp(vlc, 0, 6)
    ln = _level_len(torch.clamp(labs_adj, min=1), sign, vlc)
    bits = bits + torch.where(coded, ln, 0).sum(-1, dtype=torch.int32)

    bits = bits + _tz_bits(total, tz, max_coeff, chroma_dc, dev)

    rsum = torch.cumsum(runs, dim=-1, dtype=torch.int32)
    run_above = rsum[..., -1:] - rsum
    zerosleft = tz[..., None] - run_above
    run_coded = (rank >= 1) & (rank <= (total - 1)[..., None]) & (zerosleft > 0)
    rb = _t("cavlc_rb_len", dev)[torch.clamp(zerosleft - 1, 0, 6).long(),
                                 torch.clamp(runs, 0, 15).long()]
    return bits + torch.where(run_coded, rb, 0).sum(-1, dtype=torch.int32)
