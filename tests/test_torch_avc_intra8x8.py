"""Intra 8x8 decoding (High profile I_NxN with transform_size_8x8_flag = 1)
in the PyTorch port's decoder against the JAX package's, on the CPU.

No encoder of either package writes Intra 8x8, so this file writes the
streams itself with the port's syntax writers: a High-profile IDR slice
whose MBs are all Intra 8x8, every 8x8 prediction mode that is legal at
its position in turn, random luma 8x8 and chroma residual levels and
varying mb_qp_delta, in CAVLC (each coded 8x8 as four interleaved 4x4
blocks with the spec's nC) and in CABAC (one LUMA_8x8 block per coded
8x8).  Both decoders must reconstruct the same pictures."""

import inspect

import numpy as np
import pytest

from h264tpu.avc.slice_dec import AVCDecoder as JDecoder
from h264tpu_torch.avc import cabac as CB
from h264tpu_torch.avc import cavlc as CV
from h264tpu_torch.avc import intra_pred as IP
from h264tpu_torch.avc import slice_dec as TSD
from h264tpu_torch.avc.params import (AVCParams, SLICE_I, assemble_stream,
                                      write_slice_header)
from h264tpu_torch.avc.slice_enc import FrameState, _nc_chroma, _nc_luma
from h264tpu_torch.avc.tables import CBP_TO_CODENUM_INTRA
from h264tpu_torch.entropy.bitio import BitWriter

H, W, QP = 48, 80, 28


def i8x8_availability(mby, mbx, b8, mb_w):
    """(top, left, top-right, top-left) availability of 8x8 block ``b8`` in
    a single raster slice (spec 6.4.11.2)."""
    mb_t, mb_l = mby > 0, mbx > 0
    avail_t = True if b8 >= 2 else mb_t
    avail_l = True if b8 & 1 else mb_l
    avail_tr = {0: mb_t, 1: mby > 0 and mbx < mb_w - 1, 2: True, 3: False}[b8]
    avail_c = {0: mb_t and mb_l, 1: mb_t, 2: mb_l, 3: True}[b8]
    return avail_t, avail_l, avail_tr, avail_c


def make_mbs(seed):
    """Per-MB syntax values: 8x8 prediction modes (each legal mode in turn),
    chroma mode, cbp, mb_qp_delta and levels (every coded luma 8x8 holds at
    least one nonzero level, as CABAC's LUMA_8x8 has no coded_block_flag)."""
    rng = np.random.default_rng(seed)
    mb_h, mb_w = H // 16, W // 16
    turn = 0
    mbs = []
    for mby in range(mb_h):
        for mbx in range(mb_w):
            modes = []
            for b8 in range(4):
                _, allowed = IP.pred8x8_all(
                    np.zeros(16, np.int64), np.zeros(8, np.int64), 0,
                    *i8x8_availability(mby, mbx, b8, mb_w))
                legal = np.flatnonzero(allowed)
                modes.append(int(legal[turn % len(legal)]))
                turn += 1
            _, c_allowed = IP.pred_chroma_all(
                np.zeros(8, np.int64), np.zeros(8, np.int64), 0,
                mby > 0, mbx > 0)
            c_legal = np.flatnonzero(c_allowed)
            cbp_luma = int(rng.integers(0, 16))
            cbp_chroma = int(rng.integers(0, 3))
            zz64 = np.zeros((4, 64), np.int64)
            for b8 in range(4):
                n = int(rng.integers(1, 10))
                pos = rng.choice(24, n, replace=False)
                zz64[b8, pos] = rng.choice([-7, -3, -2, -1, 1, 1, 2, 4], n)
            dc = rng.integers(-4, 5, (2, 4))
            ac = np.zeros((2, 2, 2, 15), np.int64)
            ac[..., :4] = rng.integers(-2, 3, (2, 2, 2, 4))
            cbp = cbp_luma | (cbp_chroma << 4)
            cmode = int(c_legal[len(mbs) % len(c_legal)])
            mbs.append(dict(modes=modes, cmode=cmode,
                            cbp_luma=cbp_luma, cbp_chroma=cbp_chroma,
                            dqp=int(rng.integers(-2, 3)) if cbp else 0,
                            zz64=zz64, dc=dc, ac=ac))
    return mbs


def mode_signal(grid, mby, mbx, b8, mode):
    """(prev_intra8x8_pred_mode_flag, rem) of ``mode``, the predicted mode
    from the left and upper neighbours' modes in ``grid`` (4x4 cells)."""
    cby, cbx = mby * 4 + 2 * (b8 >> 1), mbx * 4 + 2 * (b8 & 1)
    ma = int(grid[cby, cbx - 1]) if cbx > 0 else -2
    mb_ = int(grid[cby - 1, cbx]) if cby > 0 else -2
    mpm = 2 if -2 in (ma, mb_) else min(ma if ma >= 0 else 2,
                                        mb_ if mb_ >= 0 else 2)
    grid[cby:cby + 2, cbx:cbx + 2] = mode
    if mode == mpm:
        return 1, None
    return 0, mode - (1 if mode > mpm else 0)


def cavlc_slice(p, mbs):
    w = BitWriter()
    write_slice_header(w, p, SLICE_I, 0, True, QP)
    st = FrameState(p)
    grid = np.full((p.mb_h * 4, p.mb_w * 4), -1, np.int64)
    for i, mb in enumerate(mbs):
        mby, mbx = divmod(i, p.mb_w)
        by, bx = mby * 4, mbx * 4
        w.ue(0)                                  # mb_type I_NxN
        w.u(1, 1)                                # transform_size_8x8_flag
        for b8 in range(4):
            flag, rem = mode_signal(grid, mby, mbx, b8, mb["modes"][b8])
            w.u(flag, 1)
            if not flag:
                w.u(rem, 3)
        w.ue(mb["cmode"])
        cbp = mb["cbp_luma"] | (mb["cbp_chroma"] << 4)
        w.ue(int(CBP_TO_CODENUM_INTRA[cbp]))
        if cbp:
            w.se(mb["dqp"])
        for b8 in range(4):
            for b4 in range(4):
                bby = by + 2 * (b8 >> 1) + (b4 >> 1)
                bbx = bx + 2 * (b8 & 1) + (b4 & 1)
                if mb["cbp_luma"] & (1 << b8):
                    st.nnz_y[bby, bbx] = CV.write_block(
                        w, mb["zz64"][b8, b4::4], _nc_luma(st, bby, bbx), 16)
                else:
                    st.nnz_y[bby, bbx] = 0
        if mb["cbp_chroma"]:
            for ci in range(2):
                CV.write_block(w, mb["dc"][ci], -1, 4)
        for ci in range(2):
            for y4 in range(2):
                for x4 in range(2):
                    cby, cbx = mby * 2 + y4, mbx * 2 + x4
                    st.nnz_c[ci, cby, cbx] = CV.write_block(
                        w, mb["ac"][ci, y4, x4], _nc_chroma(st, ci, cby, cbx),
                        15) if mb["cbp_chroma"] == 2 else 0
        st.mb_decoded[mby, mbx] = True
    w.u(1, 1)                                    # rbsp_stop_one_bit
    return w.to_bytes()


def cabac_slice(p, mbs):
    hw = BitWriter()
    write_slice_header(hw, p, SLICE_I, 0, True, QP)
    pad = (-hw.bit_length()) % 8                 # cabac_alignment_one_bit
    if pad:
        hw.u((1 << pad) - 1, pad)
    st = CB.MBState(p.mb_w, p.mb_h)
    wtr = CB.CabacWriter(SLICE_I, QP, st)
    grid = np.full((p.mb_h * 4, p.mb_w * 4), -1, np.int64)
    payload = None
    for i, mb in enumerate(mbs):
        mby, mbx = divmod(i, p.mb_w)
        by, bx = mby * 4, mbx * 4
        c = CB._Common(st, mby, mbx, intra=True)
        wtr.mb_type_i_slice(c, None)             # I_NxN
        wtr.transform_size_flag(c, True)
        for b8 in range(4):
            flag, rem = mode_signal(grid, mby, mbx, b8, mb["modes"][b8])
            wtr.intra_pred_mode(flag, rem or 0)
        wtr.chroma_pred_mode(c, mb["cmode"])
        st.cipred[mby, mbx] = mb["cmode"]
        cbp = mb["cbp_luma"] | (mb["cbp_chroma"] << 4)
        wtr.cbp(c, cbp)
        st.cbp[mby, mbx] = cbp
        if cbp:
            wtr.mb_qp_delta(c, mb["dqp"])
        else:
            st.last_dqp = 0
        for b8 in range(4):
            if mb["cbp_luma"] & (1 << b8):
                wtr.residual_block(c, CB.LUMA_8x8, mb["zz64"][b8])
                for cy in range(2):
                    for cx in range(2):
                        c.set_cbf(CB.LUMA_4x4, by + 2 * (b8 >> 1) + cy,
                                  bx + 2 * (b8 & 1) + cx)
        if mb["cbp_chroma"]:
            for ci in range(2):
                wtr.residual_block(c, CB.CHROMA_DC, mb["dc"][ci], comp=ci)
        if mb["cbp_chroma"] == 2:
            for ci in range(2):
                for y4 in range(2):
                    for x4 in range(2):
                        wtr.residual_block(c, CB.CHROMA_AC,
                                           mb["ac"][ci, y4, x4],
                                           by=mby * 2 + y4, bx=mbx * 2 + x4,
                                           comp=ci)
        st.cat[mby, mbx] = CB.MBState.CAT_I4
        payload = wtr.end_of_slice(i == len(mbs) - 1)
    return hw.to_bytes() + payload


@pytest.mark.parametrize("entropy", ["cavlc", "cabac"])
def test_intra8x8_decode_equals_jax(entropy):
    p = AVCParams(width=W, height=H, qp=QP, profile_idc=100, level_idc=40,
                  transform_8x8=True, cabac=entropy == "cabac")
    mbs = make_mbs(seed=len(entropy))
    assert {m for mb in mbs for m in mb["modes"]} == set(range(9))
    assert {mb["cmode"] for mb in mbs} == set(range(4))
    rbsp = (cabac_slice if entropy == "cabac" else cavlc_slice)(p, mbs)
    stream = assemble_stream(p, [(True, rbsp)])
    dec = TSD.AVCDecoder()
    got = dec.decode(stream)
    assert dec.concealed_mbs == [0]          # every MB parsed from the slice
    want = JDecoder().decode(stream)
    assert len(got) == len(want) == 1
    for c in range(3):
        np.testing.assert_array_equal(got[0][c], want[0][c])
    # the residual reached the picture: not a flat prediction
    assert len(np.unique(got[0][0])) > 64


def test_intra8x8_raises_are_gone():
    src = inspect.getsource(TSD)
    assert "Intra 8x8 is not ported" not in src
    assert TSD._SliceDecoder._cabac_intra8x8_mb is TSD._cabac_intra8x8_mb
