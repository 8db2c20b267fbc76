"""The PyTorch port's CABAC layer against the JAX package, on the CPU, with no
JAX codec compiled: the M-coder engine on seeded bins, the CABAC slice
packers on symbols the port's encoder made (I and P, with and without the
8x8 transform), and an IPPP CABAC ``DeviceAVCCodec`` stream through both
decoders."""

import dataclasses

import numpy as np
import pytest
import torch

from h264tpu.avc import pack_cabac as JPKC
from h264tpu.avc.codec import AVCCodec
from h264tpu.avc.params import AVCParams as JParams
from h264tpu.entropy import cabac_eng as JC
from h264tpu_torch.avc import pack_cabac as PKC
from h264tpu_torch.avc.device_codec import DeviceAVCCodec, host_symbols
from h264tpu_torch.avc.params import AVCParams
from h264tpu_torch.avc.slice_dec import AVCDecoder
from h264tpu_torch.entropy import cabac_eng as C

from test_torch_avc_codec import smooth_frames


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bins(seed, n=4000):
    """Seeded (kind, ctx, bit) decisions: skewed context bins, bypass bins
    and end-of-slice 0 decisions, with seeded initial context states."""
    rng = np.random.default_rng(seed)
    kinds = rng.choice(3, n, p=[0.8, 0.15, 0.05])
    ctxs = rng.integers(0, C.NUM_CTX, n)
    p1 = rng.uniform(0.02, 0.98, C.NUM_CTX)
    bits = (rng.random(n) < p1[ctxs]).astype(int)
    states = rng.integers(0, 63, C.NUM_CTX)
    mps = rng.integers(0, 2, C.NUM_CTX)
    return kinds, ctxs, bits, states, mps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cabac_engine_matches_jax(seed):
    kinds, ctxs, bits, states, mps = _bins(seed)
    outs = []
    for mod in (C, JC):
        enc = mod.Encoder()
        enc.init_contexts(states, mps)
        for k, c, b in zip(kinds, ctxs, bits):
            if k == 0:
                enc.bit(int(c), int(b))
            elif k == 1:
                enc.bypass(int(b))
            else:
                enc.terminate0()
        outs.append(enc.flush())
    assert outs[0] == outs[1] and len(outs[0]) > 100
    for mod in (C, JC):
        dec = mod.Decoder(outs[0])
        dec.init_contexts(states, mps)
        got = [dec.bit(int(c)) if k == 0 else dec.bypass() if k == 1
               else dec.terminate() for k, c in zip(kinds, ctxs)]
        assert got == [int(b) if k < 2 else 0 for k, b in zip(kinds, bits)]


@pytest.mark.parametrize("seed", [3, 4])
def test_cabac_plane_coder_matches_jax(seed):
    rng = np.random.default_rng(seed)
    zz = np.where(rng.random((30, 16)) < 0.3, rng.integers(-40, 41, (30, 16)),
                  0).astype(np.int64)
    data = C.encode_plane(zz, 5, 6)
    assert data == JC.encode_plane(zz, 5, 6)
    np.testing.assert_array_equal(C.decode_plane(data, 5, 6), zz)


# (AVCParams fields, slices): Main CABAC; High CABAC with the 8x8
# transform
CABAC = {"main": (dict(profile_idc=77, cabac=True), 3),
         "high_t8": (dict(profile_idc=100, cabac=True, transform_8x8=True), 1)}


@pytest.fixture(scope="module", params=list(CABAC), ids=list(CABAC))
def symbols(request):
    """Host symbols of an IDR and a P frame that the port encoded at 48x64
    (each P slice predicting from the IDR's deblocked reconstruction)."""
    fields, S = CABAC[request.param]
    H, W, qp = 48, 64, 28
    p = AVCParams(width=W, height=H, qp=qp, **fields)
    codec = DeviceAVCCodec(p, search_range=8, n_slices=S, device="cpu")
    frames = smooth_frames(2, H, W)
    res, _ = codec.encode_sequence(frames[:1])
    sym_i, _, _ = codec.encode_frame(frames[0], [], qp)
    sym_p, _, _ = codec.encode_frame(frames[1], [codec.prep(res[0].recon)], qp)
    return dict(p=p, jp=JParams(**dataclasses.asdict(p)), S=S, qp=qp,
                name=request.param, i=host_symbols(sym_i),
                p_sym=host_symbols(sym_p))


def test_pack_i_slice_cabac_matches_jax(symbols):
    p, jp, S, qp = (symbols[k] for k in ("p", "jp", "S", "qp"))
    rows = p.mb_h // S
    for s in range(S):
        kw = dict(frame_num=0, idr=True, idr_pic_id=1, row0=s * rows,
                  n_rows=rows)
        got = PKC.pack_i_slice_cabac(symbols["i"], p, qp, **kw)
        assert got == JPKC.pack_i_slice_cabac(symbols["i"], jp, qp, **kw)


def test_pack_p_slice_cabac_matches_jax(symbols):
    p, jp, S, qp = (symbols[k] for k in ("p", "jp", "S", "qp"))
    sym = symbols["p_sym"]
    if symbols["name"] == "high_t8":
        assert sym["t8"].any(), "no P MB chose the 8x8 transform"
    assert ((sym["win"] >= 1) & (sym["win"] <= 4)).any()     # inter MBs
    rows = p.mb_h // S
    for s in range(S):
        for extra in ({}, dict(poc_lsb=6, mmco=[(1, 0)], reorder_l0=[(0, 1)])):
            kw = dict(frame_num=2, num_ref=1, row0=s * rows, n_rows=rows,
                      **extra)
            got = PKC.pack_p_slice_cabac(sym, p, qp, **kw)
            assert got == JPKC.pack_p_slice_cabac(sym, jp, qp, **kw)


@pytest.fixture(scope="module")
def ippp_cabac():
    H, W = 48, 64
    frames = smooth_frames(3, H, W)
    p = AVCParams(width=W, height=H, qp=30, profile_idc=77, cabac=True,
                  num_ref_frames=2)
    res, stream = DeviceAVCCodec(p, search_range=8, n_slices=3,
                                 device="cpu").encode_sequence(frames)
    return res, stream


def test_ippp_cabac_port_decoder_reproduces_recon(ippp_cabac):
    res, stream = ippp_cabac
    assert [r.frame_type for r in res] == ["IDR", "P", "P"]
    dec = AVCDecoder().decode(stream)
    assert len(dec) == 3
    for planes, r in zip(dec, res):
        for a, b in zip(planes, r.recon):
            np.testing.assert_array_equal(a, b)


def test_ippp_cabac_jax_decoder_reproduces_recon(ippp_cabac):
    res, stream = ippp_cabac
    dec, _ = AVCCodec.decode_sequence(stream)
    assert len(dec) == 3
    for planes, r in zip(dec, res):
        for a, b in zip(planes, r.recon):
            np.testing.assert_array_equal(a, b)
