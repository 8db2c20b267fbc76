"""The PyTorch port's host conformant encoder (``h264tpu_torch.avc.codec``
``AVCCodec`` over ``avc/slice_enc.py``) against the JAX package's, on the
CPU: byte-identical Annex-B streams, equal reconstructions and picture QPs,
each package's decoder decoding the other's stream, the slice writers one
by one, and the constructor's guards."""

import dataclasses

import numpy as np
import pytest

from h264tpu.avc import codec as JC
from h264tpu.avc import inter as JI
from h264tpu.avc import slice_enc as JS
from h264tpu.avc.params import AVCParams as JParams
from h264tpu.avc.slice_dec import AVCDecoder as JDecoder
from h264tpu_torch.avc import codec as TC
from h264tpu_torch.avc import inter as TI
from h264tpu_torch.avc import slice_enc as TS
from h264tpu_torch.avc.params import params_from_dict
from h264tpu_torch.avc.slice_dec import AVCDecoder as TDecoder

H, W = 48, 64


def host_frames(n, seed=0, fade=0):
    """Smooth texture moving (1, 2) pels a frame with noise, a blocky patch
    over its left half, and luma raised by ``fade`` a frame."""
    rng = np.random.default_rng(seed)
    big = rng.normal(0, 1, (H + 2 * n, W + 2 * n))
    for _ in range(3):
        big = (big + np.roll(big, 1, 0) + np.roll(big, -1, 0)
               + np.roll(big, 1, 1) + np.roll(big, -1, 1)) / 5
    big = 128 + big / big.std() * 45
    blocks = np.kron(rng.integers(40, 220, (H // 8, W // 16)),
                     np.ones((8, 8)))
    out = []
    for i in range(n):
        y = big[i:i + H, 2 * i:2 * i + W] + rng.normal(0, 4, (H, W))
        y[:, :W // 2] = 0.5 * y[:, :W // 2] + 0.5 * np.roll(blocks, i, 1)
        y = np.clip(y + fade * i, 0, 255).astype(np.uint8)
        u = np.clip(y[::2, ::2] * 0.4 + 70 + rng.normal(0, 2, (H // 2, W // 2)),
                    0, 255).astype(np.uint8)
        v = np.clip(230 - y[1::2, 1::2] * 0.5
                    + rng.normal(0, 2, (H // 2, W // 2)), 0, 255).astype(np.uint8)
        out.append((y, u, v))
    return out


def force_row1_frame2(idx):
    if idx != 2:
        return None
    m = np.zeros((H // 16, W // 16), bool)
    m[1] = True
    return m


# name: (AVCParams fields, AVCCodec arguments, frames, fade, force_intra)
CASES = {
    "ippp_satd": ({}, {}, 3, 0, None),
    "ippp_sad": ({}, dict(use_satd=False), 3, 0, None),
    "idr_period2": ({}, dict(intra_period=2), 3, 0, None),
    "umhex": ({}, dict(me_method="umhex"), 3, 0, None),
    "refs3": (dict(num_ref_frames=3), {}, 4, 0, None),
    "wp_dc": (dict(weighted_pred=True, profile_idc=77, num_ref_frames=2),
              dict(wp_method="dc"), 3, 6, None),
    "wp_lms": (dict(weighted_pred=True, profile_idc=77, num_ref_frames=3),
               dict(wp_method="lms"), 4, 6, None),
    "rd_picture_decision": ({}, dict(rd_picture_decision=True), 3, 0, None),
    "redundant_slices": (dict(redundant_slices=True), {}, 3, 0, None),
    "open_gop": ({}, dict(intra_period=3, open_gop=True), 4, 0, None),
    "lossless": ({}, dict(lossless=True), 2, 0, None),
    "fmo_type0": (dict(slice_groups=2, slice_group_map_type=0),
                  dict(intra_period=1), 2, 0, None),
    "fmo_type1": (dict(slice_groups=2, slice_group_map_type=1),
                  dict(intra_period=1), 2, 0, None),
    "bframes2": (dict(profile_idc=77, poc_type=0, num_ref_frames=2),
                 dict(bframes=2), 4, 0, None),
    "force_intra": ({}, {}, 3, 0, force_row1_frame2),
}


def params_pair(**fields):
    jp = JParams(width=W, height=H, qp=28, **fields)
    return jp, params_from_dict(dataclasses.asdict(jp))


def assert_planes_equal(a, b, what):
    assert len(a) == len(b), what
    for i, (fa, fb) in enumerate(zip(a, b)):
        for c in range(3):
            np.testing.assert_array_equal(np.asarray(fa[c]), np.asarray(fb[c]),
                                          err_msg=f"{what}: frame {i} plane {c}")


@pytest.mark.parametrize("case", list(CASES))
def test_avc_codec_equals_jax(case):
    fields, kw, n, fade, force = CASES[case]
    frames = host_frames(n, seed=len(case), fade=fade)
    jp, tp = params_pair(**fields)
    jcodec = JC.AVCCodec(jp, search_range=4, **kw)
    tcodec = TC.AVCCodec(tp, search_range=4, **kw)
    extra = {} if force is None else dict(force_intra=force)
    j_res, j_stream = jcodec.encode_sequence(frames, **extra)
    t_res, t_stream = tcodec.encode_sequence(frames, **extra)

    assert t_stream == j_stream
    assert [r.frame_type for r in t_res] == [r.frame_type for r in j_res]
    assert [r.bits for r in t_res] == [r.bits for r in j_res]
    assert [r.psnr_y for r in t_res] == [r.psnr_y for r in j_res]
    assert getattr(tcodec, "pic_qps", None) == getattr(jcodec, "pic_qps", None)
    recons = [r.recon for r in t_res]
    assert_planes_equal(recons, [r.recon for r in j_res], "recon")
    # each package's decoder on the other's stream
    assert_planes_equal(TDecoder().decode(j_stream), recons, "port decoder")
    assert_planes_equal(JDecoder().decode(t_stream), recons, "JAX decoder")

    if case == "rd_picture_decision":
        assert len(tcodec.pic_qps) == n - 1
    if case == "lossless":
        assert_planes_equal(recons, frames, "lossless recon vs source")
    if case == "bframes2":
        assert [r.frame_type for r in t_res] == ["IDR", "B", "B", "P"]
    if case == "open_gop":
        from h264tpu_torch.avc import sei as TSEI
        from h264tpu_torch.bitstream.nal import annexb_parse
        seis = [u for u in annexb_parse(t_stream) if u.nal_type == 6]
        assert len(seis) == 1
        (ptype, payload), = TSEI.parse_sei_rbsp(seis[0].rbsp)
        assert ptype == TSEI.RECOVERY_POINT
        assert TSEI.parse_recovery_point(payload)["recovery_frame_cnt"] == 0


def _refs(pkg_inter, rec):
    return pkg_inter.RefPlanes(*[np.asarray(pl, np.int64) for pl in rec])


@pytest.mark.parametrize("fn", ["encode_i_frame", "encode_i_frame_pcm",
                                "encode_p_frame", "encode_b_frame",
                                "slice_group_map"])
def test_slice_writer_equals_jax(fn):
    frames = host_frames(3, seed=7)
    if fn == "slice_group_map":
        for G in (1, 2, 3):
            for t in (0, 1):
                jp, tp = params_pair(slice_groups=G, slice_group_map_type=t)
                np.testing.assert_array_equal(TS.slice_group_map(tp),
                                              JS.slice_group_map(jp))
        jp, tp = params_pair(slice_groups=2, slice_group_map_type=2)
        for mod, p in ((JS, jp), (TS, tp)):
            with pytest.raises(NotImplementedError):
                mod.slice_group_map(p)
        return
    jp, tp = params_pair(profile_idc=77, poc_type=0, num_ref_frames=2)
    if fn == "encode_i_frame_pcm":
        got = TS.encode_i_frame_pcm(frames[0], tp, idr_pic_id=3)
        want = JS.encode_i_frame_pcm(frames[0], jp, idr_pic_id=3)
        assert got[0] == want[0] and got[2] == want[2]
        assert_planes_equal([got[1]], [want[1]], fn)
        return
    j_i = JS.encode_i_frame(frames[0], jp, qp=30)
    t_i = TS.encode_i_frame(frames[0], tp, qp=30)
    assert t_i[0] == j_i[0] and t_i[2] == j_i[2]
    assert_planes_equal([t_i[1]], [j_i[1]], "I recon")
    if fn == "encode_i_frame":
        return
    j_p = JS.encode_p_frame(frames[2], [_refs(JI, j_i[1])], jp, qp=29,
                            frame_num=1, sr=6, use_satd=True, poc_lsb=4)
    t_p = TS.encode_p_frame(frames[2], [_refs(TI, t_i[1])], tp, qp=29,
                            frame_num=1, sr=6, use_satd=True, poc_lsb=4)
    assert t_p[0] == j_p[0] and t_p[3] == j_p[3]
    assert_planes_equal([t_p[1]], [j_p[1]], "P recon")
    for key in ("nnz", "mb_intra"):
        np.testing.assert_array_equal(t_p[2][key], j_p[2][key])
    np.testing.assert_array_equal(t_p[2]["mvf"].mv, j_p[2]["mvf"].mv)
    np.testing.assert_array_equal(t_p[2]["mvf"].ref, j_p[2]["mvf"].ref)
    if fn == "encode_p_frame":
        return
    col = (t_p[2]["mvf"].mv.copy(), t_p[2]["mvf"].ref.copy())
    j_b = JS.encode_b_frame(frames[1], [_refs(JI, j_i[1])],
                            [_refs(JI, j_p[1])], col, jp, qp=31,
                            frame_num=2, poc_lsb=2, sr=6,
                            ref_pocs0=[0], ref_pocs1=[4])
    t_b = TS.encode_b_frame(frames[1], [_refs(TI, t_i[1])],
                            [_refs(TI, t_p[1])], col, tp, qp=31,
                            frame_num=2, poc_lsb=2, sr=6,
                            ref_pocs0=[0], ref_pocs1=[4])
    assert t_b[0] == j_b[0] and t_b[3] == j_b[3]
    assert_planes_equal([t_b[1]], [j_b[1]], "B recon")
    for key in ("mv", "ref", "mv1", "ref1", "nnz", "mb_intra"):
        np.testing.assert_array_equal(t_b[2][key], j_b[2][key])


# (AVCParams fields, AVCCodec arguments) each AVCCodec.__init__ refuses
GUARDS = {
    "wp_method": ({}, dict(wp_method="ls")),
    "me_method": ({}, dict(me_method="epzs")),
    "open_gop_no_period": ({}, dict(open_gop=True)),
    "open_gop_bframes": (dict(profile_idc=77, poc_type=0, num_ref_frames=2),
                         dict(open_gop=True, intra_period=4, bframes=1)),
    "lossless_bframes": (dict(profile_idc=77, poc_type=0, num_ref_frames=2),
                         dict(lossless=True, bframes=1)),
    "cabac": (dict(profile_idc=77, cabac=True), {}),
    "bframes_poc_type": (dict(profile_idc=77, num_ref_frames=2),
                         dict(bframes=1)),
    "bframes_one_ref": (dict(profile_idc=77, poc_type=0), dict(bframes=1)),
    "bframes_baseline": (dict(poc_type=0, num_ref_frames=2), dict(bframes=1)),
    "fmo_with_p": (dict(slice_groups=2), dict(intra_period=0)),
}


@pytest.mark.parametrize("guard", list(GUARDS))
def test_codec_guard_raises_in_both(guard):
    fields, kw = GUARDS[guard]
    jp, tp = params_pair(**fields)
    with pytest.raises(ValueError):
        JC.AVCCodec(jp, **kw)
    with pytest.raises(ValueError):
        TC.AVCCodec(tp, **kw)


def test_shared_names_have_one_copy():
    """The port keeps one definition of each name the reference shares
    between modules."""
    from h264tpu_torch.avc import device_codec, mvc, slice_dec, wp
    from h264tpu_torch.ops import transform
    assert TC.AVCFrameResult is device_codec.AVCFrameResult \
        is mvc.AVCFrameResult
    assert TC.estimate_wp is wp.estimate_wp
    assert TC.estimate_wp_lms is wp.estimate_wp_lms
    assert TS.spatial_direct_16x16 is slice_dec.spatial_direct_16x16
    assert TS._COEFF_COST is transform.COEFF_COST
