"""Explicit weighted prediction in the PyTorch port's conformant encoder
against the JAX package, on the CPU: the host WP estimators, the luma
plane weighting, a ``TPUAVCCodec`` parity run on an additive fade with both
estimators (byte-identical streams, both decoders), and one High-profile P
frame (8x8 transform, sub-8x8 partitions) encoded with chroma weights from
the JAX reference state.  Everything is exact."""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from h264tpu.avc import codec as JC, tpu_enc as TE
from h264tpu.avc.codec import AVCCodec
from h264tpu.avc.params import AVCParams as JParams
from h264tpu.avc.tpu_codec import TPUAVCCodec, _weight_luma
from h264tpu_torch.avc import device_enc as DE, slice_dec as SD
from h264tpu_torch.avc import wp as WP
from h264tpu_torch.avc.device_codec import DeviceAVCCodec
from h264tpu_torch.avc.params import params_from_dict
from h264tpu_torch.avc.slice_dec import AVCDecoder


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fade_frames(n, H, W, seed=0, step=6):
    """An additive fade: a smooth texture moving (2, 1) pels a frame whose
    luma rises by ``step`` per frame (clipped) and whose chroma drifts by
    +-2; a gain-and-offset fit sees w = 32, o = step."""
    rng = np.random.default_rng(seed)
    big = rng.normal(0, 1, (H + 2 * n, W + 2 * n))
    for _ in range(3):
        big = (big + np.roll(big, 1, 0) + np.roll(big, -1, 0)
               + np.roll(big, 1, 1) + np.roll(big, -1, 1)) / 5
    big = 110 + big / big.std() * 40
    out = []
    for i in range(n):
        y = big[i:i + H, 2 * i:2 * i + W] + rng.normal(0, 3, (H, W))
        u = y[::2, ::2] * 0.4 + 70
        v = 200 - y[1::2, 1::2] * 0.5
        out.append(tuple(np.clip(pl + d, 0, 255).astype(np.uint8)
                         for pl, d in ((y, step * i), (u, 2 * i),
                                       (v, -2 * i))))
    return out


# ---------------------------------------------------------------------------
# (a) the estimators
# ---------------------------------------------------------------------------

def _wp_case(name):
    """(org planes, list-0 reference planes) of one estimator case."""
    rng = np.random.default_rng(5)

    def planes(base, jitter):
        y = np.clip(base + rng.integers(-jitter, jitter + 1, (32, 48)),
                    0, 255)
        return (y, np.clip(y[::2, ::2] + 9, 0, 255),
                np.clip(y[1::2, 1::2] - 7, 0, 255))

    if name == "random":
        return planes(120, 60), [planes(100, 50), planes(140, 70)]
    if name == "half_boundary":
        # DC ratio 96 * 32 / 64 = 48 exactly, 97 * 32 / 64 = 48.5 (rounds
        # half to even: 48), 99 * 32 / 64 = 49.5 (-> 50)
        org = (np.full((32, 48), 96), np.full((16, 24), 97),
               np.full((16, 24), 99))
        ref = tuple(np.full(pl.shape, 64) for pl in org)
        return org, [ref]
    # "flat_ref": a flat reference (den < 1e-6 in the LMS fit) and a
    # near-black one (DC <= 0.1 in the DC-ratio fit)
    org = planes(128, 40)
    return org, [tuple(np.full(pl.shape, 77) for pl in org),
                 tuple(np.zeros(pl.shape, np.int64) for pl in org)]


@pytest.mark.parametrize("name", ["random", "half_boundary", "flat_ref"])
def test_wp_estimators_match_jax(name):
    org, refs = _wp_case(name)
    means = [tuple(float(np.asarray(pl).mean()) for pl in r) for r in refs]
    assert WP.estimate_wp(org, means) == JC.estimate_wp(org, means)
    assert WP.estimate_wp_lms(org, refs) == JC.estimate_wp_lms(org, refs)
    if name == "half_boundary":
        l0 = WP.estimate_wp(org, means)["l0"][0]
        assert (l0[0], l0[2], l0[4]) == (48, 48, 50)


# ---------------------------------------------------------------------------
# (b) the luma plane weighting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wy,oy", [(32, 0), (40, 17), (-9, 60), (127, -128),
                                   (-128, 127)])
def test_weight_luma_matches_jax(wy, oy):
    rng = np.random.default_rng(wy & 0xFF)
    up = rng.integers(0, 256, (4, 4, 24, 40)).astype(np.uint8)
    up[0, 0, 0, :2] = (0, 255)
    got = DE.weight_luma(torch.as_tensor(up), wy, oy)
    want = np.asarray(_weight_luma(jnp.asarray(up), jnp.int32(wy),
                                   jnp.int32(oy)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    if (wy, oy) == (127, -128):          # both clip ends
        assert (want == 0).any() and (want == 255).any()


# ---------------------------------------------------------------------------
# (c) TPUAVCCodec parity on an additive fade
# ---------------------------------------------------------------------------
#
# High profile with the 8x8 transform and sub-8x8 partitions, so that WP
# runs through every chroma MC site of the P step and through the numpy
# packer's pred_weight_table (sub-8x8 P slices); (d) reuses this JAX
# compile.  The native packer's pred_weight_table is held to the numpy and
# JAX packers in test_torch_avc_native.py.

H, W, QP, SR, SLICES, REFS = 64, 64, 28, 8, 2, 2
HIGH = dict(profile_idc=100, transform_8x8=True)


@pytest.fixture(scope="module")
def fade():
    return fade_frames(4, H, W)


@pytest.fixture(scope="module", params=["dc", "lms"])
def encoded(request, fade):
    method = request.param
    jp = JParams(width=W, height=H, qp=QP, num_ref_frames=REFS,
                 weighted_pred=True, **HIGH)
    j_res, j_stream = TPUAVCCodec(jp, search_range=SR, n_slices=SLICES,
                                  sub8x8=True, wp_method=method
                                  ).encode_sequence(fade)
    tp = params_from_dict(dataclasses.asdict(jp))
    t_res, t_stream = DeviceAVCCodec(tp, search_range=SR, n_slices=SLICES,
                                     sub8x8=True, wp_method=method,
                                     device="cpu").encode_sequence(fade)
    return dict(method=method, j_res=j_res, j_stream=j_stream, t_res=t_res,
                t_stream=t_stream)


def test_wp_stream_byte_identical(encoded):
    assert [r.frame_type for r in encoded["t_res"]] == ["IDR", "P", "P", "P"]
    assert encoded["t_stream"] == encoded["j_stream"]


def test_wp_recon_and_bits_match_per_frame(encoded):
    for j, t in zip(encoded["j_res"], encoded["t_res"]):
        assert (t.frame_type, t.bits, t.psnr_y) == (j.frame_type, j.bits,
                                                    j.psnr_y)
        for a, b in zip(t.recon, j.recon):
            np.testing.assert_array_equal(a, b)


def test_wp_both_decoders_reproduce_recon(encoded, monkeypatch):
    seen = []
    init = SD._SliceDecoder.__init__

    def record(self, *a, **kw):
        seen.append(kw.get("wp"))
        init(self, *a, **kw)

    monkeypatch.setattr(SD._SliceDecoder, "__init__", record)
    dec = AVCDecoder().decode(encoded["t_stream"])
    jdec, _ = AVCCodec.decode_sequence(encoded["t_stream"])
    assert len(dec) == len(jdec) == 4
    for planes, jplanes, r in zip(dec, jdec, encoded["t_res"]):
        for a, b, c in zip(planes, jplanes, r.recon):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, c)
    # the P slice headers carry weights that are not the default (32, 0),
    # so the stream cannot match without WP
    tables = [e for wp in seen if wp for e in wp["l0"]]
    assert len(tables) == SLICES * (1 + REFS + REFS)   # frame 1 has one ref
    assert any(e[:2] != (32, 0) for e in tables)
    if encoded["method"] == "lms":
        assert any(e[1] != 0 for e in tables)        # a fitted luma offset


# ---------------------------------------------------------------------------
# (d) one High-profile P frame with chroma weights, from JAX state
# ---------------------------------------------------------------------------

def test_high_p_frame_with_wp_from_jax_reference_state(fade):
    """Frame 1 of the fade with the 8x8 transform and sub-8x8 partitions,
    both packages started from the JAX package's reference state of frame
    0 with different luma and chroma weights on the two references (the
    static configuration and shapes of (c)'s P frames)."""
    l0 = [(36, -5, 30, 3, 34, -2), (29, 8, 33, -4, 31, 5)]
    ref_j = TE.prep_ref(*(jnp.asarray(pl, jnp.int32) for pl in fade[0]), SR)
    ups = jnp.stack([_weight_luma(ref_j[0], jnp.int32(e[0]), jnp.int32(e[1]))
                     for e in l0])
    us, vs = (jnp.stack([x] * REFS) for x in ref_j[1:])
    wp_c = np.array([e[2:6] for e in l0], np.int32)
    force = np.zeros((H // 16, W // 16), bool)
    kw = dict(mb_h=H // 16, mb_w=W // 16, sr=SR, intra_only=False,
              n_slices=SLICES, chroma_qp_offset=0, transform8=True,
              sub8x8=True, scaling_default=False)
    sym_j, rec_j, ctx_j = TE.encode_frame(
        *(jnp.asarray(pl, jnp.int32) for pl in fade[1]), ups, us, vs,
        jnp.int32(QP), jnp.int32(REFS), jnp.asarray(force),
        jnp.asarray(wp_c), **kw)
    sym_t, rec_t, ctx_t = DE.encode_frame(
        *(torch.as_tensor(np.asarray(pl, np.int32)) for pl in fade[1]),
        *(torch.as_tensor(np.asarray(x)) for x in (ups, us, vs)), QP, REFS,
        torch.as_tensor(force), torch.as_tensor(wp_c), **kw)
    for k, a in sym_t.items():
        np.testing.assert_array_equal(a.numpy().astype(np.int64),
                                      np.asarray(sym_j[k]).astype(np.int64), k)
    for a, b in zip(rec_t, rec_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for k in ("nnz", "mv", "ref", "mb_intra", "t8"):
        np.testing.assert_array_equal(ctx_t[k].numpy().astype(np.int64),
                                      np.asarray(ctx_j[k]).astype(np.int64))
    win = sym_t["win"].numpy()
    ri = sym_t["ri"].numpy()
    assert ((win >= 1) & (win <= 4) & (ri == 1)).any()   # second ref's weights
    assert (win == 7).any()                    # the sub-8x8 candidate won
