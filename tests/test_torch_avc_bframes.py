"""The PyTorch port's B-frame encoder against the JAX package, on the CPU: an
IbbP CAVLC sequence (``bframes=2``) byte for byte against ``TPUAVCCodec``,
both decoders on the port's stream, the spatial direct derivation against
the jitted ``tpu_enc._direct_spatial_mb``, and one B frame's symbols started
from the JAX package's reference state."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from h264tpu.avc import tpu_enc as TE
from h264tpu.avc.codec import AVCCodec
from h264tpu.avc.params import AVCParams as JParams
from h264tpu.avc.tpu_codec import TPUAVCCodec, _split_org
from h264tpu_torch.avc import device_enc as DE
from h264tpu_torch.avc.device_codec import DeviceAVCCodec
from h264tpu_torch.avc.params import params_from_dict
from h264tpu_torch.avc.slice_dec import AVCDecoder

from test_torch_avc_codec import smooth_frames

# IbbP: the B pictures need both anchors in the decoder's DPB
H, W, QP, SR, S, N = 48, 64, 28, 8, 1, 4
JP = JParams(width=W, height=H, qp=QP, profile_idc=77, poc_type=0,
             num_ref_frames=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def encoded():
    frames = smooth_frames(N, H, W)
    j_res, j_stream = TPUAVCCodec(JP, search_range=SR, n_slices=S,
                                  bframes=2).encode_sequence(frames)
    tp = params_from_dict(dataclasses.asdict(JP))
    t_res, t_stream = DeviceAVCCodec(tp, search_range=SR, n_slices=S,
                                     bframes=2, device="cpu").encode_sequence(
                                         frames)
    return dict(frames=frames, j_res=j_res, j_stream=j_stream, t_res=t_res,
                t_stream=t_stream)


def test_stream_byte_identical(encoded):
    assert [r.frame_type for r in encoded["t_res"]] == ["IDR", "B", "B", "P"]
    assert encoded["t_stream"] == encoded["j_stream"]


def test_recon_and_bits_match_per_frame(encoded):
    for j, t in zip(encoded["j_res"], encoded["t_res"]):
        assert (t.frame_type, t.bits, t.psnr_y) == (j.frame_type, j.bits,
                                                    j.psnr_y)
        for a, b in zip(t.recon, j.recon):
            np.testing.assert_array_equal(a, b)


def test_port_decoder_reproduces_recon(encoded):
    dec = AVCDecoder().decode(encoded["t_stream"])
    assert len(dec) == N
    for planes, r in zip(dec, encoded["t_res"]):
        for a, b in zip(planes, r.recon):
            np.testing.assert_array_equal(a, b)


def test_jax_decoder_reproduces_recon(encoded):
    dec, _ = AVCCodec.decode_sequence(encoded["t_stream"])
    assert len(dec) == N
    for planes, r in zip(dec, encoded["t_res"]):
        for a, b in zip(planes, r.recon):
            np.testing.assert_array_equal(a, b)


def test_direct_spatial_mb_matches_jax():
    """Random list fields with intra (-1) and not-coded (-2) cells, and
    colocated motion of |mv| 0..2, against the jitted JAX derivation."""
    rng = np.random.default_rng(7)
    mb_h, mb_w = 3, 4
    h4, w4 = mb_h * 4, mb_w * 4
    f = {}
    for k in ("0", "1"):
        f["mv" + k] = rng.integers(-9, 10, (h4, w4, 2)).astype(np.int32)
        f["ref" + k] = rng.choice([-2, -1, 0, 0, 1], (h4, w4)).astype(np.int32)
    col_mv = rng.integers(-2, 3, (h4, w4, 2)).astype(np.int32)
    col_ref = rng.choice([-1, 0, 0, 1], (h4, w4)).astype(np.int32)
    jfn = jax.jit(TE._direct_spatial_mb, static_argnames=("h4", "w4"))
    mby, mbx = (torch.as_tensor(a.reshape(-1)) for a in
                np.indices((mb_h, mb_w)))
    lc = dict(band=torch.zeros(mb_h * mb_w, dtype=torch.int64), mby=mby,
              mbx=mbx, by0=4 * mby, bx0=4 * mbx)

    def field(k):
        return dict(mv=torch.as_tensor(f["mv" + k])[None],
                    ref=torch.as_tensor(f["ref" + k])[None])

    got = DE._direct_spatial_mb(field("0"), field("1"), lc,
                                torch.as_tensor(col_mv)[None],
                                torch.as_tensor(col_ref)[None])
    seen = set()
    for i in range(mb_h * mb_w):
        want = jfn(*(jnp.asarray(f[k]) for k in ("mv0", "ref0", "mv1",
                                                 "ref1")),
                   jnp.int32(4 * int(mby[i])), jnp.int32(4 * int(mbx[i])),
                   jnp.asarray(col_mv), jnp.asarray(col_ref), h4=h4, w4=w4)
        for name, g, w in zip(("r0", "r1", "used0", "used1", "qmv0", "qmv1"),
                              got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w),
                                          f"{name} at MB {i}")
        seen.add((bool(want[2]), bool(want[3])))
        seen.add(("zeroed", bool((np.asarray(want[4]) == 0).all(-1).any())))
    # both one-list and two-list MBs, and zeroed quadrants, occurred
    assert {(True, True), ("zeroed", True)} <= seen
    assert (True, False) in seen or (False, True) in seen


def test_b_frame_symbols_from_jax_reference_state(encoded):
    """B frame 1 encoded by both packages from the JAX package's reference
    state: prep_ref of the decoded IDR and P anchor, and the anchor's
    motion from the JAX P-frame graph, carried across as numpy."""
    frames, j_res = encoded["frames"], encoded["j_res"]
    mb_h, mb_w = JP.mb_h, JP.mb_w

    def planes(i):
        return _split_org(jnp.asarray(np.concatenate(
            [frames[i][0], np.concatenate(frames[i][1:], axis=1)])), H=H, W=W)

    prep = [TE.prep_ref(*(jnp.asarray(pl, jnp.int32) for pl in
                          j_res[i].recon), SR) for i in (0, 3)]
    kw = dict(mb_h=mb_h, mb_w=mb_w, sr=SR, n_slices=S, chroma_qp_offset=0)
    _, _, ctx_p = TE.encode_frame(
        *planes(3), *(x[None] for x in prep[0]), jnp.int32(QP), jnp.int32(1),
        jnp.zeros((mb_h, mb_w), bool), intra_only=False, transform8=False,
        sub8x8=False, scaling_default=False, **kw)
    col = (np.asarray(ctx_p["mv"], np.int32), np.asarray(ctx_p["ref"],
                                                         np.int32))
    sym_j, rec_j, ctx_j = TE.encode_frame_b(
        *planes(1), *(x[None] for x in prep[0]), *(x[None] for x in prep[1]),
        jnp.asarray(col[0]), jnp.asarray(col[1]), jnp.int32(QP), jnp.int32(1),
        jnp.int32(1), **kw)
    refs = [DE.dpb_from_numpy(*(np.asarray(x) for x in pr), "cpu")
            for pr in prep]
    sym_t, rec_t, ctx_t = DE.encode_frame_b(
        *(torch.as_tensor(np.asarray(pl, np.int32)) for pl in frames[1]),
        *(x[None] for x in refs[0]), *(x[None] for x in refs[1]),
        torch.as_tensor(col[0]), torch.as_tensor(col[1]), QP, 1, 1, **kw)
    assert set(sym_t) == set(sym_j)
    for k, a in sym_t.items():
        np.testing.assert_array_equal(a.numpy().astype(np.int64),
                                      np.asarray(sym_j[k]).astype(np.int64), k)
    for a, b in zip(rec_t, rec_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for k in ("nnz", "mv0", "ref0", "mv1", "ref1", "mb_intra"):
        np.testing.assert_array_equal(ctx_t[k].numpy().astype(np.int64),
                                      np.asarray(ctx_j[k]).astype(np.int64), k)
    win = sym_t["win"].numpy()
    assert ((win == 2) | (win == 3) | (win == 4)).any()
