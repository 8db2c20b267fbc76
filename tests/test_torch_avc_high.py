"""The PyTorch port's High-profile P path against the JAX package, on the CPU:
the 8x8 transform and quantizer, the weighted (scaling-list) 4x4 tables,
the 8x8 luma coder, Stages A and B over the 41 sub-partition slots, and one
``TPUAVCCodec`` run at a configuration that combines every option of the
slice (High, 8x8 transform, P_8x8 sub-partitions, default scaling lists, 2
slices, 2 references) held byte for byte against ``DeviceAVCCodec``.  JAX
functions run under ``jax.jit``, as the package runs them; everything is
exact."""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from h264tpu.avc import quant_jax as QJ, quant8_jax as Q8J
from h264tpu.avc import qmatrix as JQM, tpu_enc as TE
from h264tpu.avc.codec import AVCCodec
from h264tpu.avc.params import AVCParams as JParams
from h264tpu.avc.tpu_codec import TPUAVCCodec, _split_org
from h264tpu_torch.avc import device_enc as DE, qmatrix as QM
from h264tpu_torch.avc import quant_dev as QD, quant8_dev as Q8D
from h264tpu_torch.avc.device_codec import DeviceAVCCodec
from h264tpu_torch.avc.params import params_from_dict
from h264tpu_torch.avc.slice_dec import AVCDecoder


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=np.int32):
    return torch.as_tensor(np.array(a, dtype))


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), msg)


def _tables(group):
    """(JAX, port) weighted tables of one default-matrix group, or Nones."""
    if group is None:
        return None, None
    j = JQM.enc_tables_default()[group]
    t = QM.enc_tables_default()[group]
    return j, {k: torch.as_tensor(v) for k, v in t.items()}


def _residuals(rng, n, size):
    """Random residuals plus the extremes: a 0/255 checkerboard, its
    negation, and flat +-255."""
    res = rng.integers(-255, 256, (n, size, size)).astype(np.int32)
    yy, xx = np.indices((size, size))
    cb = np.where((yy + xx) % 2 == 0, 255, 0).astype(np.int32)
    res[:4] = [cb, -cb, np.full_like(cb, 255), np.full_like(cb, -255)]
    return res


# ---------------------------------------------------------------------------
# quant8_dev against quant8_jax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qm", [None, "p8", "i8"], ids=["flat", "inter",
                                                        "intra"])
@pytest.mark.parametrize("qp", [0, 28, 51])
def test_quant8_dev_matches_quant8_jax(qp, qm):
    rng = np.random.default_rng(qp)
    res = _residuals(rng, 24, 8)
    off = rng.integers(0, 1025, (8, 8)).astype(np.int32)
    tj, tt = _tables(qm)
    w_j = jax.jit(Q8J.fdct8x8)(jnp.asarray(res))
    w_t = Q8D.fdct8x8(_t(res))
    _eq(w_t, w_j)
    for intra in (True, False):
        for o in (None, off):
            lev_j = jax.jit(functools.partial(Q8J.quant8x8, qp=qp, intra=intra))(
                w_j, offsets=None if o is None else jnp.asarray(o),
                mf=None if tj is None else tj["mf"])
            lev_t = Q8D.quant8x8(w_t, qp, intra,
                                 offsets=None if o is None else _t(o),
                                 mf=None if tt is None else tt["mf"])
            _eq(lev_t, lev_j, f"quant8x8 intra={intra}")
    deq_j = jax.jit(functools.partial(Q8J.dequant8x8, qp=qp))(
        lev_j, ils=None if tj is None else tj["ils"])
    deq_t = Q8D.dequant8x8(lev_t, qp, ils=None if tt is None else tt["ils"])
    _eq(deq_t, deq_j)
    pred = rng.integers(0, 256, res.shape).astype(np.int32)
    rec_j = jax.jit(lambda p, d: Q8J.reconstruct8(p, Q8J.idct8x8(d)))(
        jnp.asarray(pred), deq_j)
    _eq(Q8D.reconstruct8(_t(pred), Q8D.idct8x8(deq_t)), rec_j)
    _eq(Q8D.zigzag8(lev_t), jax.jit(Q8J.zigzag8)(lev_j))
    assert (np.asarray(lev_j) != 0).any()


# ---------------------------------------------------------------------------
# quant_dev's weighted tables against quant_jax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qp", [0, 28, 51])
def test_quant_dev_weighted_matches_quant_jax(qp):
    rng = np.random.default_rng(100 + qp)
    w = np.asarray(QJ.fdct4x4(jnp.asarray(_residuals(rng, 32, 4))))
    off = rng.integers(0, 1025, (4, 4)).astype(np.int32)
    qpc = int(QJ.chroma_qp(qp))
    for group, intra in (("i4", True), ("p4", False)):
        tj, tt = _tables(group)
        lev_j = jax.jit(lambda x, o, m: QJ.quant4x4(x, qp, intra, offsets=o,
                                                    mf=m))(
            jnp.asarray(w), jnp.asarray(off), tj["mf"])
        lev_t = QD.quant4x4(_t(w), qp, intra, offsets=_t(off), mf=tt["mf"])
        _eq(lev_t, lev_j, group)
        _eq(QD.ar_fadjust(_t(w), lev_t, qp, mf=tt["mf"]),
            jax.jit(lambda x, l, m: QJ.ar_fadjust(x, l, qp, mf=m))(
                jnp.asarray(w), lev_j, tj["mf"]))
        _eq(QD.dequant4x4(lev_t, qp, ils=tt["ils"]),
            jax.jit(lambda l, i: QJ.dequant4x4(l, qp, ils=i))(lev_j,
                                                              tj["ils"]))
        dc = w[:16, 0, 0].reshape(4, 4)
        had = np.asarray(QJ.hadamard4x4_fwd(jnp.asarray(dc)))
        dcl_j = jax.jit(lambda h, m: QJ.quant_dc16(h, qp, mf4=m))(
            jnp.asarray(had), tj["mf"])
        dcl_t = QD.quant_dc16(_t(had), qp, mf4=tt["mf"])
        _eq(dcl_t, dcl_j)
        _eq(QD.dequant_dc16(dcl_t, qp, ils=tt["ils"]),
            jax.jit(lambda l, i: QJ.dequant_dc16(l, qp, ils=i))(dcl_j,
                                                                tj["ils"]))
        h2 = np.asarray(QJ.hadamard2x2_fwd(jnp.asarray(
            w[:8, 0, 0].reshape(2, 2, 2))))
        cl_j = jax.jit(lambda h, m: QJ.quant_dc_chroma(h, qpc, intra,
                                                       mf4=m))(
            jnp.asarray(h2), tj["mf"])
        cl_t = QD.quant_dc_chroma(_t(h2), qpc, intra, mf4=tt["mf"])
        _eq(cl_t, cl_j)
        _eq(QD.dequant_dc_chroma(cl_t, qpc, ils=tt["ils"]),
            jax.jit(lambda l, i: QJ.dequant_dc_chroma(l, qpc, ils=i))(
                cl_j, tj["ils"]))


# ---------------------------------------------------------------------------
# the 8x8 luma coder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qm", [None, "p8"], ids=["flat", "default"])
@pytest.mark.parametrize("qp", [0, 28, 51])
def test_code_inter_luma8_matches(qp, qm):
    rng = np.random.default_rng(7 + qp)
    org = rng.integers(0, 256, (12, 16, 16)).astype(np.int32)
    pred = np.clip(org + rng.integers(-40, 41, org.shape), 0, 255).astype(
        np.int32)
    yy, xx = np.indices((16, 16))
    org[0] = np.where((yy + xx) % 2 == 0, 255, 0)
    pred[0] = 255 - org[0]
    pred[1] = org[1]                                 # zero residual
    qm_j = None if qm is None else JQM.enc_tables_default()
    qm_t = None if qm is None else {
        k: {m: torch.as_tensor(v) for m, v in g.items()}
        for k, g in QM.enc_tables_default().items()}
    f = jax.jit(jax.vmap(lambda o, p: TE._code_inter_luma8(o, p, qp,
                                                           qm=qm_j)))
    outs_j = f(jnp.asarray(org), jnp.asarray(pred))
    outs_t = DE._code_inter_luma8(_t(org), _t(pred), qp, qm_t)
    for name, a, b in zip(("zz", "rec", "cbp", "nnz"), outs_t, outs_j):
        _eq(a, b, name)
    np.testing.assert_array_equal(outs_t[1][1].numpy(), org[1])


# ---------------------------------------------------------------------------
# Stages A and B over the 41 slots
# ---------------------------------------------------------------------------

def test_search_stages_match_with_sub8x8():
    H = W = 64
    sr, qp, R = 4, 28, 2
    rng = np.random.default_rng(11)
    big = rng.normal(0, 1, (H + 12, W + 12))
    for _ in range(3):
        big = (big + np.roll(big, 1, 0) + np.roll(big, -1, 1)) / 3
    big = 128 + big / big.std() * 50
    ys = [np.clip(big[2 * i:2 * i + H, i:i + W] + rng.normal(0, 3, (H, W)),
                  0, 255).astype(np.int32) for i in range(R + 1)]
    prep_j = jax.jit(TE.prep_ref, static_argnums=3)
    ups_j = jnp.stack([prep_j(jnp.asarray(y), jnp.asarray(y[::2, ::2]),
                              jnp.asarray(y[::2, ::2]), sr)[0]
                       for y in ys[1:]])
    lam_me = jax.jit(TE.lambdas)(jnp.int32(qp))[1]
    mv_j, sad_j, pmv_j = jax.jit(
        TE._integer_search, static_argnums=2, static_argnames="sub8x8")(
        jnp.asarray(ys[0]), ups_j[:, 0, 0].astype(jnp.int32), sr, lam_me,
        sub8x8=True)
    ups_t = torch.as_tensor(np.array(ups_j))
    lme = DE.lambdas(qp)[1]
    mv_t, sad_t, pmv_t = DE._integer_search(
        _t(ys[0]), ups_t[:, 0, 0].to(torch.int32), sr, lme, sub8x8=True)
    assert mv_t.shape == (R, 41, 16, 2)
    for a, b in ((mv_t, mv_j), (sad_t, sad_j), (pmv_t, pmv_j)):
        _eq(a, b)
    mq_j, dq_j = jax.jit(functools.partial(TE._subpel_refine, sr=sr,
                                           sub8x8=True))(
        jnp.asarray(ys[0]), ups_j, mv_j, sad_j, pmv_j, lam_me=lam_me)
    mq_t, dq_t = DE._subpel_refine(_t(ys[0]), ups_t, mv_t, pmv_t, sr, lme,
                                   sub8x8=True)
    _eq(mq_t, mq_j)
    _eq(dq_t, dq_j)
    assert (np.asarray(mq_j)[:, 9:] % 4 != 0).any()    # sub-pel sub slots


# ---------------------------------------------------------------------------
# the combined High configuration, end to end
# ---------------------------------------------------------------------------

def smooth_frames(n, H, W, seed=0):
    """Smooth random texture moving (2, 3) pels a frame, with noise."""
    rng = np.random.default_rng(seed)
    big = rng.normal(0, 1, (H + 3 * n, W + 3 * n))
    for _ in range(3):
        big = (big + np.roll(big, 1, 0) + np.roll(big, -1, 0)
               + np.roll(big, 1, 1) + np.roll(big, -1, 1)) / 5
    big = 128 + big / big.std() * 50
    out = []
    for i in range(n):
        y = np.clip(big[3 * i:3 * i + H, 2 * i:2 * i + W]
                    + rng.normal(0, 6, (H, W)), 0, 255).astype(np.uint8)
        u = np.clip(y[::2, ::2] * 0.5 + 60 + rng.normal(0, 3, (H // 2, W // 2)),
                    0, 255).astype(np.uint8)
        v = np.clip(255 - y[1::2, 1::2] * 0.6
                    + rng.normal(0, 3, (H // 2, W // 2)), 0, 255).astype(np.uint8)
        out.append((y, u, v))
    return out


H = W = 64
QP, SR, SLICES, REFS = 28, 4, 2, 2


@pytest.fixture(scope="module")
def encoded():
    frames = smooth_frames(3, H, W)
    jp = JParams(width=W, height=H, qp=QP, num_ref_frames=REFS,
                 profile_idc=100, transform_8x8=True,
                 scaling_matrix="default")
    j_res, j_stream = TPUAVCCodec(jp, intra_period=0, search_range=SR,
                                  n_slices=SLICES,
                                  sub8x8=True).encode_sequence(frames)
    tp = params_from_dict(dataclasses.asdict(jp))
    t_res, t_stream = DeviceAVCCodec(tp, intra_period=0, search_range=SR,
                                     n_slices=SLICES, sub8x8=True,
                                     device="cpu").encode_sequence(frames)
    return dict(frames=frames, jp=jp, tp=tp, j_res=j_res, j_stream=j_stream,
                t_res=t_res, t_stream=t_stream)


def test_high_params_round_trip(encoded):
    tp = encoded["tp"]
    assert (tp.profile_idc, tp.transform_8x8, tp.scaling_matrix) == \
        (100, True, "default")
    assert dataclasses.asdict(tp) == dataclasses.asdict(encoded["jp"])


def test_stream_byte_identical(encoded):
    assert [r.frame_type for r in encoded["t_res"]] == ["IDR", "P", "P"]
    assert encoded["t_stream"] == encoded["j_stream"]


def test_recon_and_bits_match_per_frame(encoded):
    for j, t in zip(encoded["j_res"], encoded["t_res"]):
        assert (t.frame_type, t.bits, t.psnr_y) == (j.frame_type, j.bits,
                                                    j.psnr_y)
        for a, b in zip(t.recon, j.recon):
            np.testing.assert_array_equal(a, b)


def test_port_decoder_reproduces_recon(encoded):
    dec = AVCDecoder().decode(encoded["t_stream"])
    assert len(dec) == 3
    for planes, r in zip(dec, encoded["t_res"]):
        for a, b in zip(planes, r.recon):
            np.testing.assert_array_equal(a, b)


def test_jax_decoder_reproduces_recon(encoded):
    dec, _ = AVCCodec.decode_sequence(encoded["t_stream"])
    for planes, r in zip(dec, encoded["t_res"]):
        for a, b in zip(planes, r.recon):
            np.testing.assert_array_equal(a, b)


def test_p_frame_symbols_from_jax_reference_state(encoded):
    """Frame 1 encoded by both packages from the JAX package's reference
    state (its prep_ref of the decoded IDR), carried across as numpy; the
    JAX call matches ``TPUAVCCodec``'s, so its compiled graph is reused.
    The frame must choose the 8x8 transform and a sub-partitioned P_8x8
    somewhere."""
    jp = encoded["jp"]
    ref_j = TE.prep_ref(*(jnp.asarray(pl, jnp.int32)
                          for pl in encoded["j_res"][0].recon), SR)
    ups, us, vs = (jnp.stack([x] * REFS) for x in ref_j)
    y, u, v = _split_org(jnp.asarray(np.concatenate(
        [encoded["frames"][1][0],
         np.concatenate(encoded["frames"][1][1:], axis=1)])), H=H, W=W)
    kw = dict(mb_h=jp.mb_h, mb_w=jp.mb_w, sr=SR, intra_only=False,
              n_slices=SLICES, chroma_qp_offset=0, transform8=True,
              sub8x8=True, scaling_default=True)
    sym_j, rec_j, ctx_j = functools.partial(TE.encode_frame, **kw)(
        y, u, v, ups, us, vs, jnp.int32(QP), jnp.int32(1),
        jnp.zeros((jp.mb_h, jp.mb_w), bool), None)
    kw.pop("intra_only")
    ref_t = DE.dpb_from_numpy(*(np.asarray(x) for x in ref_j), "cpu")
    sym_t, rec_t, ctx_t = DE.encode_frame(
        *(torch.as_tensor(np.asarray(pl, np.int32))
          for pl in encoded["frames"][1]),
        *(torch.stack([x] * REFS) for x in ref_t), QP, 1,
        torch.zeros((jp.mb_h, jp.mb_w), dtype=torch.bool), intra_only=False,
        **kw)
    assert {"t8", "sub", "mvd_s"} <= set(sym_t) <= set(sym_j)
    for k, a in sym_t.items():
        np.testing.assert_array_equal(a.numpy().astype(np.int64),
                                      np.asarray(sym_j[k]).astype(np.int64), k)
    for a, b in zip(rec_t, rec_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for k in ("nnz", "mv", "ref", "mb_intra", "t8"):
        np.testing.assert_array_equal(ctx_t[k].numpy().astype(np.int64),
                                      np.asarray(ctx_j[k]).astype(np.int64))
    assert sym_t["t8"].numpy().any()
    sub_mb = sym_t["win"].numpy() == 7
    assert (sym_t["sub"].numpy()[sub_mb] > 0).any()
