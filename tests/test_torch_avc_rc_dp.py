"""Rate control and data partitioning in the PyTorch port's conformant
encoder against the JAX package, on the CPU: the quadratic controller's
copy call for call, a frame encoded with one QP per slice, sequence parity
under ``rc_mode`` 1 and 3 (one QP per row-band slice), data-partitioned
streams, the partitioning packer, and a B sequence that never consults the
controller.  Streams are byte-identical and both decoders reproduce the
encoder's reconstruction."""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from h264tpu.avc import pack as JPK, tpu_enc as TE
from h264tpu.avc.codec import AVCCodec
from h264tpu.avc.params import AVCParams as JParams
from h264tpu.avc.tpu_codec import TPUAVCCodec, _split_org
from h264tpu.bitstream.nal import annexb_parse
from h264tpu.models import ratectl as JRC
from h264tpu_torch.avc import device_enc as DE, pack as PK
from h264tpu_torch.avc.device_codec import DeviceAVCCodec, host_symbols
from h264tpu_torch.avc.params import AVCParams, params_from_dict
from h264tpu_torch.avc.slice_dec import AVCDecoder
from h264tpu_torch.models import ratectl as RC


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a) the controller's copy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rc_mode", [0, 1, 2, 3])
def test_ratectl_copy_matches_jax(rc_mode):
    """The same scripted series of calls on both controllers: every QP and
    every piece of state equal."""
    rng = np.random.default_rng(rc_mode)
    ctl = [m.QuadraticRateControl(250_000.0, 25.0, 30, window=6,
                                  rc_mode=rc_mode, basic_units=3)
           for m in (RC, JRC)]
    for i in range(24):
        ftype = "I" if i % 8 == 0 else ("B" if i % 3 == 2 else "P")
        got = [c.frame_qp(ftype) for c in ctl]
        assert got[0] == got[1]
        if rc_mode == 3:
            bq = [c.basic_unit_qps(3, ftype) for c in ctl]
            np.testing.assert_array_equal(bq[0], bq[1])
        bits = int(rng.integers(2_000, 40_000))
        mad = float(rng.uniform(0.5, 12.0))
        for c in ctl:
            c.update(bits, got[0], mad, ftype=ftype)
        if rc_mode == 3 and i % 2:
            mads = rng.uniform(0.2, 9.0, 3).tolist()
            for c in ctl:
                c.update_basic_units(mads)
        assert vars(ctl[0]) == vars(ctl[1])
    assert RC.qstep2qp(RC.qp2qstep(37)) == JRC.qstep2qp(JRC.qp2qstep(37)) == 37


# ---------------------------------------------------------------------------
# frames and configurations of (b)-(d)
# ---------------------------------------------------------------------------

H, W, SLICES, SR = 48, 64, 3, 4


def banded_frames(n, seed=3):
    """A textured picture moving (1, 2) pels a frame whose top MB row is
    flat: the row-band slices differ in activity, as basic-unit rate
    control needs (``tests/test_tpu_avc.py``'s flattened top third)."""
    rng = np.random.default_rng(seed)
    big = rng.normal(0, 1, (H + 2 * n, W + 2 * n))
    for _ in range(2):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)) / 3
    big = 128 + big / big.std() * 55
    out = []
    for i in range(n):
        y = big[i:i + H, 2 * i:2 * i + W] + rng.normal(0, 5, (H, W))
        y[:16] = 120 + i
        y = np.clip(y, 0, 255).astype(np.uint8)
        u = np.clip(y[::2, ::2] * 0.4 + 70, 0, 255).astype(np.uint8)
        v = np.clip(200 - y[1::2, 1::2] * 0.3, 0, 255).astype(np.uint8)
        out.append((y, u, v))
    return out


@pytest.fixture(scope="module")
def frames():
    return banded_frames(6)


def _params(**kw):
    jp = JParams(width=W, height=H, qp=30, **kw)
    return jp, params_from_dict(dataclasses.asdict(jp))


def _decoded_equal(stream, results):
    """Both packages' decoders reproduce the encoder's reconstruction."""
    dec = AVCDecoder().decode(stream)
    jdec, _ = AVCCodec.decode_sequence(stream)
    assert len(dec) == len(jdec) == len(results)
    for planes, jplanes, r in zip(dec, jdec, results):
        for a, b, c in zip(planes, jplanes, r.recon):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, c)


def _slice_qps(stream):
    """The slice QPs of each picture, read back from the slice headers."""
    dec = AVCDecoder(trace=True)
    dec.decode(stream)
    init = next(iter(dec.pps.values()))["pic_init_qp"]
    pics = []
    for _, name, val in dec.trace:
        if name == "first_mb_in_slice" and val == 0:
            pics.append([])
        elif name == "slice_qp_delta":
            pics[-1].append(init + val)
    return pics


# ---------------------------------------------------------------------------
# (b) one frame with a QP per slice
# ---------------------------------------------------------------------------

def test_encode_frame_with_per_slice_qps_matches_jax(frames):
    """P frame 1 against the JAX package's reference state of frame 0 with
    the QPs (12, 30, 45) on its three slices, as ``TPUAVCCodec`` passes a
    basic-unit QP vector."""
    qps = [12, 30, 45]
    jp, tp = _params()
    ref_j = TE.prep_ref(*(jnp.asarray(pl, jnp.int32) for pl in frames[0]), SR)
    y, u, v = _split_org(jnp.asarray(np.concatenate(
        [frames[1][0], np.concatenate(frames[1][1:], axis=1)])), H=H, W=W)
    kw = dict(mb_h=jp.mb_h, mb_w=jp.mb_w, sr=SR, intra_only=False,
              n_slices=SLICES, chroma_qp_offset=0, transform8=False,
              sub8x8=False, scaling_default=False)
    sym_j, rec_j, ctx_j = TE.encode_frame(
        y, u, v, *(x[None] for x in ref_j), jnp.asarray(qps, jnp.int32),
        jnp.int32(1), jnp.zeros((jp.mb_h, jp.mb_w), bool), None, **kw)
    ref_t = DE.dpb_from_numpy(*(np.asarray(x) for x in ref_j), "cpu")
    sym_t, rec_t, ctx_t = DE.encode_frame(
        *(torch.as_tensor(np.asarray(pl, np.int32)) for pl in frames[1]),
        *(x[None] for x in ref_t), qps, 1,
        torch.zeros((tp.mb_h, tp.mb_w), dtype=torch.bool), **kw)
    for k, a in sym_t.items():
        np.testing.assert_array_equal(a.numpy().astype(np.int64),
                                      np.asarray(sym_j[k]).astype(np.int64), k)
    for a, b in zip(rec_t, rec_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for k in ("nnz", "mv", "ref", "mb_intra"):
        np.testing.assert_array_equal(ctx_t[k].numpy().astype(np.int64),
                                      np.asarray(ctx_j[k]).astype(np.int64))
    # the slices really were coded at different QPs: the finest keeps the
    # most coefficients
    nz = (sym_t["zz"].reshape(SLICES, -1) != 0).sum(1)
    assert nz[0] > nz[2]


# ---------------------------------------------------------------------------
# (c) sequence parity under rate control
# ---------------------------------------------------------------------------

def _controller(module, rc_mode):
    return module.QuadraticRateControl(90_000.0, 30.0, 30, rc_mode=rc_mode)


@pytest.fixture(scope="module", params=[1, 3], ids=["rc_mode1", "rc_mode3"])
def rc_encoded(request, frames):
    rc_mode = request.param
    jp, tp = _params()
    j_rc, t_rc = _controller(JRC, rc_mode), _controller(RC, rc_mode)
    j_res, j_stream = TPUAVCCodec(jp, search_range=SR, n_slices=SLICES
                                  ).encode_sequence(frames, rate_control=j_rc)
    t_res, t_stream = DeviceAVCCodec(tp, search_range=SR, n_slices=SLICES,
                                     device="cpu").encode_sequence(
                                         frames, rate_control=t_rc)
    return dict(rc_mode=rc_mode, j_rc=j_rc, t_rc=t_rc, j_res=j_res,
                j_stream=j_stream, t_res=t_res, t_stream=t_stream)


def test_rc_stream_byte_identical(rc_encoded):
    assert [r.frame_type for r in rc_encoded["t_res"]] == ["IDR"] + ["P"] * 5
    assert rc_encoded["t_stream"] == rc_encoded["j_stream"]


def test_rc_recon_bits_and_controller_match(rc_encoded):
    for j, t in zip(rc_encoded["j_res"], rc_encoded["t_res"]):
        assert (t.frame_type, t.bits, t.psnr_y) == (j.frame_type, j.bits,
                                                    j.psnr_y)
        for a, b in zip(t.recon, j.recon):
            np.testing.assert_array_equal(a, b)
    t_rc, j_rc = rc_encoded["t_rc"], rc_encoded["j_rc"]
    assert (t_rc.prev_qp, t_rc.bu_mads, t_rc.p_qps) == \
        (j_rc.prev_qp, j_rc.bu_mads, j_rc.p_qps)
    assert vars(t_rc) == vars(j_rc)


def test_rc_both_decoders_reproduce_recon(rc_encoded):
    _decoded_equal(rc_encoded["t_stream"], rc_encoded["t_res"])


def test_rc_slice_qps(rc_encoded):
    """The controller moved the QP, and in rc_mode 3 at least one P frame
    carries more than one slice QP."""
    pics = _slice_qps(rc_encoded["t_stream"])
    assert len(pics) == 6 and all(len(q) == SLICES for q in pics)
    assert len({q[0] for q in pics}) > 1
    split = [len(set(q)) > 1 for q in pics]
    assert any(split) == (rc_encoded["rc_mode"] == 3)


# ---------------------------------------------------------------------------
# (d) data partitioning
# ---------------------------------------------------------------------------

def _force_row1_in_frame2(idx):
    if idx != 2:
        return None
    m = np.zeros((H // 16, W // 16), bool)
    m[1] = True
    return m


@pytest.fixture(scope="module")
def dp_encoded(frames):
    jp, tp = _params(profile_idc=88)
    j_res, j_stream = TPUAVCCodec(
        jp, search_range=SR, n_slices=SLICES, data_partitioning=True
    ).encode_sequence(frames[:4], force_intra=_force_row1_in_frame2)
    t_res, t_stream = DeviceAVCCodec(
        tp, search_range=SR, n_slices=SLICES, data_partitioning=True,
        device="cpu").encode_sequence(frames[:4],
                                      force_intra=_force_row1_in_frame2)
    return dict(j_res=j_res, j_stream=j_stream, t_res=t_res,
                t_stream=t_stream)


def test_dp_stream_byte_identical_with_partitions(dp_encoded):
    assert dp_encoded["t_stream"] == dp_encoded["j_stream"]
    for j, t in zip(dp_encoded["j_res"], dp_encoded["t_res"]):
        assert (t.frame_type, t.bits) == (j.frame_type, j.bits)
    nals = list(annexb_parse(dp_encoded["t_stream"]))
    types = [n.nal_type for n in nals]
    assert types.count(2) == types.count(3) == types.count(4) == 3 * SLICES
    # the forced-intra row puts intra residual into a partition B
    assert max(len(n.rbsp) for n in nals if n.nal_type == 3) > 1


def test_dp_both_decoders_reproduce_recon(dp_encoded):
    _decoded_equal(dp_encoded["t_stream"], dp_encoded["t_res"])


# ---------------------------------------------------------------------------
# (e) the P-slice packer with partitions and WP tables
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def p_symbols(frames):
    """Symbols of a P frame with a forced-intra row, from the port."""
    tp = AVCParams(width=W, height=H, qp=30, profile_idc=88,
                   weighted_pred=True, num_ref_frames=2)
    codec = DeviceAVCCodec(tp, search_range=SR, n_slices=SLICES,
                           device="cpu")
    _, rec, _ = codec.encode_frame(frames[0], [], 30)
    force = torch.zeros((tp.mb_h, tp.mb_w), dtype=torch.bool)
    force[2] = True
    sym, _, _ = codec.encode_frame(frames[1], [DE.prep_ref(*rec, SR)], 30,
                                   force)
    return tp, host_symbols(sym)


@pytest.mark.parametrize("dp,wp", [(True, False), (False, True),
                                   (True, True)], ids=["dp", "wp", "dp_wp"])
def test_pack_p_slice_dp_wp_matches_jax(p_symbols, dp, wp):
    tp, sym = p_symbols
    table = dict(d_l=5, d_c=5, l0=[(37, -4, 30, 3, 34, -2),
                                   (28, 6, 33, -1, 31, 2)]) if wp else None
    p = dataclasses.replace(tp, weighted_pred=wp)
    jp = JParams(**dataclasses.asdict(p))
    for s in range(SLICES):
        kw = dict(frame_num=1, num_ref=2, row0=s, n_rows=1, wp=table,
                  dp_slice_id=s if dp else None)
        got = PK.pack_p_slice(sym, p, 30, **kw)
        assert got == JPK.pack_p_slice(sym, jp, 30, **kw)
        assert isinstance(got, tuple) == dp
    assert (sym["win"] >= 5).any()


# ---------------------------------------------------------------------------
# (f) a B sequence takes no rate control
# ---------------------------------------------------------------------------

class _Untouchable:
    """A controller whose every attribute access raises."""

    def __getattr__(self, name):
        raise AssertionError(f"the B sequence read rate_control.{name}")


def test_b_sequence_does_not_consult_rate_control(frames):
    p = AVCParams(width=W, height=H, qp=30, profile_idc=77, poc_type=0,
                  num_ref_frames=2)
    codec = DeviceAVCCodec(p, search_range=SR, n_slices=SLICES, bframes=1,
                           device="cpu")
    res, stream = codec.encode_sequence(frames[:3],
                                        rate_control=_Untouchable())
    assert [r.frame_type for r in res] == ["IDR", "B", "P"]
    ref, _ = DeviceAVCCodec(p, search_range=SR, n_slices=SLICES, bframes=1,
                            device="cpu").encode_sequence(frames[:3])
    assert [r.bits for r in res] == [r.bits for r in ref]
    assert stream
