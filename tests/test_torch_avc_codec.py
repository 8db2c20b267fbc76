"""The PyTorch port's conformant H.264 encoder (``DeviceAVCCodec``) against
the JAX package's ``TPUAVCCodec``, on the CPU: byte-identical streams,
cross-decoding, the symbol arrays of a P frame started from the JAX
reference state, import isolation, device selection and the options that
are not ported."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from h264tpu.avc import tpu_enc as TE
from h264tpu.avc.codec import AVCCodec
from h264tpu.avc.params import AVCParams as JParams
from h264tpu.avc.tpu_codec import TPUAVCCodec, _split_org
from h264tpu_torch.avc import device_enc as DE
from h264tpu_torch.avc.device_codec import DeviceAVCCodec
from h264tpu_torch.avc.params import AVCParams, params_from_dict
from h264tpu_torch.avc.slice_dec import AVCDecoder
from h264tpu_torch.parallel import Mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# (H, W, QP, search range, slices, reference frames, MB row forced intra
# in frame 2); SR 8 is the bench_avc search range
CONFIGS = {"64x64_qp28_2slices": (64, 64, 28, 8, 2, 1, None),
           "64x48_qp36_2refs": (48, 64, 36, 4, 1, 2, 1)}


@pytest.fixture(scope="module", params=list(CONFIGS), ids=list(CONFIGS))
def encoded(request):
    H, W, qp, SR, S, R, row = CONFIGS[request.param]
    frames = smooth_frames(3, H, W)

    def force(idx):
        if row is None or idx != 2:
            return None
        m = np.zeros((H // 16, W // 16), bool)
        m[row] = True
        return m

    jp = JParams(width=W, height=H, qp=qp, num_ref_frames=R)
    j_res, j_stream = TPUAVCCodec(jp, intra_period=0, search_range=SR,
                                  n_slices=S).encode_sequence(
                                      frames, force_intra=force)
    tp = params_from_dict(dataclasses.asdict(jp))
    codec = DeviceAVCCodec(tp, intra_period=0, search_range=SR, n_slices=S,
                           device="cpu")
    t_res, t_stream = codec.encode_sequence(frames, force_intra=force)
    return dict(frames=frames, jp=jp, tp=tp, SR=SR, S=S, R=R, qp=qp,
                j_res=j_res,
                j_stream=j_stream, t_res=t_res, t_stream=t_stream)


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
    state (its prep_ref of the decoded IDR), carried across as numpy."""
    jp, tp, SR, S, R, qp = (encoded[k]
                            for k in ("jp", "tp", "SR", "S", "R", "qp"))
    H, W = jp.height, jp.width
    ref_j = TE.prep_ref(*(jnp.asarray(pl, jnp.int32)
                          for pl in encoded["j_res"][0].recon), SR)
    ups, us, vs = (jnp.stack([x] * R) for x in ref_j)
    y, u, v = _split_org(jnp.asarray(np.concatenate(
        [encoded["frames"][1][0],
         np.concatenate(encoded["frames"][1][1:], axis=1)])), H=H, W=W)
    kw = dict(mb_h=jp.mb_h, mb_w=jp.mb_w, sr=SR, n_slices=S,
              chroma_qp_offset=0)
    sym_j, rec_j, ctx_j = TE.encode_frame(
        y, u, v, ups, us, vs, jnp.int32(qp), jnp.int32(1),
        jnp.zeros((jp.mb_h, jp.mb_w), bool), None, intra_only=False,
        transform8=False, sub8x8=False, scaling_default=False, **kw)
    ref_t = DE.dpb_from_numpy(*(np.asarray(x) for x in ref_j), "cpu")
    sym_t, rec_t, ctx_t = DE.encode_frame(
        *(torch.as_tensor(np.asarray(pl, np.int32))
          for pl in encoded["frames"][1]),
        *(torch.stack([x] * R) for x in ref_t), qp, 1,
        torch.zeros((tp.mb_h, tp.mb_w), dtype=torch.bool), intra_only=False,
        **kw)
    assert set(sym_t) <= set(sym_j)
    for k, a in sym_t.items():
        np.testing.assert_array_equal(a.numpy().astype(np.int64),
                                      np.asarray(sym_j[k]).astype(np.int64), k)
    for a, b in zip(rec_t, rec_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for k in ("nnz", "mv", "ref", "mb_intra"):
        np.testing.assert_array_equal(ctx_t[k].numpy().astype(np.int64),
                                      np.asarray(ctx_j[k]).astype(np.int64))
    assert (sym_t["win"].numpy() != 0).any()


def test_codec_reused_across_clips_equals_fresh_codecs():
    """One codec that encodes two clips back to back at two QPs (the first
    with a forced intra MB row) writes the bytes of a fresh codec per clip
    on a thread with no scan plans: the second clip's scans reuse the
    first's plans, and nothing of the first clip stays in them."""
    H, W = 48, 64
    tp = AVCParams(width=W, height=H, qp=36, num_ref_frames=2)
    force = np.zeros((H // 16, W // 16), bool)
    force[1] = True
    clips = [(smooth_frames(3, H, W, seed=1), 36,
              lambda i: force if i == 2 else None),
             (smooth_frames(3, H, W, seed=2), 30, lambda i: None)]

    def codec():
        return DeviceAVCCodec(tp, search_range=4, device="cpu")

    one = codec()
    reused = [one.encode_sequence(f, qp=q, force_intra=fi)[1]
              for f, q, fi in clips]
    fresh = []
    for f, q, fi in clips:
        DE.drop_plans()
        fresh.append(codec().encode_sequence(f, qp=q, force_intra=fi)[1])
    assert reused == fresh and reused[0] != reused[1]


def test_scan_outputs_share_no_storage_with_a_plan():
    """What ``decide``/``decide_b`` return, and ``assemble``'s views of
    both, own their storage: no tensor shares one with a plan's buffers, and a
    later scan through the same plan leaves them as they were."""
    H, W, sr, qp = 48, 64, 4, 30
    frames = smooth_frames(3, H, W, seed=3)
    planes = [tuple(torch.as_tensor(pl).to(torch.int32) for pl in f)
              for f in frames]
    ups, us, vs = (x[None] for x in DE.prep_ref(*planes[0], sr))
    ref = (ups, us, vs)
    col_mv = torch.zeros((H // 4, W // 4, 2), dtype=torch.int32)
    col_ref = torch.full((H // 4, W // 4), -1, dtype=torch.int32)
    force = torch.zeros((H // 16, W // 16), dtype=torch.bool)

    def scans(y, u, v):
        mv_q, sad_q = DE.search(y, ups, sr, qp)
        sym, st = DE.decide(y, u, v, ups, us, vs, mv_q, sad_q, qp, 1, force,
                            sr=sr, sb_h=H // 16, intra_only=False)
        mv16, sad16 = (x[:, :, 0] for x in DE.search(y, ups, sr, qp,
                                                     only16=True))
        sym_b, st_b = DE.decide_b(y, u, v, ref, ref, mv16, sad16, mv16,
                                  sad16, col_mv, col_ref, qp, 1, 1, sr=sr,
                                  sb_h=H // 16)
        rec, ctx = DE.assemble(sym, st, H // 16, W // 16)
        rec_b, ctx_b = DE.assemble(sym_b, st_b, H // 16, W // 16)
        return [sym, st, ctx, sym_b, st_b, ctx_b, dict(enumerate(rec)),
                dict(enumerate(rec_b))]

    DE.drop_plans()
    first = scans(*planes[1])
    kept = [{k: t.clone() for k, t in d.items()} for d in first]
    second = scans(*planes[2])
    plans = list(DE._plans().values())
    assert len(plans) == 2
    owned = {t.untyped_storage().data_ptr() for pl in plans
             for d in (pl.inp, pl.st, pl.ys, {"t": pl.t}) for t in d.values()}
    for d in first + second:
        for k, t in d.items():
            assert t.untyped_storage().data_ptr() not in owned, k
    for d, c in zip(first, kept):
        for k in d:
            assert torch.equal(d[k], c[k]), k
    assert not all(torch.equal(a[k], b[k]) for a, b in zip(first, second)
                   for k in a)


def test_lane_range_stays_int64_beside_an_int32_range_of_its_length():
    """The scan's lane ranges are int64 even where ``ops/`` has cached an
    int32 range of the same length under "arange<n>" (the card's intra 4x4
    kernel takes the lanes' MB rows and columns as int64 and raises on
    int32), and ``device_const`` refuses a cached name asked for with
    another dtype or shape."""
    from h264tpu_torch import device_const
    device_const("arange37", np.arange(37, dtype=np.int32), "cpu")
    assert DE._ar(37, "cpu").dtype == torch.int64
    assert torch.equal(DE._ar(37, "cpu"), torch.arange(37))
    with pytest.raises(ValueError, match="cached as int32"):
        device_const("arange37", np.arange(37, dtype=np.int64), "cpu")
    with pytest.raises(ValueError, match="cached as int32"):
        device_const("arange37", np.arange(38, dtype=np.int32), "cpu")


def test_encode_loads_no_jax():
    code = (
        "import sys, numpy as np\n"
        "from h264tpu_torch.avc.device_codec import DeviceAVCCodec\n"
        "from h264tpu_torch.avc.params import AVCParams\n"
        "f = [(np.full((32, 32), 100 + i, np.uint8),"
        " np.full((16, 16), 128, np.uint8), np.full((16, 16), 90, np.uint8))"
        " for i in range(2)]\n"
        "r, s = DeviceAVCCodec(AVCParams(width=32, height=32), search_range=2,"
        " device='cpu').encode_sequence(f)\n"
        "assert len(r) == 2 and s\n"
        "f = [(np.full((32, 32), 100 + 3 * i, np.uint8),"
        " np.full((16, 16), 128, np.uint8), np.full((16, 16), 90, np.uint8))"
        " for i in range(5)]\n"
        "p = AVCParams(width=32, height=32, profile_idc=77, poc_type=0,"
        " num_ref_frames=3, cabac=True)\n"
        "r, s = DeviceAVCCodec(p, search_range=2, bframes=3, hierarchical=True,"
        " device='cpu').encode_sequence(f)\n"
        "assert [x.frame_type for x in r] == ['IDR', 'B', 'B', 'B', 'P'] and s\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'h264tpu' or m.startswith('h264tpu.')]\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout


def test_no_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceAVCCodec(AVCParams(width=32, height=32))


# options that raise in both packages: TPUAVCCodec's own limits, which the
# port keeps, WP with a device mesh among them
UNPORTED = {
    "b_frames_transform8": (dict(profile_idc=100, transform_8x8=True,
                                 poc_type=0), dict(bframes=1)),
    "sub8x8_cabac": (dict(cabac=True, profile_idc=77), dict(sub8x8=True)),
    "weighted_pred_cabac": (dict(weighted_pred=True, cabac=True,
                                 profile_idc=77), {}),
    "weighted_pred_bframes": (dict(weighted_pred=True, profile_idc=77,
                                   poc_type=0), dict(bframes=1)),
    "mesh": (dict(weighted_pred=True), dict(mesh=Mesh(["cpu"], ("slice",)))),
    "data_partitioning_cabac": (dict(cabac=True, profile_idc=77),
                                dict(data_partitioning=True)),
}


def _intra8x8_stream():
    """An IDR of four I_NxN MBs with transform_size_8x8_flag = 1, each 8x8
    predicted in its most probable mode, no residual (no encoder of the
    repo emits one; tests/test_torch_avc_intra8x8.py writes fuller ones)."""
    from h264tpu_torch.avc.params import (assemble_stream,
                                          write_slice_header, SLICE_I)
    from h264tpu_torch.avc.tables import CBP_TO_CODENUM_INTRA
    from h264tpu_torch.entropy.bitio import BitWriter
    p = AVCParams(width=32, height=32, profile_idc=100, transform_8x8=True)
    w = BitWriter()
    write_slice_header(w, p, SLICE_I, 0, True, p.qp)
    for _ in range(4):
        w.ue(0)                               # mb_type I_NxN
        w.u(1, 1)                             # transform_size_8x8_flag
        w.u(0xF, 4)                           # prev_intra8x8_pred_mode_flag x4
        w.ue(0)                               # intra_chroma_pred_mode DC
        w.ue(int(CBP_TO_CODENUM_INTRA[0]))    # coded_block_pattern 0
    w.u(1, 1)
    return assemble_stream(p, [(True, w.to_bytes())])


@pytest.mark.parametrize("name", list(UNPORTED) + ["decoder_intra8x8"])
def test_unported_option_raises(name):
    if name == "decoder_intra8x8":
        # ported since: the decoder reads Intra 8x8 as the JAX decoder does
        from h264tpu.avc.slice_dec import AVCDecoder as JDecoder
        stream = _intra8x8_stream()
        got, want = AVCDecoder().decode(stream), JDecoder().decode(stream)
        assert len(got) == len(want) == 1
        for c in range(3):
            np.testing.assert_array_equal(got[0][c], want[0][c])
        return
    params, kwargs = UNPORTED[name]
    with pytest.raises(NotImplementedError):
        DeviceAVCCodec(AVCParams(width=32, height=32, **params),
                       device="cpu", **kwargs)


def test_params_from_dict_round_trip():
    jp = JParams(width=96, height=64, qp=31, num_ref_frames=3,
                 vui_timing=(1, 50))
    tp = params_from_dict(dataclasses.asdict(jp))
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    with pytest.raises(ValueError):
        params_from_dict(dict(dataclasses.asdict(jp), bogus=1))


def test_mvc_stream_equals_jax(monkeypatch):
    """``MVCStereoCodec``: three stereo pairs (the third view-1 picture
    carries the inter-view reorder) byte-identical with the JAX package's,
    both views reproduced by both decoders' ``decode_mvc``.

    It shares the 64x48 two-reference configuration's JAX compile with the
    fixture above.  The JAX view-1 call omits ``encode_frame``'s last
    argument, ``wp_c``, whose default is None; ``jax.jit`` keys that call
    apart from the base view's, which passes None, and compiles the P
    graph again (~50 s on the CPU).  The shim passes the default
    explicitly: the same function with the same arguments."""
    from h264tpu.avc.mvc import MVCStereoCodec as JMVC
    from h264tpu.avc.slice_dec import AVCDecoder as JDecoder
    from h264tpu_torch.avc.mvc import MVCStereoCodec

    orig = TPUAVCCodec._encode_fn

    def encode_fn(self, intra_only):
        fn = orig(self, intra_only)
        return lambda *a: fn(*a, None) if len(a) == 9 else fn(*a)

    monkeypatch.setattr(TPUAVCCodec, "_encode_fn", encode_fn)
    H, W, _qp, SR, S, R, _row = CONFIGS["64x48_qp36_2refs"]
    f0 = smooth_frames(3, H, W, seed=5)
    f1 = [tuple(np.roll(pl, -2, axis=1) for pl in fr) for fr in f0]
    jp = JParams(width=W, height=H, qp=30, num_ref_frames=R)
    j0, j1, j_stream = JMVC(jp, search_range=SR, n_slices=S).encode_sequence(
        f0, f1)
    t0, t1, t_stream = MVCStereoCodec(
        params_from_dict(dataclasses.asdict(jp)), search_range=SR,
        n_slices=S, device="cpu").encode_sequence(f0, f1)
    assert t_stream == j_stream
    for jr, tr in zip(j0 + j1, t0 + t1):
        assert (tr.bits, tr.psnr_y) == (jr.bits, jr.psnr_y)
    for views in (AVCDecoder().decode_mvc(j_stream),
                  JDecoder().decode_mvc(t_stream)):
        for dec, res in zip(views, (t0, t1)):
            assert len(dec) == 3
            for planes, r in zip(dec, res):
                for a, b in zip(planes, r.recon):
                    np.testing.assert_array_equal(a, b)
