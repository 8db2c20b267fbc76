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


UNPORTED = {
    "cabac": (dict(cabac=True, profile_idc=77), {}),
    "b_frames": ({}, dict(bframes=1)),
    "transform_8x8": (dict(transform_8x8=True, profile_idc=100), {}),
    "sub8x8": ({}, dict(sub8x8=True)),
    "weighted_pred": (dict(weighted_pred=True, profile_idc=77), {}),
    "mesh": ({}, dict(mesh=object())),
    "data_partitioning": ({}, dict(data_partitioning=True)),
    "scaling_lists": (dict(scaling_matrix="default", profile_idc=100), {}),
}


@pytest.mark.parametrize("name", list(UNPORTED) + ["rate_control"])
def test_unported_option_raises(name):
    if name == "rate_control":
        codec = DeviceAVCCodec(AVCParams(width=32, height=32), device="cpu")
        with pytest.raises(NotImplementedError):
            codec.encode_sequence([], rate_control=object())
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
