"""The PyTorch port's classic H.264-style inter path (``inter_mode="classic"``)
against the JAX package on the CPU: motion search, sub-pel refinement, MC
and loop-filter strengths on seeded inputs, then the codec's streams."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from h264tpu.ops import me as JME
from h264tpu.ops import deblock as JDB
from h264tpu.utils.config import CodecConfig as JCfg, FractalConfig as JFr
from h264tpu.models.fractal_codec import (FractalCodec as JCodec,
                                          FractalDecoder as JDecoder)
from h264tpu_torch.ops import me as TME
from h264tpu_torch.ops import deblock as TDB
from h264tpu_torch.utils.config import config_from_dict
from h264tpu_torch.models.fractal_codec import (FractalCodec as TCodec,
                                                FractalDecoder as TDecoder)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a, np.int32))


def blocky_frames(n, H, W, seed=0):
    """A blocky random texture per plane, shifted one pel per frame."""
    rng = np.random.default_rng(seed)
    tex = [np.kron(rng.integers(0, 255, (h // 4, w // 4)),
                   np.ones((4, 4), np.int64)).astype(np.uint8)
           for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    return [tuple(np.roll(t, (i, -i), axis=(0, 1)) for t in tex)
            for i in range(n)]


def payloads_of(stream, results):
    """Per-frame payloads of a raw FVC stream."""
    sizes = [r.bits // 8 for r in results]
    off = len(stream) - sum(sizes)
    out = []
    for s in sizes:
        out.append(stream[off:off + s])
        off += s
    return out


def _me_inputs(kind, H=48, W=64, seed=5):
    rng = np.random.default_rng(seed)
    if kind == "random":
        org = rng.integers(0, 256, (H, W))
        ref = rng.integers(0, 256, (H, W))
    elif kind == "shifted":
        ref = np.kron(rng.integers(0, 256, (H // 4, W // 4)), np.ones((4, 4)))
        org = np.roll(ref, (3, -5), axis=(0, 1))
    elif kind == "flat":                 # every offset ties on SAD
        ref = np.full((H, W), 77)
        org = np.full((H, W), 80)
    else:                                # period 4: many exact matches
        ref = np.tile(rng.integers(0, 256, (4, 4)), (H // 4, W // 4))
        org = ref.copy()
    return org.astype(np.int32), ref.astype(np.int32)


@pytest.mark.parametrize("kind", ["random", "shifted", "flat", "periodic"])
@pytest.mark.parametrize("lam", [0, 1])
def test_full_search_int_matches_jax(kind, lam):
    """Spiral running best with the first-minimum tie-break, MV cost
    included (flat and periodic planes tie on SAD everywhere)."""
    org, ref = _me_inputs(kind)
    fn = jax.jit(JME.full_search_int, static_argnums=(2, 3, 4))
    want = fn(jnp.asarray(org), jnp.asarray(ref), 16, 6, lam)
    got = TME.full_search_int(_t(org), _t(ref), 16, 6, lam)
    for f in ("mv_x", "mv_y", "sad"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


def test_sixtap_and_ue_len_match_jax():
    rng = np.random.default_rng(2)
    plane = rng.integers(0, 256, (24, 40)).astype(np.int32)
    np.testing.assert_array_equal(
        TME.sixtap_halfpel(_t(plane)).numpy(),
        np.asarray(jax.jit(JME.sixtap_halfpel)(jnp.asarray(plane))))
    v = np.arange(-5000, 5001, dtype=np.int32)
    np.testing.assert_array_equal(TME._ue_len(_t(v)).numpy(),
                                  np.asarray(JME._ue_len(jnp.asarray(v))))


@pytest.mark.parametrize("spread", [8, 200])
def test_subpel_refine_matches_jax(spread):
    """Refinement from seeded start vectors; a spread of 200 quarter pels
    sends blocks past the frame edge, where the gathers clamp."""
    rng = np.random.default_rng(spread)
    H, W, bs = 48, 64, 16
    org = rng.integers(0, 256, (H, W)).astype(np.int32)
    ref = np.clip(np.roll(org, (1, 2), axis=(0, 1))
                  + rng.integers(-9, 10, (H, W)), 0, 255).astype(np.int32)
    mvx = rng.integers(-spread, spread + 1, (H // bs, W // bs)).astype(np.int32)
    mvy = rng.integers(-spread, spread + 1, (H // bs, W // bs)).astype(np.int32)
    up = np.asarray(jax.jit(JME.sixtap_halfpel)(jnp.asarray(ref)))
    sad0 = np.zeros_like(mvx)
    fn = jax.jit(JME.subpel_refine, static_argnums=(3, 4))
    want = fn(jnp.asarray(org), jnp.asarray(up),
              JME.MEResult(jnp.asarray(mvx), jnp.asarray(mvy),
                           jnp.asarray(sad0)), bs, 1)
    got = TME.subpel_refine(_t(org), _t(up),
                            TME.MEResult(_t(mvx), _t(mvy), _t(sad0)), bs, 1)
    for f in ("mv_x", "mv_y", "sad"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("bs", [16, 8])
def test_motion_compensate_matches_jax_with_clamped_mvs(bs):
    rng = np.random.default_rng(bs)
    H, W = 48, 64
    up = rng.integers(0, 256, (4 * H, 4 * W)).astype(np.int32)
    mvx = rng.integers(-300, 301, (H // bs, W // bs)).astype(np.int32)
    mvy = rng.integers(-300, 301, (H // bs, W // bs)).astype(np.int32)
    fn = jax.jit(JME.motion_compensate, static_argnums=(3, 4, 5))
    want = fn(jnp.asarray(up), jnp.asarray(mvx), jnp.asarray(mvy), bs, H, W)
    got = TME.motion_compensate(_t(up), _t(mvx), _t(mvy), bs, H, W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_strengths_inter_and_me_lambda_match_jax():
    rng = np.random.default_rng(9)
    mvx = rng.integers(-8, 9, (12, 16)).astype(np.int32)
    mvy = rng.integers(-8, 9, (12, 16)).astype(np.int32)
    nz = rng.random((12, 16)) < 0.3
    want = JDB.strengths_inter(jnp.asarray(mvx), jnp.asarray(mvy),
                               jnp.asarray(nz))
    got = TDB.strengths_inter(_t(mvx), _t(mvy), torch.as_tensor(nz))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert [TME.me_lambda(q) for q in range(52)] == \
        [JME.me_lambda(q) for q in range(52)]


# -- the classic sequence ----------------------------------------------------

H, W = 64, 64


@pytest.fixture(scope="module", params=[1, 2], ids=["tile_rows1",
                                                    "tile_rows2"])
def classic(request):
    frames = blocky_frames(4, H, W)
    jcfg = JCfg(width=W, height=H, qp=24, intra_period=0, deblock=True,
                inter_mode="classic", tile_rows=request.param,
                fractal=JFr(search_range=4))
    j_res, j_stream = JCodec(jcfg).encode_sequence(frames)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    t_res, t_stream = TCodec(tcfg, device="cpu").encode_sequence(frames)
    return dict(frames=frames, tcfg=tcfg, j_res=j_res, j_stream=j_stream,
                t_res=t_res, t_stream=t_stream, tile_rows=request.param)


def test_classic_stream_byte_identical(classic):
    assert classic["t_stream"] == classic["j_stream"]
    for j, t in zip(classic["j_res"], classic["t_res"]):
        assert (t.frame_type, t.bits, t.qp) == (j.frame_type, j.bits, j.qp)
        for a, b in zip(t.recon, j.recon):
            np.testing.assert_array_equal(a, b)
    assert [r.frame_type for r in classic["t_res"]] == ["I", "P", "P", "P"]


def test_classic_decoders_agree(classic):
    """Each decoder reads the other's stream to the same planes; at
    tile_rows=1 they are the encoder's reconstruction.  At tile_rows=2 the
    JAX encoder deblocks classic P frames over the whole plane and its
    decoder by row bands, so both decoders differ from the encoder there:
    the port keeps that reference fault (ROADMAP §3)."""
    t_dec = TDecoder(device="cpu").decode(classic["j_stream"])
    j_dec = JDecoder().decode(classic["t_stream"])
    for a_f, b_f in zip(t_dec, j_dec):
        for a, b in zip(a_f, b_f):
            np.testing.assert_array_equal(a, np.asarray(b))
    same = [all(np.array_equal(a, b) for a, b in zip(r.recon, d))
            for r, d in zip(classic["t_res"], t_dec)]
    if classic["tile_rows"] == 1:
        assert all(same)
    else:
        assert same[0] and not all(same[1:])


def test_classic_carried_state(classic):
    """The JAX reconstruction, handed to the port as the reference, gives
    the JAX P-frame payload byte for byte."""
    want = payloads_of(classic["j_stream"], classic["j_res"])
    codec = TCodec(classic["tcfg"], device="cpu")
    for k in (1, 3):
        res, payload = codec.encode_frame(classic["frames"][k],
                                          ref=classic["j_res"][k - 1].recon,
                                          frame_idx=k)
        assert res.frame_type == "P"
        assert payload == want[k]
