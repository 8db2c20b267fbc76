"""The PyTorch port's dual-reference fractal search and 3-view coding against
the JAX package on the CPU: the search with a second reference frame (eight
planes, R = 8) against JAX ``impl="scan"``, reconstruction from eight
planes, then the 3-view streams."""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from h264tpu.ops import fractal as JF
from h264tpu.utils.config import CodecConfig as JCfg, FractalConfig as JFr
from h264tpu.models.fractal_codec import (FractalCodec as JCodec,
                                          FractalDecoder as JDecoder)
from h264tpu_torch.ops import fractal as TF
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


KW = dict(search_range=4, tol16=10.5, tol8=8.0)


def _assert_trees_equal(t_port, t_jax):
    np.testing.assert_array_equal(t_port.mb_split.numpy(),
                                  np.asarray(t_jax.mb_split))
    np.testing.assert_array_equal(t_port.b8_mode.numpy(),
                                  np.asarray(t_jax.b8_mode))
    for s in ("s16", "s8", "s84", "s48", "s44"):
        a, b = getattr(t_port, s), getattr(t_jax, s)
        for f in ("a", "beta", "dx", "dy", "ref", "s_d", "rms"):
            np.testing.assert_array_equal(getattr(a, f).numpy(),
                                          np.asarray(getattr(b, f)),
                                          err_msg=f"{s}.{f}")


def _dual_inputs(kind):
    rng = np.random.default_rng(41)
    H, W = 64, 96
    tex = np.kron(rng.integers(0, 256, (H // 4, W // 4)), np.ones((4, 4)))
    org = np.roll(tex, (0, 3), axis=(0, 1))
    ref = np.clip(tex + rng.integers(-20, 21, (H, W)), 0, 255)
    if kind == "tie":                   # both frames equal: every tie
        ref2 = ref.copy()
    else:                               # the second frame matches the left half
        ref2 = np.clip(org + rng.integers(-2, 3, (H, W)), 0, 255)
        ref2[:, W // 2:] = rng.integers(0, 256, (H, W // 2))
    return (org.astype(np.int32), ref.astype(np.int32),
            ref2.astype(np.int32))


@pytest.mark.parametrize("kind", ["second_frame", "tie"])
def test_dual_reference_search_matches_jax_scan(kind):
    """Eight reference planes: parameters and the chosen rms equal; on
    equal rms a plane of the first frame wins."""
    org, ref, ref2 = _dual_inputs(kind)
    fn = jax.jit(functools.partial(JF.search_plane, impl="scan", **KW))
    t_jax = fn(jnp.asarray(org), jnp.asarray(ref),
               extra_ref_ctx=jnp.asarray(ref2))
    t_port = TF.search_plane(_t(org), _t(ref), extra_ref_ctx=_t(ref2), **KW)
    _assert_trees_equal(t_port, t_jax)
    refs = np.concatenate([getattr(t_port, s).ref.numpy().ravel()
                           for s in ("s16", "s8", "s84", "s48", "s44")])
    if kind == "tie":
        assert refs.max() < 4
    else:
        assert refs.max() >= 4 and refs.min() < 4


def test_reconstruct_from_eight_planes_matches_jax():
    org, ref, ref2 = _dual_inputs("second_frame")
    H, W = org.shape
    rng = np.random.default_rng(8)
    cy, cx = H // 4, W // 4
    shape = np.repeat(np.repeat(rng.integers(0, 5, (cy // 4, cx // 4)), 4, 0),
                      4, 1)
    maps = dict(a=rng.integers(-47, 81, (cy, cx)) * 5,
                beta=rng.integers(-12, 52, (cy, cx)) * 5,
                dx=rng.integers(-4, 5, (cy, cx)),
                dy=rng.integers(-4, 5, (cy, cx)),
                ref=rng.integers(0, 8, (cy, cx)), shape=shape)
    want = JF.reconstruct_from_maps(
        {k: jnp.asarray(v, jnp.int32) for k, v in maps.items()},
        jnp.asarray(ref), H, W, extra_ref_ctx=jnp.asarray(ref2))
    got = TF.reconstruct_from_maps({k: _t(v) for k, v in maps.items()},
                                   _t(ref), H, W, extra_ref_ctx=_t(ref2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the 3-view sequence -----------------------------------------------------

H, W = 64, 64


def view_frames(n, seed=0, shift=4):
    """Centre: a blocky texture shifted one pel a frame; the side views are
    the centre shifted by +-shift pels (chroma +-shift/2)."""
    rng = np.random.default_rng(seed)
    tex = [np.kron(rng.integers(0, 255, (h // 4, w // 4)),
                   np.ones((4, 4), np.int64)).astype(np.uint8)
           for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    centre = [tuple(np.roll(t, (i, -i), axis=(0, 1)) for t in tex)
              for i in range(n)]
    return [centre] + [
        [tuple(np.roll(p, s if k == 0 else s // 2, axis=1)
               for k, p in enumerate(f)) for f in centre]
        for s in (shift, -shift)]


@pytest.fixture(scope="module")
def views3():
    views = view_frames(4)
    jcfg = JCfg(width=W, height=H, qp=24, intra_period=0, deblock=True,
                views=3, fractal=JFr(search_range=4))
    j_res, j_stream = JCodec(jcfg).encode_sequence_views(views)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    t_res, t_stream = TCodec(tcfg, device="cpu").encode_sequence_views(views)
    return dict(views=views, tcfg=tcfg, j_res=j_res, j_stream=j_stream,
                t_res=t_res, t_stream=t_stream)


def test_views3_stream_byte_identical(views3):
    assert views3["t_stream"] == views3["j_stream"]
    for vj, vt in zip(views3["j_res"], views3["t_res"]):
        assert [r.frame_type for r in vt] == ["I", "P", "P", "P"]
        for j, t in zip(vj, vt):
            assert (t.bits, t.qp) == (j.bits, j.qp)
            for a, b in zip(t.recon, j.recon):
                np.testing.assert_array_equal(a, b)


def test_views3_cross_decode(views3):
    t_dec = TDecoder(device="cpu").decode(views3["j_stream"])
    j_dec = JDecoder().decode(views3["t_stream"])
    assert len(t_dec) == len(j_dec) == 3
    for v in range(3):
        for r, tf, jf in zip(views3["t_res"][v], t_dec[v], j_dec[v]):
            for a, b, c in zip(r.recon, tf, jf):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(b, np.asarray(c))


def test_views3_carried_state(views3):
    """A side view's P frame from the JAX reconstructions (its own previous
    frame, and the centre's current frame as the second reference) gives
    the JAX payload byte for byte."""
    j_res = views3["j_res"]
    sizes = [j_res[v][f].bits // 8 for f in range(4) for v in range(3)]
    off = len(views3["j_stream"]) - sum(sizes)
    starts = np.cumsum([off] + sizes)
    codec = TCodec(views3["tcfg"], device="cpu")
    for f, v in ((1, 1), (2, 2), (3, 0)):
        i = 3 * f + v
        want = views3["j_stream"][starts[i]:starts[i + 1]]
        ref2 = j_res[0][f].recon if v else None
        _, payload = codec.finalize_frame(codec.dispatch_frame(
            views3["views"][v][f], j_res[v][f - 1].recon, f, ref2=ref2))
        assert payload == want
