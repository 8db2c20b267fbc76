"""The PyTorch port's region (object) coding against the JAX package on the
CPU: the segmenter's morphology and masks, the masked fit, the per-object
search and reconstruction, then the region-coded streams."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from h264tpu.ops import region as JRG, segment as JSG
from h264tpu.utils.config import CodecConfig as JCfg, FractalConfig as JFr
from h264tpu.models.fractal_codec import (FractalCodec as JCodec,
                                          FractalDecoder as JDecoder)
from h264tpu_torch.ops import region as TRG, segment as TSG
from h264tpu_torch.utils.config import config_from_dict
from h264tpu_torch.models.fractal_codec import (FractalCodec as TCodec,
                                                FractalDecoder as TDecoder)

H, W = 64, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a, np.int32))


def square_frames(n, seed=0, size=24):
    """A textured square moving (2, 3) pels a frame over a still blocky
    background; chroma carries a flat square."""
    rng = np.random.default_rng(seed)
    bg = [np.kron(rng.integers(40, 90, (h // 8, w // 8)), np.ones((8, 8)))
          for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    sq = rng.integers(150, 250, (size, size))
    out = []
    for i in range(n):
        y, u = bg[0].copy(), bg[1].copy()
        y0, x0 = 8 + 2 * i, 8 + 3 * i
        y[y0:y0 + size, x0:x0 + size] = sq
        u[y0 // 2:(y0 + size) // 2, x0 // 2:(x0 + size) // 2] = 200
        out.append(tuple(p.astype(np.uint8) for p in (y, u, bg[2])))
    return out


@pytest.mark.parametrize("fn", ["gray_erosion", "gray_dilation",
                                "median3x3"])
def test_morphology_matches_jax(fn):
    rng = np.random.default_rng(4)
    img = np.where(rng.random((40, 56)) < 0.4, 255, 0) \
        + rng.integers(0, 30, (40, 56))
    np.testing.assert_array_equal(
        getattr(TSG, fn)(_t(img)).numpy(),
        np.asarray(getattr(JSG, fn)(jnp.asarray(img, jnp.int32))))


def test_segment_sequence_and_labels_match_jax():
    ys = [f[0] for f in square_frames(8)]
    want = [np.asarray(m) for m in JSG.segment_sequence(ys)]
    got = [m.numpy() for m in TSG.segment_sequence(ys, "cpu")]
    assert all(m.dtype == np.uint8 for m in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[0] == 255).any() and (got[0] == 0).any()
    for m in got[:3]:
        np.testing.assert_array_equal(
            TSG.mb_region_labels(torch.as_tensor(m)).numpy(),
            np.asarray(JSG.mb_region_labels(m)))


def _masked_sums(seed, N=20000):
    """Consistent masked sums (n of 256 range pixels) of seeded blocks."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, 257, N)
    n[rng.random(N) < 0.3] = 256
    r = rng.integers(0, 256, (N, 1)) + rng.integers(-40, 41, (N, 256)) \
        * rng.integers(0, 2, (N, 1))
    r = np.clip(r, 0, 255)
    d = np.clip(r * rng.uniform(0.2, 1.5, (N, 1))
                + rng.integers(-60, 60, (N, 1))
                + rng.normal(0, 1, (N, 256)) * rng.integers(0, 20, (N, 1)),
                0, 255).astype(np.int64)
    m = np.arange(256)[None, :] < n[:, None]
    return [x.astype(np.int32) for x in (
        n, (r * m).sum(1), (r * r * m).sum(1), (d * m).sum(1),
        (d * d * m).sum(1), (r * d * m).sum(1))]


def test_masked_fit_bit_exact():
    """The masked fit's five fused multiply-adds and x/100 -> x*(1/100)
    reproduce XLA's float32 rms bit for bit; a and beta exact."""
    sums = _masked_sums(0)
    want = jax.jit(JRG._masked_fit)(*(jnp.asarray(s) for s in sums))
    got = TRG._masked_fit(*(_t(s) for s in sums))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def region_pair():
    frames = square_frames(8)
    masks = [np.asarray(m) for m in JSG.segment_sequence(
        [f[0] for f in frames])]
    rng = np.random.default_rng(3)
    ref = np.clip(frames[0][0].astype(int) + rng.integers(-3, 4, (H, W)),
                  0, 255).astype(np.int32)
    org = frames[1][0].astype(np.int32)
    kw = dict(search_range=4, use_halfpel=True)
    want = JRG.region_search_plane(org, ref, masks[1], masks[0], **kw)
    got = TRG.region_search_plane(_t(org), _t(ref), _t(masks[1]),
                                  _t(masks[0]), **kw)
    return dict(org=org, ref=ref, masks=masks, want=want, got=got)


def test_region_search_plane_matches_jax(region_pair):
    """Parameters of both objects exact; the chosen rms bit for bit."""
    want, got = region_pair["want"], region_pair["got"]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    n = got["n"].numpy()
    assert ((n > 0) & (n < 256)).any(), "no block straddles both objects"


def test_region_reconstruct_matches_jax(region_pair):
    ref, masks = region_pair["ref"], region_pair["masks"]
    params = {k: region_pair["got"][k] for k in ("a", "beta", "dx", "dy",
                                                  "ref")}
    want = JRG.region_reconstruct(
        {k: jnp.asarray(v.numpy()) for k, v in params.items()}, ref,
        masks[1], masks[0], use_halfpel=True)
    got = TRG.region_reconstruct(params, _t(ref), _t(masks[1]),
                                 _t(masks[0]), use_halfpel=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the region-coded sequence -------------------------------------------------

@pytest.fixture(scope="module")
def region_seq():
    frames = square_frames(4)
    jcfg = JCfg(width=W, height=H, qp=24, intra_period=0, deblock=True,
                num_regions=2, fractal=JFr(search_range=4))
    j_res, j_stream, j_masks = JCodec(jcfg).encode_sequence_region(frames)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    t_res, t_stream, t_masks = TCodec(tcfg, device="cpu"
                                      ).encode_sequence_region(frames)
    return dict(frames=frames, tcfg=tcfg, j_res=j_res, j_stream=j_stream,
                j_masks=[np.asarray(m) for m in j_masks], t_res=t_res,
                t_stream=t_stream, t_masks=t_masks)


def test_region_stream_byte_identical(region_seq):
    for a, b in zip(region_seq["t_masks"], region_seq["j_masks"]):
        np.testing.assert_array_equal(a, b)
    assert region_seq["t_stream"] == region_seq["j_stream"]
    assert [r.frame_type for r in region_seq["t_res"]] == ["I", "R", "R", "R"]
    for j, t in zip(region_seq["j_res"], region_seq["t_res"]):
        assert (t.bits, t.qp, t.psnr_y) == (j.bits, j.qp, j.psnr_y)
        for a, b in zip(t.recon, j.recon):
            np.testing.assert_array_equal(a, b)


def test_region_cross_decode(region_seq):
    masks = region_seq["j_masks"]
    t_dec = TDecoder(device="cpu").decode(region_seq["j_stream"], masks=masks)
    j_dec = JDecoder().decode(region_seq["t_stream"], masks=masks)
    for r, tf, jf in zip(region_seq["t_res"], t_dec, j_dec):
        for a, b, c in zip(r.recon, tf, jf):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(b, np.asarray(c))


def test_region_carried_state(region_seq):
    """The JAX reconstruction and the JAX masks give the JAX region frame's
    payload byte for byte."""
    j_res = region_seq["j_res"]
    sizes = [r.bits // 8 for r in j_res]
    starts = np.cumsum([len(region_seq["j_stream"]) - sum(sizes)] + sizes)
    codec = TCodec(region_seq["tcfg"], device="cpu")
    masks = region_seq["j_masks"]
    for k in (1, 2):
        _, payload = codec.encode_region_frame(
            region_seq["frames"][k], j_res[k - 1].recon, masks[k],
            masks[k - 1])
        assert payload == region_seq["j_stream"][starts[k]:starts[k + 1]]
