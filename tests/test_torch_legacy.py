"""The port's legacy still-image codec (``h264tpu_torch/models/
legacy_icodec.py``), canonical Huffman layer and per-frame Huffman fractal
stream against the JAX package on the CPU.  Every comparison is exact:
quantized levels and decoded planes are equal integer arrays, streams are
equal bytes, and each package decodes the other's stream."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from h264tpu.entropy import fractal_huffman as JFH
from h264tpu.entropy import huffman as JHUF
from h264tpu.entropy.bitio import BitReader as JBitReader
from h264tpu.entropy.bitio import BitWriter as JBitWriter
from h264tpu.models import legacy_icodec as JL
from h264tpu_torch.entropy import fractal_huffman as FH
from h264tpu_torch.entropy import huffman as HUF
from h264tpu_torch.entropy.bitio import BitReader, BitWriter
from h264tpu_torch.models import legacy_icodec as TL


def image(H, W, seed):
    """A smooth luma ramp with noise, random U, flat V."""
    rng = np.random.default_rng(seed)
    y = np.clip(128 + np.cumsum(rng.integers(-4, 5, (H, W)), 1)
                + rng.integers(-2, 3, (H, W)), 0, 255).astype(np.uint8)
    u = rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8)
    v = np.full((H // 2, W // 2), 77, np.uint8)
    return y, u, v


@pytest.mark.parametrize("quality", [1, 10, 50, 75, 100])
def test_levels_and_inverse_equal_jax(quality):
    """fdct_quant_plane and dequant_idct_plane: equal int32 levels and
    uint8 planes, for luma and chroma tables, smooth and random planes."""
    rng = np.random.default_rng(quality)
    for plane in (image(48, 64, quality)[0],
                  rng.integers(0, 256, (48, 64)).astype(np.uint8)):
        for luma in (True, False):
            ref = np.asarray(JL.fdct_quant_plane(jnp.asarray(plane), quality,
                                                 luma))
            out = TL.fdct_quant_plane(torch.as_tensor(plane), quality, luma)
            assert out.dtype == torch.int32
            np.testing.assert_array_equal(out.numpy(), ref)
            back = TL.dequant_idct_plane(out, quality, luma, 48, 64)
            np.testing.assert_array_equal(
                back.numpy(), np.asarray(JL.dequant_idct_plane(
                    jnp.asarray(ref), quality, luma, 48, 64)))


@pytest.mark.parametrize("size,quality", [((64, 96), 75), ((144, 176), 30),
                                          ((32, 48), 100)])
def test_stream_and_cross_decode_equal_jax(size, quality):
    y, u, v = image(*size, seed=size[0])
    ref = JL.encode_image(y, u, v, quality=quality)
    out = TL.encode_image(y, u, v, quality=quality, device="cpu")
    assert out == ref
    jdec = JL.decode_image(out)
    tdec = TL.decode_image(ref, device="cpu")
    for a, b, org in zip(jdec, tdec, (y, u, v)):
        np.testing.assert_array_equal(b, a)
        assert b.dtype == np.uint8 and b.shape == org.shape


def test_huffman_equals_jax():
    rng = np.random.default_rng(5)
    for n_sym, n in ((3, 9), (50, 400), (256, 3000)):
        freqs = rng.integers(0, 1000, n_sym)
        freqs[rng.integers(0, n_sym, n_sym // 5)] = 0
        freqs[0] = 1
        syms = rng.choice(np.nonzero(freqs)[0], size=n)
        lens = HUF.code_lengths(freqs)
        np.testing.assert_array_equal(lens, JHUF.code_lengths(freqs))
        np.testing.assert_array_equal(HUF.canonical_codes(lens),
                                      JHUF.canonical_codes(lens))
        w, jw = BitWriter(), JBitWriter()
        for mod, wr in ((HUF, w), (JHUF, jw)):
            mod.write_codebook(wr, lens)
            mod.encode_symbols(wr, syms, lens)
        data = w.to_bytes()
        assert data == jw.to_bytes()
        r = BitReader(data)
        np.testing.assert_array_equal(
            HUF.decode_symbols(r, HUF.read_codebook(r), n), syms)
    # a single-symbol alphabet and the length cap's damping retry
    np.testing.assert_array_equal(HUF.code_lengths(np.array([0, 7, 0])),
                                  JHUF.code_lengths(np.array([0, 7, 0])))
    fib = np.array([1, 1, 2, 3, 5, 8, 13, 21, 34, 55, 89, 144, 233, 377,
                    610, 987, 1597, 2584, 4181, 6765, 10946, 17711, 28657,
                    46368, 75025, 121393, 196418, 317811])
    lens = HUF.code_lengths(fib)
    assert lens.max() <= HUF.MAX_LEN
    np.testing.assert_array_equal(lens, JHUF.code_lengths(fib))


def random_maps(cy, cx, sr, seed):
    """Dense leaf maps of a random quadtree: per MB unsplit or four 8x8
    modes; every field constant over its leaf."""
    rng = np.random.default_rng(seed)
    shape = np.zeros((cy, cx), np.int64)
    for my in range(cy // 4):
        for mx in range(cx // 4):
            if rng.random() < 0.6:
                modes = rng.integers(1, 5, (2, 2))
                shape[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = np.repeat(
                    np.repeat(modes, 2, 0), 2, 1)
    origins = FH._leaf_origin_mask(shape)
    n = int(origins.sum())
    vals = dict(a=rng.integers(0, 128, n) * 5 + FH.A_MIN,
                beta=rng.integers(0, 64, n) * 5 + FH.BETA_MIN,
                dx=rng.integers(-sr - 1, sr + 2, n),
                dy=rng.integers(-sr - 1, sr + 2, n),
                ref=rng.integers(0, 4, n))
    maps = {"shape": shape}
    for k, v in vals.items():
        dense = np.zeros((cy, cx), np.int64)
        dense[origins] = v
        maps[k] = dense
    return maps


def test_fractal_huffman_equals_jax():
    for seed, (h, w) in enumerate(((32, 48), (64, 96))):
        maps = random_maps(h // 4, w // 4, 7, seed)
        data = FH.encode_maps(maps, 7)
        assert data == JFH.encode_maps(maps, 7)
        out = FH.decode_maps(data, h, w, 7)
        ref = JFH.decode_maps(data, h, w, 7)
        assert sorted(out) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(out[k], ref[k])
        origins = FH._leaf_origin_mask(maps["shape"])
        for k in ("a", "beta", "dx", "dy", "ref"):
            np.testing.assert_array_equal(out[k][origins], maps[k][origins])


def test_entropy_plane_round_trip_equals_jax():
    """The DC-DPCM / AC run-length stage on levels with ZRL runs and
    blocks that end on their last coefficient."""
    rng = np.random.default_rng(9)
    zz = rng.integers(-200, 201, (12, 64)) * (rng.random((12, 64)) < 0.15)
    zz[3, 1:] = 0
    zz[4, 63] = 5                      # a run of 62 zeros: ZRLs, no EOB
    w, jw = BitWriter(), JBitWriter()
    TL._entropy_encode_plane(w, zz)
    JL._entropy_encode_plane(jw, zz)
    data = w.to_bytes()
    assert data == jw.to_bytes()
    np.testing.assert_array_equal(TL._entropy_decode_plane(BitReader(data)),
                                  JL._entropy_decode_plane(JBitReader(data)))
    np.testing.assert_array_equal(TL._entropy_decode_plane(BitReader(data)),
                                  zz)


def test_entry_points_need_a_device():
    y, u, v = image(16, 16, 0)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        TL.encode_image(y, u, v)
    stream = TL.encode_image(y, u, v, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        TL.decode_image(stream)
