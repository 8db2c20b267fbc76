"""The port's hierarchical-B sequence encoder reads its source one GOP ahead
(on the CPU at 64x64, without the JAX package): a recording iterator shows it
takes the IDR and codes it, then takes a GOP of 4 (or the rest of the clip)
before it codes the GOP, so it never takes frame k before k - 4 pictures are
packed; a generator and a list give the same stream."""

import numpy as np
import pytest
import torch

from h264tpu_torch.avc.device_codec import DeviceAVCCodec
from h264tpu_torch.avc.params import AVCParams

H = W = 64
G = 4
P = AVCParams(width=W, height=H, qp=28, profile_idc=77, poc_type=0,
              num_ref_frames=3, cabac=True)
KW = dict(search_range=7, n_slices=1, bframes=3, hierarchical=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n, seed=7):
    """A textured scene panned (1, 2) pels a frame, with noise."""
    rng = np.random.default_rng(seed)
    big = rng.normal(0, 1, (H + 2 * n, W + 2 * n))
    for _ in range(3):
        big = (big + np.roll(big, 1, 0) + np.roll(big, -1, 0)
               + np.roll(big, 1, 1) + np.roll(big, -1, 1)) / 5
    big = 128 + big / big.std() * 40
    out = []
    for i in range(n):
        y = np.clip(big[i:i + H, 2 * i:2 * i + W]
                    + rng.normal(0, 3, (H, W)), 0, 255).astype(np.uint8)
        out.append((y, (y[::2, ::2] // 2 + 60).astype(np.uint8),
                    (200 - y[1::2, 1::2] // 2).astype(np.uint8)))
    return out


def _recorded(codec, frames, packed):
    """``frames``, appending the pictures packed so far at each take."""
    for f in frames:
        packed.append(len(codec.host_ms["pack"]))
        yield f


@pytest.fixture(scope="module")
def clips():
    return {n: _frames(n) for n in (1, 2, 5, 6, 9)}


@pytest.fixture(scope="module")
def encoded(clips):
    out = {}
    for n, frames in clips.items():
        codec = DeviceAVCCodec(P, device="cpu", **KW)
        packed = []
        res, stream = codec.encode_sequence(_recorded(codec, frames, packed))
        out[n] = dict(res=res, stream=stream, packed=packed)
    return out


@pytest.mark.parametrize("n", [1, 2, 5, 6, 9])
def test_reads_one_gop_ahead(encoded, n):
    packed = encoded[n]["packed"]
    assert len(packed) == n
    for k, done in enumerate(packed):
        assert done >= k - G
    # the IDR is coded before frame 1 is taken; a GOP is taken whole
    # before its pictures are coded
    assert packed == [0] + [1 + G * ((k - 1) // G) for k in range(1, n)]
    types = [r.frame_type for r in encoded[n]["res"]]
    anchors = sorted(set(range(0, n, G)) | {n - 1})
    assert types == ["IDR" if k == 0 else "P" if k in anchors else "B"
                     for k in range(n)]


def test_generator_and_list_give_the_same_stream(clips, encoded):
    frames = clips[6]
    codec = DeviceAVCCodec(P, device="cpu", **KW)
    res, stream = codec.encode_sequence(frames)
    assert stream == encoded[6]["stream"]
    for a, b in zip(res, encoded[6]["res"]):
        assert (a.frame_type, a.bits) == (b.frame_type, b.bits)
        for x, y in zip(a.recon, b.recon):
            np.testing.assert_array_equal(x, y)
