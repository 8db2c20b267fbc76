"""The PyTorch port's FMO maps and MB concealment against the JAX package, on
the CPU: ``models/resilience.py`` at ``tests/test_resilience.py``'s
parameters, FMO streams of the JAX host encoder (slice-group map types 0 and
1) through both decoders, and a ``DeviceAVCCodec`` stream with a lost slice
NAL (in the IDR, then in a P picture) through both decoders, which must give
the same pictures and conceal the same MBs.  No JAX compile."""

import dataclasses

import numpy as np
import pytest
import torch

from h264tpu.avc import erc as JERC
from h264tpu.avc.codec import AVCCodec
from h264tpu.avc.params import AVCParams as JParams
from h264tpu.avc.slice_dec import AVCDecoder as JDecoder
from h264tpu.models import resilience as JRS
from h264tpu_torch.avc.device_codec import DeviceAVCCodec
from h264tpu_torch.avc.params import params_from_dict
from h264tpu_torch.avc.slice_dec import AVCDecoder
from h264tpu_torch.bitstream import nal
from h264tpu_torch.models import resilience as RS

from test_torch_avc_codec import smooth_frames

W, H = 11, 9  # QCIF MB grid, as tests/test_resilience.py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (map type, groups, keyword arguments) of tests/test_resilience.py
MAPS = {
    "type0": (0, 3, dict(run_lengths=[4, 2, 3])),
    "type1": (1, 4, {}),
    "type2": (2, 2, dict(top_left=[1 * W + 2], bottom_right=[3 * W + 3])),
    "type3_dir0": (3, 2, dict(change_direction=0, change_rate=2,
                              change_cycle=10)),
    "type3_dir1": (3, 2, dict(change_direction=1, change_rate=2,
                              change_cycle=10)),
    "type4_dir0": (4, 2, dict(change_direction=0, change_rate=3,
                              change_cycle=5)),
    "type4_dir1": (4, 2, dict(change_direction=1, change_rate=3,
                              change_cycle=5)),
    "type5": (5, 2, dict(change_direction=0, change_rate=2, change_cycle=7)),
    "type6": (6, 3, dict(explicit_map=np.arange(H * W) % 3)),
}


@pytest.mark.parametrize("name", list(MAPS))
def test_slice_group_map_and_scan_order_equal_jax(name):
    t, groups, kw = MAPS[name]
    got = RS.slice_group_map(t, groups, W, H, **kw)
    want = JRS.slice_group_map(t, groups, W, H, **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for a, b in zip(RS.mb_scan_order(got), JRS.mb_scan_order(want)):
        np.testing.assert_array_equal(a, b)


def test_random_intra_refresh_equals_jax():
    mine, ref = RS.RandomIntraRefresh(W, H, refresh=7), \
        JRS.RandomIntraRefresh(W, H, refresh=7)
    np.testing.assert_array_equal(mine.pattern, ref.pattern)
    for _ in range(int(np.ceil(H * W / 7)) + 2):
        np.testing.assert_array_equal(mine.new_picture(), ref.new_picture())
        np.testing.assert_array_equal(mine.intra_mask(H, W),
                                      ref.intra_mask(H, W))
        mb = int(ref.current[0])
        assert mine.is_intra(mb) == ref.is_intra(mb)


def test_leaky_bucket_equals_jax():
    rng = np.random.default_rng(0)
    bits = rng.integers(5_000, 80_000, 60)
    bits[0] = 200_000
    params = RS.leaky_bucket_params(bits, 4, frame_rate=30.0)
    assert params == JRS.leaky_bucket_params(bits, 4, frame_rate=30.0)
    assert RS.leaky_bucket_params(bits, 2, 25.0, jumpd=1,
                                  rates=[900_000, 1_500_000]) == \
        JRS.leaky_bucket_params(bits, 2, 25.0, jumpd=1,
                                rates=[900_000, 1_500_000])
    for R, B, F in params:
        for b_size in (B, B // 2):
            f = min(F, b_size)
            assert RS.verify_leaky_bucket(bits, R, b_size, f, 30.0) == \
                JRS.verify_leaky_bucket(bits, R, b_size, f, 30.0)


@pytest.mark.parametrize("map_type", [0, 1])
def test_fmo_stream_decodes_as_jax(map_type):
    """JAX's host encoder, two slice groups, all-IDR: both decoders give
    the encoder's reconstruction."""
    frames = smooth_frames(2, 144, 176)
    p = JParams(width=176, height=144, qp=30, slice_groups=2,
                slice_group_map_type=map_type)
    res, stream = AVCCodec(p, intra_period=1).encode_sequence(frames)
    mine = AVCDecoder().decode(stream)
    ref = JDecoder().decode(stream)
    assert len(mine) == len(ref) == len(res) == 2
    for r, a, b in zip(res, mine, ref):
        for c in range(3):
            np.testing.assert_array_equal(a[c], b[c])
            np.testing.assert_array_equal(a[c], r.recon[c])


def drop_slice(stream: bytes, slice_index: int) -> bytes:
    """The Annex-B stream without its ``slice_index``-th coded slice NAL."""
    kept, seen = [], 0
    for n in nal.annexb_parse(stream):
        if n.nal_type in (nal.NAL_SLICE, nal.NAL_IDR):
            seen += 1
            if seen - 1 == slice_index:
                continue
        kept.append(n)
    assert seen > slice_index
    return nal.annexb_write(kept)


S = 3       # slices per picture


@pytest.fixture(scope="module")
def encoded():
    """A QCIF stream of the port's encoder: 1 IDR + 2 P in 3 slices."""
    frames = smooth_frames(3, 144, 176)
    jp = JParams(width=176, height=144, qp=30, num_ref_frames=1)
    codec = DeviceAVCCodec(params_from_dict(dataclasses.asdict(jp)),
                           search_range=4, n_slices=S, device="cpu")
    return codec.encode_sequence(frames)


@pytest.mark.parametrize("picture,slice_in_picture", [(0, 1), (0, 0), (2, 1)],
                         ids=["idr_middle", "idr_first", "p_middle"])
def test_lost_slice_concealed_as_jax(encoded, monkeypatch, picture,
                                     slice_in_picture):
    res, stream = encoded
    lossy = drop_slice(stream, picture * S + slice_in_picture)
    j_counts = []
    conceal = JERC.conceal_picture

    def counted(pic):
        j_counts.append(conceal(pic))
        return j_counts[-1]

    monkeypatch.setattr(JERC, "conceal_picture", counted)
    dec = AVCDecoder()
    mine = dec.decode(lossy)
    ref = JDecoder().decode(lossy)
    assert len(mine) == len(ref) == 3
    for a, b in zip(mine, ref):
        for c in range(3):
            np.testing.assert_array_equal(a[c], b[c])
    # the JAX decoder conceals only the pictures with missing MBs
    assert [n for n in dec.concealed_mbs if n] == j_counts
    lost = [0] * 3
    lost[picture] = 3 * 11           # one slice: 3 MB rows of 11
    assert dec.concealed_mbs == lost
    # every picture after the lost one predicts from the concealed one
    for i, (r, planes) in enumerate(zip(res, mine)):
        same = np.array_equal(planes[0], r.recon[0])
        assert same == (i < picture), i
