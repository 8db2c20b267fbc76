"""The port's mesh-sharded conformant encoder on meshes of CPU slots: the
row-band slices of every picture split over the slots of a "slice" axis give
the unsharded stream byte for byte, at configurations whose unsharded stream
other tests hold to ``TPUAVCCodec`` (``test_torch_avc_codec.py``,
``test_torch_avc_hierb.py``, ``test_torch_avc_rc_dp.py``); and the
refusals: WP with a mesh, basic-unit rate control with a mesh, slices that
do not split over the slots.  No JAX compile."""

import numpy as np
import pytest
import torch

from h264tpu_torch.avc import device_enc as DE
from h264tpu_torch.avc.device_codec import DeviceAVCCodec
from h264tpu_torch.avc.params import AVCParams
from h264tpu_torch.avc.slice_dec import AVCDecoder
from h264tpu_torch.models.ratectl import QuadraticRateControl
from h264tpu_torch.parallel import Mesh

from test_torch_avc_codec import smooth_frames
from test_torch_avc_rc_dp import banded_frames


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def slots(n: int) -> Mesh:
    return Mesh(["cpu"] * n, ("slice",))


HIERB = dict(profile_idc=77, poc_type=0, num_ref_frames=3, cabac=True)

# name: (H, W, QP, AVCParams fields, DeviceAVCCodec options, frames, slots)
CASES = {
    # test_torch_avc_codec.py's 64x64_qp28_2slices
    "ippp_64x64_2slices": (64, 64, 28, {}, dict(search_range=8, n_slices=2),
                           4, 2),
    # test_torch_avc_rc_dp.py's 48x64, 3 slices, SR 4, QP 30
    "ippp_48x64_3slices": (48, 64, 30, {}, dict(search_range=4, n_slices=3),
                           4, 3),
    "ippp_cabac_48x64_3slices": (48, 64, 30, dict(profile_idc=77, cabac=True,
                                                  num_ref_frames=2),
                                 dict(search_range=8, n_slices=3), 3, 3),
    # test_torch_avc_hierb.py's configuration
    "hierb_cabac_64x64_2slices": (64, 64, 28, HIERB,
                                  dict(search_range=8, n_slices=2, bframes=3,
                                       hierarchical=True), 5, 2),
    "hierb_cabac_48x64_3slices": (48, 64, 28, HIERB,
                                  dict(search_range=8, n_slices=3, bframes=3,
                                       hierarchical=True), 5, 3),
}


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_stream_equals_unsharded(name):
    H, W, qp, fields, kw, n, n_slots = CASES[name]
    frames = smooth_frames(n, H, W)
    p = AVCParams(width=W, height=H, qp=qp, **fields)
    res1, s1 = DeviceAVCCodec(p, device="cpu", **kw).encode_sequence(frames)
    codec = DeviceAVCCodec(p, mesh=slots(n_slots), **kw)
    assert codec.device == torch.device("cpu")
    res, s = codec.encode_sequence(frames)
    assert s == s1
    for r, r1, planes in zip(res, res1, AVCDecoder().decode(s)):
        assert (r.frame_type, r.bits) == (r1.frame_type, r1.bits)
        for a, b in zip(planes, r.recon):
            np.testing.assert_array_equal(a, b)


def test_sharded_frame_rate_control_stream_equals_unsharded():
    """Frame-level rate control (rc_mode 1) over three slots, as
    ``test_torch_avc_rc_dp.py`` runs it unsharded."""
    frames = banded_frames(6)
    p = AVCParams(width=64, height=48, qp=30)
    kw = dict(search_range=4, n_slices=3)
    streams = []
    for codec in (DeviceAVCCodec(p, device="cpu", **kw),
                  DeviceAVCCodec(p, mesh=slots(3), **kw)):
        rc = QuadraticRateControl(90_000.0, 30.0, 30, rc_mode=1)
        streams.append(codec.encode_sequence(frames, rate_control=rc)[1])
    assert streams[0] == streams[1]


def test_sharded_encode_per_slice_qps():
    """make_sharded_encode cuts per-slice QPs (and the forced-intra rows)
    by slot as encode_frame spreads them over the lanes."""
    H, W, sr = 48, 64, 4
    f0, f1 = smooth_frames(2, H, W)
    ref = DE.prep_ref(*(torch.as_tensor(pl) for pl in f0), sr)
    y, u, v = (torch.as_tensor(pl).to(torch.int32) for pl in f1)
    stacks = [x[None] for x in ref]
    force = torch.zeros((3, 4), dtype=torch.bool)
    force[1, 2] = True
    kw = dict(mb_h=3, mb_w=4, sr=sr, intra_only=False, n_slices=3)
    qps = [27, 31, 35]
    want = DE.encode_frame(y, u, v, *stacks, qps, 1, force, **kw)
    got = DE.make_sharded_encode(slots(3), "slice", **kw)(
        y, u, v, *stacks, qps, 1, force)
    for a, b in zip(got, want):
        for k in (a if isinstance(a, dict) else range(len(a))):
            assert torch.equal(a[k], b[k]), k


def test_sharded_refusals():
    p = AVCParams(width=64, height=48, qp=30)
    with pytest.raises(NotImplementedError, match="WP"):
        DeviceAVCCodec(AVCParams(width=64, height=48, profile_idc=77,
                                 weighted_pred=True),
                       n_slices=3, mesh=slots(3))
    with pytest.raises(ValueError, match="divide over"):
        DeviceAVCCodec(p, n_slices=3, mesh=slots(2))
    codec = DeviceAVCCodec(p, search_range=4, n_slices=3, mesh=slots(3))
    rc = QuadraticRateControl(90_000.0, 30.0, 30, rc_mode=3)
    with pytest.raises(NotImplementedError, match="basic-unit"):
        codec.encode_sequence(banded_frames(2), rate_control=rc)
    stacks = [torch.zeros((1, 4, 4, 64, 80), dtype=torch.uint8),
              torch.zeros((1, 34, 42), dtype=torch.int32),
              torch.zeros((1, 34, 42), dtype=torch.int32)]
    planes = [torch.zeros(s, dtype=torch.int32)
              for s in ((48, 64), (24, 32), (24, 32))]
    with pytest.raises(NotImplementedError, match="WP"):
        DE.make_sharded_encode(slots(3), "slice", mb_h=3, mb_w=4, sr=4,
                               intra_only=False, n_slices=3)(
            *planes, *stacks, 30, 1, torch.zeros((3, 4), dtype=torch.bool),
            torch.zeros((1, 4), dtype=torch.int32))
