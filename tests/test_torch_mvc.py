"""The port's MVC stereo (``h264tpu_torch/avc/mvc.py``, ``AVCDecoder.
decode_mvc``) on the CPU: the subset SPS and NAL-header extension bytes
equal the JAX package's, and both packages' ``decode_mvc`` reproduce both
views of the port's streams exactly, through the inter-view reference and
its list modification (op 5).  The encoder's byte identity with the JAX
``MVCStereoCodec`` is held in ``test_torch_avc_codec.py``
(``test_mvc_stream_equals_jax``), which shares that file's JAX compile."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from h264tpu.avc import mvc as JMVC
from h264tpu.avc.params import AVCParams as JParams
from h264tpu.avc.slice_dec import AVCDecoder as JDecoder
from h264tpu_torch.avc import mvc as MVC
from h264tpu_torch.bitstream.nal import annexb_parse
from h264tpu_torch.avc.params import params_from_dict
from h264tpu_torch.avc.slice_dec import AVCDecoder

from test_torch_avc_codec import smooth_frames


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def params(**kw):
    jp = JParams(**kw)
    return jp, params_from_dict(dataclasses.asdict(jp))


@pytest.mark.parametrize("kw", [
    dict(width=64, height=48, qp=30, num_ref_frames=2),
    dict(width=352, height=288, qp=26, num_ref_frames=3, profile_idc=77),
    dict(width=176, height=144, qp=40, num_ref_frames=2, level_idc=21)],
    ids=["64x48", "cif_main", "qcif_level21"])
def test_subset_sps_equals_jax(kw):
    jp, tp = params(**kw)
    rbsp = MVC.write_subset_sps(tp)
    assert rbsp == JMVC.write_subset_sps(jp)
    assert MVC.parse_subset_sps(rbsp) == JMVC.parse_subset_sps(rbsp)


def test_mvc_ext_bytes_equal_jax():
    for non_idr, anchor, iv, view, prio, temporal in itertools.product(
            (False, True), (False, True), (False, True), (0, 1, 1023),
            (0, 3, 63), (0, 2, 7)):
        b = MVC.mvc_ext_bytes(non_idr, view, anchor, iv, prio, temporal)
        assert b == JMVC.mvc_ext_bytes(non_idr, view, anchor, iv, prio,
                                       temporal)
        assert len(b) == 3
        assert MVC.parse_mvc_ext(b) == JMVC.parse_mvc_ext(b) == dict(
            non_idr=non_idr, priority=prio, view_id=view, temporal=temporal,
            anchor=anchor, inter_view=iv)


@pytest.mark.parametrize("n_slices", [1, 3])
def test_both_decoders_reproduce_both_views(n_slices):
    """Four stereo pairs (view 1 = view 0 shifted 2 pels): the port's and
    the JAX package's ``decode_mvc`` give the encoder's reconstructions;
    pictures 3 and 4 of view 1 carry the inter-view list modification."""
    jp, tp = params(width=64, height=48, qp=30, num_ref_frames=2)
    f0 = smooth_frames(4, 48, 64, seed=n_slices)
    f1 = [tuple(np.roll(pl, -2, axis=1) for pl in fr) for fr in f0]
    res0, res1, stream = MVC.MVCStereoCodec(
        tp, search_range=4, n_slices=n_slices, device="cpu").encode_sequence(
            f0, f1)
    kinds = [n.nal_type for n in annexb_parse(stream)]
    assert kinds.count(MVC.NAL_SLICE_EXT) == 4 * n_slices
    assert kinds.count(MVC.NAL_SUBSET_SPS) == 1
    for views in (AVCDecoder().decode_mvc(stream),
                  JDecoder().decode_mvc(stream)):
        for dec, res in zip(views, (res0, res1)):
            assert len(dec) == 4
            for planes, r in zip(dec, res):
                for a, b in zip(planes, r.recon):
                    np.testing.assert_array_equal(a, b)
    # the base view alone is a plain AVC stream
    base = AVCDecoder().decode(stream)
    for planes, r in zip(base, res0):
        np.testing.assert_array_equal(planes[0], r.recon[0])
    # inter-view prediction engages: the anchor costs far less than the IDR
    assert res1[0].bits < res0[0].bits / 2


def test_refuses_what_the_reference_refuses():
    _, tp = params(width=64, height=48, qp=30, cabac=True, profile_idc=77)
    with pytest.raises(NotImplementedError, match="CAVLC"):
        MVC.MVCStereoCodec(tp, device="cpu")


def test_needs_a_device():
    _, tp = params(width=64, height=48, qp=30, num_ref_frames=2)
    if torch.cuda.is_available():
        assert MVC.MVCStereoCodec(tp).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        MVC.MVCStereoCodec(tp)
