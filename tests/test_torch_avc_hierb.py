"""The PyTorch port's hierarchical-B CABAC path against the JAX package, on the
CPU: the dyadic GOP of 4 (anchor P, a reference B at the midpoint dropped
by MMCO at the next anchor, two leaf Bs; QP cascade qp, qp+1, qp+2) under
CABAC in 2 row-band slices, byte for byte against ``TPUAVCCodec``, and both
decoders on the port's stream.  The port reads its frames from a generator,
one GOP ahead; a 7-frame clip ends inside its second GOP (anchors 0, 4 and
6, frame 5 a plain B)."""

import dataclasses

import numpy as np
import pytest
import torch

from h264tpu.avc.codec import AVCCodec
from h264tpu.avc.params import AVCParams as JParams
from h264tpu.avc.tpu_codec import TPUAVCCodec
from h264tpu_torch.avc.device_codec import DeviceAVCCodec
from h264tpu_torch.avc.params import params_from_dict
from h264tpu_torch.avc.slice_dec import AVCDecoder

from test_torch_avc_codec import smooth_frames

# bench.py's avc_cif_hierb_cabac row at 64x64: Main, CABAC, poc_type 0,
# 3 reference frames, SR 8, QP 28, bframes=3 hierarchical
H, W, QP, SR, S, N = 64, 64, 28, 8, 2, 5
JP = JParams(width=W, height=H, qp=QP, profile_idc=77, poc_type=0,
             num_ref_frames=3, cabac=True)
KW = dict(search_range=SR, n_slices=S, bframes=3, hierarchical=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_codec():
    """One JAX codec for both clips, so that they share its compiles."""
    return TPUAVCCodec(JP, **KW)


def _encode(jax_codec, n):
    frames = smooth_frames(n, H, W)
    j_res, j_stream = jax_codec.encode_sequence(frames)
    tp = params_from_dict(dataclasses.asdict(JP))
    codec = DeviceAVCCodec(tp, device="cpu", **KW)
    t_res, t_stream = codec.encode_sequence(f for f in frames)
    return dict(j_res=j_res, j_stream=j_stream, t_res=t_res,
                t_stream=t_stream, host_ms=codec.host_ms)


@pytest.fixture(scope="module")
def encoded(jax_codec):
    return _encode(jax_codec, N)


@pytest.fixture(scope="module")
def encoded7(jax_codec):
    return _encode(jax_codec, 7)


def test_stream_byte_identical(encoded):
    assert [r.frame_type for r in encoded["t_res"]] == [
        "IDR", "B", "B", "B", "P"]
    assert encoded["t_stream"] == encoded["j_stream"]


def test_recon_and_bits_match_per_frame(encoded):
    for j, t in zip(encoded["j_res"], encoded["t_res"]):
        assert (t.frame_type, t.bits, t.psnr_y) == (j.frame_type, j.bits,
                                                    j.psnr_y)
        for a, b in zip(t.recon, j.recon):
            np.testing.assert_array_equal(a, b)


def test_port_decoder_reproduces_recon(encoded):
    dec = AVCDecoder().decode(encoded["t_stream"])
    assert len(dec) == N
    for planes, r in zip(dec, encoded["t_res"]):
        for a, b in zip(planes, r.recon):
            np.testing.assert_array_equal(a, b)


def test_jax_decoder_reproduces_recon(encoded):
    dec, _ = AVCCodec.decode_sequence(encoded["t_stream"])
    assert len(dec) == N
    for planes, r in zip(dec, encoded["t_res"]):
        for a, b in zip(planes, r.recon):
            np.testing.assert_array_equal(a, b)


def test_host_ms_per_frame(encoded):
    """One pack and one deblock time per frame, in decode order."""
    assert len(encoded["host_ms"]["pack"]) == N
    assert len(encoded["host_ms"]["deblock"]) == N
    assert all(ms > 0 for ms in encoded["host_ms"]["pack"])


def test_seven_frames_stream_byte_identical(encoded7):
    assert [r.frame_type for r in encoded7["t_res"]] == [
        "IDR", "B", "B", "B", "P", "B", "P"]
    assert encoded7["t_stream"] == encoded7["j_stream"]
    for j, t in zip(encoded7["j_res"], encoded7["t_res"]):
        assert (t.frame_type, t.bits, t.psnr_y) == (j.frame_type, j.bits,
                                                    j.psnr_y)
        for a, b in zip(t.recon, j.recon):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("decoder", ["port", "jax"])
def test_seven_frames_decoders_reproduce_recon(encoded7, decoder):
    stream = encoded7["t_stream"]
    dec = (AVCDecoder().decode(stream) if decoder == "port"
           else AVCCodec.decode_sequence(stream)[0])
    assert len(dec) == 7
    for planes, r in zip(dec, encoded7["t_res"]):
        for a, b in zip(planes, r.recon):
            np.testing.assert_array_equal(a, b)


def test_reused_plans_give_the_jax_bytes(encoded):
    """A second pass through one codec replays every picture from the
    scan plans that the first made (a load and replays, no eager step) and
    writes ``TPUAVCCodec``'s bytes."""
    from h264tpu_torch import trace
    frames = smooth_frames(N, H, W)
    codec = DeviceAVCCodec(params_from_dict(dataclasses.asdict(JP)),
                           device="cpu", **KW)
    codec.encode_sequence(iter(frames))
    trace.reset()
    trace.enable()
    try:
        _, stream = codec.encode_sequence(iter(frames))
    finally:
        trace.disable()
    names = [r["name"] for r in trace.records() if r["kind"] == "span"]
    trace.reset()
    assert stream == encoded["j_stream"]
    assert names.count("avc.scan.load") == names.count("avc.scan.replay") \
        == N
    assert "avc.scan.eager" not in names
