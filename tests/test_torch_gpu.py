"""Card-only tests of the PyTorch port (marker ``gpu``).

They import neither JAX nor ``h264tpu``, so that they run on a machine with
a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Without a CUDA device each test skips from inside itself.
"""

import numpy as np
import pytest
import torch

from h264tpu_torch.ops import fractal as F
from h264tpu_torch.utils.config import CodecConfig, FractalConfig
from h264tpu_torch.models.fractal_codec import FractalCodec, FractalDecoder


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def _blocky_frames(n, H, W, seed=0):
    rng = np.random.default_rng(seed)
    tex = [np.kron(rng.integers(0, 255, (h // 4, w // 4)),
                   np.ones((4, 4), np.int64)).astype(np.uint8)
           for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    return [tuple(np.roll(t, (i, -i), axis=(0, 1)) for t in tex)
            for i in range(n)]


@pytest.mark.gpu
@pytest.mark.parametrize("H,W,sr,R,mode", [
    (288, 352, 7, 4, 0),          # CIF luma
    (144, 176, 7, 4, 0),          # CIF chroma
    (1088, 1920, 7, 4, 0),        # 1080p luma
    (288, 352, 7, 4, 1),          # search modes 1-3: sparse offsets
    (288, 352, 7, 4, 2),
    (288, 352, 7, 4, 3),
    (288, 352, 16, 4, 0),         # SR 16: dx in groups, a larger window
    (288, 352, 7, 1, 0),          # one reference plane (no half-pel)
    (72, 88, 4, 8, 0),            # ragged tiles
    (36, 44, 2, 1, 0)])
def test_cross_cells_kernel_matches_plain_version(H, W, sr, R, mode):
    """The CUDA kernel equals its plain version exactly and counts one
    launch; ragged tiles (W/4 not a multiple of 32) included."""
    _need_card()
    rng = np.random.default_rng(H + sr + mode)
    org = torch.as_tensor(rng.integers(0, 256, (H, W)), dtype=torch.int32).cuda()
    refs = torch.as_tensor(rng.integers(0, 256, (R, H, W)),
                           dtype=torch.int32).cuda()
    refs_pad = torch.nn.functional.pad(refs, (sr, sr, sr, sr)).contiguous()
    offs, slots = F.offset_tables(F.candidate_offsets(sr, mode), sr, "cuda")
    before = F.cross_cell_sums.launches
    got = F.cross_cell_sums(org, refs_pad, offs, sr, slots)
    torch.cuda.synchronize()
    assert F.cross_cell_sums.launches == before + 1
    assert torch.equal(got, F.cross_cell_sums_reference(org, refs_pad, offs, sr))


@pytest.mark.gpu
def test_cross_cells_rejects_bad_inputs():
    _need_card()
    org = torch.zeros((16, 16), dtype=torch.int32, device="cuda")
    refs_pad = torch.zeros((1, 20, 20), dtype=torch.int32, device="cuda")
    offs, slots = F.offset_tables(F.spiral_offsets(2), 2, "cuda")
    with pytest.raises(ValueError):
        F.cross_cell_sums(org.to(torch.int64), refs_pad, offs, 2, slots)
    with pytest.raises(ValueError):
        F.cross_cell_sums(org, refs_pad, offs, 3, slots)
    with pytest.raises(ValueError):
        F.cross_cell_sums(org, refs_pad, offs, 2)          # no slot table
    with pytest.raises(ValueError):
        F.cross_cell_sums(org, refs_pad, offs, 2, slots[1:].contiguous())


@pytest.mark.gpu
def test_card_stream_equals_cpu_stream_and_decodes():
    """The QCIF stream from the card equals the CPU's and decodes on the
    card to the encoder's reconstruction."""
    _need_card()
    frames = _blocky_frames(3, 144, 176)
    cfg = CodecConfig(width=176, height=144, qp=24, intra_period=0,
                      fractal=FractalConfig(search_range=4))
    _, s_cpu = FractalCodec(cfg, device="cpu").encode_sequence(frames)
    res, s_gpu = FractalCodec(cfg, device="cuda").encode_sequence(frames)
    assert s_gpu == s_cpu
    for r, planes in zip(res, FractalDecoder(device="cuda").decode(s_gpu)):
        for a, b in zip(r.recon, planes):
            np.testing.assert_array_equal(a, b)


def _avc_codec(H, W, n_slices, device):
    from h264tpu_torch.avc.device_codec import DeviceAVCCodec
    from h264tpu_torch.avc.params import AVCParams
    p = AVCParams(width=W, height=H, qp=28, num_ref_frames=1, level_idc=42)
    return DeviceAVCCodec(p, intra_period=0, search_range=8,
                          n_slices=n_slices, device=device)


@pytest.mark.gpu
def test_avc_card_stream_equals_cpu_stream():
    """The conformant encoder's QCIF stream (3 slices) from the card equals
    the CPU's, which the CPU tests hold against the JAX package."""
    _need_card()
    frames = _blocky_frames(3, 144, 176)
    _, s_cpu = _avc_codec(144, 176, 3, "cpu").encode_sequence(frames)
    _, s_gpu = _avc_codec(144, 176, 3, "cuda").encode_sequence(frames)
    assert s_gpu == s_cpu


@pytest.mark.gpu
def test_avc_card_cif_stream_decodes_to_recon():
    """A CIF IDR + P + P stream in 9 slices from the card decodes with the
    port's AVCDecoder to the encoder's reconstruction."""
    _need_card()
    from h264tpu_torch.avc.slice_dec import AVCDecoder
    frames = _blocky_frames(3, 288, 352)
    res, stream = _avc_codec(288, 352, 9, "cuda").encode_sequence(frames)
    assert [r.frame_type for r in res] == ["IDR", "P", "P"]
    for r, planes in zip(res, AVCDecoder().decode(stream)):
        for a, b in zip(r.recon, planes):
            np.testing.assert_array_equal(a, b)
