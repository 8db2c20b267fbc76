"""A visible size that is not a multiple of 16, coded as the next one with
SPS frame cropping (``AVCParams.cropped``), on the CPU without the JAX
package: the SPS's crop fields, a tiny cropped IPPP encode judged by the
check of the cell ``avc_1080p.clip50`` (``benchmark/systems/
avc_cropped.py``), the port's decoder's crop window, a planted zero pad and
the control over their limits, and the encoders that refuse cropping.

The clip is 48x40 visible, 48x48 coded, in 3 row-band slices; the traffic's
square is cut to 24 pels to move inside it."""

import numpy as np
import pytest
import torch

from benchmark.harness.registry import Registry
from h264tpu_torch.avc import device_codec as DC
from h264tpu_torch.avc.params import AVCParams, write_sps
from h264tpu_torch.avc.slice_dec import AVCDecoder, parse_sps

CELL = "avc_1080p.clip50"
SEED = 3000000019
H, W = 40, 48
N = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("w,h,mbs,crop", [
    (1920, 1080, (120, 68), (0, 0, 0, 4)),
    (48, 40, (3, 3), (0, 0, 0, 4)),
    (50, 44, (4, 3), (0, 7, 0, 2)),
    (1920, 1088, (120, 68), None),
    (176, 144, (11, 9), None)])
def test_sps_codes_whole_macroblocks_and_crops_the_rest(w, h, mbs, crop):
    p = AVCParams(width=w, height=h, level_idc=42)
    assert (p.mb_w, p.mb_h) == mbs
    assert p.cropped == (crop is not None)
    sps = parse_sps(write_sps(p))
    assert (sps["width"], sps["height"]) == (16 * mbs[0], 16 * mbs[1])
    assert sps["crop"] == crop


@pytest.fixture(scope="module")
def cell():
    reg = Registry()
    spec = reg.cell(CELL)
    config = reg.config(spec["config"])
    traffic = dict(reg.traffic(spec["traffic"]), square_size=24)
    frames = reg.generator(traffic["generator"]).make_pool(
        traffic, H, W, SEED)[0][:N]
    settings = dict(config["settings"], width=W, height=H, n_slices=3)
    return reg.system(config["system"]), settings, spec, frames


def _encode(cell, frames):
    system, settings, _, _ = cell
    codec = system.build(settings, "cpu")
    return system.output(*system.encode(codec, iter(frames))), frames


def _check(cell, encoded, control=False):
    system, settings, spec, _ = cell
    out, frames = encoded
    check = dict(spec["check"], frames=len(frames))      # every frame
    return system.check(settings, check, [out], [frames],
                        np.random.default_rng(0), control=control)


@pytest.fixture(scope="module")
def sound(cell):
    return _encode(cell, cell[3])


def test_sound_encode_reads_inside_every_limit(cell, sound):
    out, _ = sound
    assert out["types"] == ["IDR", "P", "P"]
    assert {r[0].shape for r in out["recon"]} == {(H, W)}
    assert {r[0].shape for r in out["coded"]} == {(48, W)}
    got = _check(cell, sound)
    limits = cell[2]["check"]["limits"]
    assert set(got) == set(limits)
    assert got["decode_mismatch_px"] == 0
    assert got["level_band_violations"] == 0
    assert got["motion_gap"] is not None
    for key, limit in limits.items():
        assert got[key] <= limit, (key, got)


def test_port_decoder_outputs_the_crop_window(sound):
    out, _ = sound
    dec = AVCDecoder()
    pictures = dec.decode(out["stream"])
    assert len(pictures) == N
    for got, shown in zip(pictures, out["recon"]):
        assert [pl.shape for pl in got] == [(H, W), (H // 2, W // 2),
                                            (H // 2, W // 2)]
        for a, b in zip(got, shown):
            np.testing.assert_array_equal(a, b)
    # the buffer keeps the coded picture that later frames predict from
    for a, b in zip(dec.dpb[-1]["frame"], out["coded"][-1]):
        np.testing.assert_array_equal(a, b)


def test_control_is_over_its_limit(cell, sound):
    got = _check(cell, sound, control=True)
    assert got["decode_mismatch_px"] > cell[2]["check"]["limits"][
        "decode_mismatch_px"]


def test_zero_pad_is_over_its_limit(cell, monkeypatch):
    """The source padded with zeros in place of its edge: the bottom
    macroblock row's levels leave the band the padded source gives."""
    def zero_pad(pl, h, w):
        out = pl.new_zeros((h, w))
        out[:pl.shape[0], :pl.shape[1]] = pl
        return out

    monkeypatch.setattr(DC, "pad_edge", zero_pad)
    got = _check(cell, _encode(cell, cell[3][:2]))
    assert got["level_band_violations"] > cell[2]["check"]["limits"][
        "level_band_violations"], got
    assert got["decode_mismatch_px"] == 0                # self-consistent


def _refused(kind):
    from h264tpu_torch.avc.codec import AVCCodec
    from h264tpu_torch.avc.mvc import MVCStereoCodec
    from h264tpu_torch.parallel import Mesh
    p = dict(width=W, height=H, level_idc=42)
    if kind == "bframes":
        DC.DeviceAVCCodec(AVCParams(**p, profile_idc=77, poc_type=0,
                                    num_ref_frames=2), bframes=1,
                          device="cpu")
    elif kind == "mesh":
        DC.DeviceAVCCodec(AVCParams(**p), n_slices=3, device="cpu",
                          mesh=Mesh(["cpu"] * 3, ("slice",)))
    elif kind == "wp":
        DC.DeviceAVCCodec(AVCParams(**p, weighted_pred=True), device="cpu")
    elif kind == "basic_unit_rc":
        class _RC:
            rc_mode = 3
        DC.DeviceAVCCodec(AVCParams(**p), n_slices=3, device="cpu") \
            .encode_sequence([], rate_control=_RC())
    elif kind == "mvc":
        MVCStereoCodec(AVCParams(**p), device="cpu")
    elif kind == "host":
        AVCCodec(AVCParams(**p))


@pytest.mark.parametrize("kind", ["bframes", "mesh", "wp", "basic_unit_rc",
                                  "mvc", "host"])
def test_encoders_without_cropping_refuse_it(kind):
    with pytest.raises(NotImplementedError, match="cropping"):
        _refused(kind)
