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
    (288, 352, 7, 8, 0),          # CIF luma, two frames (3-view side views)
    (144, 176, 7, 8, 0),          # CIF chroma, two frames (the same)
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


def _fractal_option_stream(name, device):
    """(results, stream, masks) of a short QCIF sequence with one fractal
    codec option."""
    import dataclasses
    frames = _blocky_frames(3, 144, 176)
    cfg = CodecConfig(width=176, height=144, qp=24, intra_period=0,
                      fractal=FractalConfig(search_range=4))
    opts = dict(classic=dict(inter_mode="classic"),
                views3=dict(views=3), region=dict(num_regions=2))
    codec = FractalCodec(dataclasses.replace(cfg, **opts[name]), device=device)
    if name == "views3":
        shifted = [tuple(np.roll(p, 2, axis=1) for p in f) for f in frames]
        res, stream = codec.encode_sequence_views([frames, shifted, frames])
        return res, stream, None
    if name == "region":
        return codec.encode_sequence_region(frames)
    return (*codec.encode_sequence(frames), None)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["classic", "views3", "region"])
def test_fractal_option_card_stream_equals_cpu_stream(name):
    """A fractal codec option's QCIF stream from the card equals the CPU's,
    which the CPU tests hold against the JAX package, and decodes on the
    card to the encoder's reconstruction."""
    _need_card()
    _, s_cpu, _ = _fractal_option_stream(name, "cpu")
    res, s_gpu, masks = _fractal_option_stream(name, "cuda")
    assert s_gpu == s_cpu
    dec = FractalDecoder(device="cuda").decode(s_gpu, masks=masks)
    views = (res, dec) if name != "views3" else (sum(res, []), sum(dec, []))
    for r, planes in zip(*views):
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


# the two High QCIF configurations of chip_smoke.py: every option of the
# slice, and the 8x8 transform alone (whose P slices the C packer writes)
HIGH = {"all": (dict(transform_8x8=True, scaling_matrix="default"), True),
        "t8": (dict(transform_8x8=True), False)}


def _high_codec(name, device):
    from h264tpu_torch.avc.device_codec import DeviceAVCCodec
    from h264tpu_torch.avc.params import AVCParams
    fields, sub8x8 = HIGH[name]
    p = AVCParams(width=176, height=144, qp=28, num_ref_frames=1,
                  profile_idc=100, **fields)
    return DeviceAVCCodec(p, intra_period=0, search_range=8, n_slices=3,
                          sub8x8=sub8x8, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(HIGH))
def test_avc_high_card_stream_equals_cpu_stream(name):
    """The High-profile QCIF stream (3 slices) from the card equals the
    CPU's, which the CPU tests hold against the JAX package."""
    _need_card()
    frames = _blocky_frames(3, 144, 176)
    _, s_cpu = _high_codec(name, "cpu").encode_sequence(frames)
    _, s_gpu = _high_codec(name, "cuda").encode_sequence(frames)
    assert s_gpu == s_cpu


@pytest.mark.gpu
def test_native_stages_equal_twins_on_card_frames():
    """On a P frame encoded on the card, the native deblock and packer give
    the numpy twins' planes and bytes."""
    _need_card()
    from h264tpu_torch.avc import device_enc as DE, native as AN, pack as PK
    from h264tpu_torch.avc.deblock import deblock_frame
    from h264tpu_torch.avc.device_codec import (host_context, host_symbols,
                                                deblock_context)
    from h264tpu_torch.avc.params import SLICE_P
    codec = _high_codec("t8", "cuda")
    p = codec.p
    frames = _blocky_frames(2, 144, 176)
    sym, rec, _ = codec.encode_frame(frames[0], [], 28)
    sym, rec, ctx = codec.encode_frame(
        frames[1], [DE.prep_ref(*rec, codec.sr)], 28)
    sym, (ctx_np, rec_np) = host_symbols(sym), host_context(ctx, rec)
    dctx = deblock_context(ctx_np, p.mb_h, p.mb_w, 28, 0, False)
    for a, b in zip(AN.deblock_frame(*rec_np, dctx),
                    deblock_frame(*rec_np, dctx)):
        np.testing.assert_array_equal(a, b)
    for s in range(3):
        rows = dict(row0=3 * s, n_rows=3)
        assert AN.pack_slice(sym, p, SLICE_P, 28, 1, False, 0, 1, **rows) \
            == PK.pack_p_slice(sym, p, 28, frame_num=1, num_ref=1, **rows)


@pytest.mark.gpu
def test_avc_hierb_cabac_card_stream_equals_cpu_stream():
    """A hierarchical-B CABAC QCIF stream (3 slices, IDR + one GOP of 4)
    from the card equals the CPU's, which the CPU tests hold against the
    JAX package, and decodes to the encoder's reconstruction."""
    _need_card()
    from h264tpu_torch.avc.device_codec import DeviceAVCCodec
    from h264tpu_torch.avc.params import AVCParams
    from h264tpu_torch.avc.slice_dec import AVCDecoder
    p = AVCParams(width=176, height=144, qp=28, profile_idc=77, poc_type=0,
                  num_ref_frames=3, cabac=True)
    frames = _blocky_frames(5, 144, 176)
    out = {dev: DeviceAVCCodec(p, search_range=8, n_slices=3, bframes=3,
                               hierarchical=True,
                               device=dev).encode_sequence(frames)
           for dev in ("cpu", "cuda")}
    res, s_gpu = out["cuda"]
    assert s_gpu == out["cpu"][1]
    assert [r.frame_type for r in res] == ["IDR", "B", "B", "B", "P"]
    for r, planes in zip(res, AVCDecoder().decode(s_gpu)):
        for a, b in zip(r.recon, planes):
            np.testing.assert_array_equal(a, b)


def _fade_frames(n, H, W, seed=0):
    """Blocky frames whose luma rises by 6 a frame (an additive fade)."""
    return [(np.clip(y.astype(np.int64) + 6 * i, 0, 255).astype(np.uint8), u,
             v) for i, (y, u, v) in enumerate(_blocky_frames(n, H, W, seed))]


def _option_codec(name, device):
    """The QCIF codecs of chip_smoke.py's card-vs-CPU phase of the IPPP
    options: explicit WP (LMS), basic-unit rate control, data
    partitioning; 3 slices."""
    from h264tpu_torch.avc.device_codec import DeviceAVCCodec
    from h264tpu_torch.avc.params import AVCParams
    fields = dict(wp_lms=dict(profile_idc=77, weighted_pred=True,
                              num_ref_frames=2),
                  rc_mode3=dict(), dp=dict(profile_idc=88))[name]
    p = AVCParams(width=176, height=144, qp=28, **fields)
    return DeviceAVCCodec(p, search_range=8, n_slices=3,
                          wp_method="lms", data_partitioning=name == "dp",
                          device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["wp_lms", "rc_mode3", "dp"])
def test_avc_option_card_stream_equals_cpu_stream(name):
    """The QCIF streams of the IPPP options from the card equal the CPU's,
    which the CPU tests hold against the JAX package, and decode to the
    encoder's reconstruction; rate control runs one controller per
    device."""
    _need_card()
    from h264tpu_torch.avc.slice_dec import AVCDecoder
    from h264tpu_torch.models.ratectl import QuadraticRateControl
    frames = (_fade_frames if name == "wp_lms" else _blocky_frames)(
        4, 144, 176)
    if name == "rc_mode3":
        for y, _, _ in frames:
            y[:48] = 128                   # a flat top slice
    out = {}
    for dev in ("cpu", "cuda"):
        rc = QuadraticRateControl(300_000.0, 30.0, 28, rc_mode=3) \
            if name == "rc_mode3" else None
        out[dev] = _option_codec(name, dev).encode_sequence(
            frames, rate_control=rc)
    res, s_gpu = out["cuda"]
    assert s_gpu == out["cpu"][1]
    for r, planes in zip(res, AVCDecoder().decode(s_gpu)):
        for a, b in zip(r.recon, planes):
            np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_fvc_native_coders_equal_twins_on_card_levels():
    """The native FVC coders against their Python twins on the levels and
    intra modes of a CIF I and P frame encoded on the card."""
    _need_card()
    from h264tpu_torch.entropy import cabac_eng, cavlc, native as FN
    from h264tpu_torch.entropy import fractal_syntax as FS
    from h264tpu_torch.entropy.bitio import BitReader, BitWriter
    from h264tpu_torch.bitstream import nal
    H, W = 288, 352
    frames = _blocky_frames(2, H, W)
    codec = FractalCodec(CodecConfig(width=W, height=H, qp=24, intra_period=0),
                         device="cuda")
    i_pend = codec.dispatch_frame(frames[0], None, 0)
    i_res, _ = codec.finalize_frame(i_pend)
    p_pend = codec.dispatch_frame(frames[1], i_res.recon_dev, 1)
    _, payload = codec.finalize_frame(p_pend)
    for pend in (i_pend, p_pend):
        for i, (ph, pw) in enumerate(pend["dims"]):
            cy, cx = ph // 4, pw // 4
            zz = pend["host"][f"{i}_zz"].numpy()
            w = BitWriter()
            cavlc.encode_plane(zz, cy, cx, w)
            codes, lens = FN.cavlc_encode_plane(zz, cy, cx)
            wn = BitWriter()
            wn.raw(codes[lens > 0], lens[lens > 0])
            data = w.to_bytes()
            assert wn.to_bytes() == data
            out, pos = FN.cavlc_decode_plane(data, 8 * len(data), 0, cy, cx)
            r = BitReader(data)
            np.testing.assert_array_equal(out, cavlc.decode_plane(r, cy, cx))
            assert pos == r.pos
            cab = FN.cabac_encode_plane(zz, cy, cx)
            assert cab == cabac_eng.encode_plane(zz, cy, cx)
            np.testing.assert_array_equal(FN.cabac_decode_plane(cab, cy, cx),
                                          cabac_eng.decode_plane(cab, cy, cx))
            if pend is i_pend:
                modes = pend["host"][f"{i}_modes"].numpy()
                w = BitWriter()
                FS.write_intra_modes(w, modes)
                np.testing.assert_array_equal(
                    FS.read_intra_modes(BitReader(w.to_bytes()), cy, cx),
                    modes)
    ebsp = nal.ep_insert(payload)
    assert ebsp == nal.ep_insert_python(payload)
    assert nal.ep_strip(ebsp) == nal.ep_strip_python(ebsp) == payload


@pytest.mark.gpu
def test_avc_gop_threads_on_the_card_equal_sequential():
    """Two GOP workers in threads share the card while each captures its
    decision scans' CUDA graphs: the stream equals the sequential one's
    and the CPU's."""
    _need_card()
    import functools
    from h264tpu_torch.models.gop_parallel import GOPEncoder
    from h264tpu_torch.models.gop_workers import device_avc_factory
    frames = _blocky_frames(6, 144, 176)
    out = {}
    for dev, workers in (("cuda", 1), ("cuda", 2), ("cpu", 1)):
        fac = functools.partial(device_avc_factory, 176, 144, 28,
                                n_slices=3, device=dev)
        out[dev, workers] = GOPEncoder(fac, 3).encode(
            frames, workers=workers)[1]
    assert out["cuda", 2] == out["cuda", 1] == out["cpu", 1]


@pytest.mark.gpu
def test_mvc_card_stream_equals_cpu_stream():
    """MVC stereo at QCIF in 3 slices, 3 pairs (the third view-1 picture
    modifies its list): the card's stream equals the CPU's and
    ``decode_mvc`` reproduces both views."""
    _need_card()
    from h264tpu_torch.avc.mvc import MVCStereoCodec
    from h264tpu_torch.avc.params import AVCParams
    from h264tpu_torch.avc.slice_dec import AVCDecoder
    f0 = _blocky_frames(3, 144, 176)
    f1 = [tuple(np.roll(pl, -4, axis=1) for pl in fr) for fr in f0]
    p = AVCParams(width=176, height=144, qp=28, num_ref_frames=2)
    out = {dev: MVCStereoCodec(p, search_range=8, n_slices=3,
                               device=dev).encode_sequence(f0, f1)
           for dev in ("cuda", "cpu")}
    res0, res1, stream = out["cuda"]
    assert stream == out["cpu"][2]
    for dec, res in zip(AVCDecoder().decode_mvc(stream), (res0, res1)):
        for planes, r in zip(dec, res):
            for a, b in zip(planes, r.recon):
                np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_errdo_and_legacy_card_equal_cpu():
    """KDecoderSim and MultiHypothesisDrift (K = 8) and the legacy codec on
    the card give the CPU's states, bit-equal drift and streams."""
    _need_card()
    from h264tpu_torch.models import errdo, legacy_icodec as LIC
    frames = _blocky_frames(4, 144, 176)
    sims = {d: (errdo.KDecoderSim(8, 0.2, 144, 176, seed=3, device=d),
                errdo.MultiHypothesisDrift(0.2, 144, 176, device=d))
            for d in ("cuda", "cpu")}
    for y, _, _ in frames:
        got = [s.step(y).cpu().numpy().view(np.int32) for s in sims["cuda"]]
        want = [s.step(y).numpy().view(np.int32) for s in sims["cpu"]]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sims["cuda"][0].sim.cpu().numpy(),
                                  sims["cpu"][0].sim.numpy())
    y, u, v = frames[0]
    s_gpu = LIC.encode_image(y, u, v, quality=75)
    assert s_gpu == LIC.encode_image(y, u, v, quality=75, device="cpu")
    for a, b in zip(LIC.decode_image(s_gpu),
                    LIC.decode_image(s_gpu, device="cpu")):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("H,W,sr", [
    (32, 352, 7),                 # CIF luma over 9 row tiles
    (16, 176, 7),                 # CIF chroma over 9 row tiles
    (544, 1920, 7)])              # 1080p luma over 2 row tiles
def test_cross_cells_kernel_on_halo_rows(H, W, sr):
    """A row tile's window: the rows above and below are the neighbours'
    pixels (the halo), only the columns are zero-padded; the kernel equals
    its plain version there too."""
    _need_card()
    rng = np.random.default_rng(H + W)
    org = torch.as_tensor(rng.integers(0, 256, (H, W)), dtype=torch.int32).cuda()
    rows = torch.as_tensor(rng.integers(0, 256, (4, H + 2 * sr, W)),
                           dtype=torch.int32).cuda()
    refs_pad = torch.nn.functional.pad(rows, (sr, sr)).contiguous()
    offs, slots = F.offset_tables(F.candidate_offsets(sr, 0), sr, "cuda")
    got = F.cross_cell_sums(org, refs_pad, offs, sr, slots)
    torch.cuda.synchronize()
    assert torch.equal(got, F.cross_cell_sums_reference(org, refs_pad, offs, sr))


@pytest.mark.gpu
def test_sharded_fractal_and_avc_on_a_card_mesh_equal_cpu():
    """FractalCodec over a (1, 3) mesh and DeviceAVCCodec over a 3-slot
    "slice" mesh, every slot on the card: each stream equals the same run
    on a mesh of CPU slots, and the unsharded one."""
    _need_card()
    from h264tpu_torch.parallel import Mesh
    from h264tpu_torch.avc.params import AVCParams
    from h264tpu_torch.avc.device_codec import DeviceAVCCodec
    n = torch.cuda.device_count()
    cards = [torch.device("cuda", i % n) for i in range(3)]
    H, W = 96, 128               # 3 tiles of whole MB rows, chroma too
    frames = _blocky_frames(3, H, W)
    cfg = CodecConfig(width=W, height=H, qp=24, intra_period=0, deblock=True,
                      tile_rows=3, fractal=FractalConfig(search_range=7))
    streams = [FractalCodec(cfg, mesh=Mesh([devs], ("gop", "tile")))
               .encode_sequence(frames)[1]
               for devs in (cards, ["cpu"] * 3)]
    streams.append(FractalCodec(cfg, device="cpu").encode_sequence(frames)[1])
    assert streams[0] == streams[1] == streams[2]
    frames = _blocky_frames(3, 144, 176)
    p = AVCParams(width=176, height=144, qp=28, num_ref_frames=1)
    streams = [DeviceAVCCodec(p, search_range=8, n_slices=3,
                              mesh=Mesh(devs, ("slice",)))
               .encode_sequence(frames)[1] for devs in (cards, ["cpu"] * 3)]
    streams.append(DeviceAVCCodec(p, search_range=8, n_slices=3,
                                  device="cpu").encode_sequence(frames)[1])
    assert streams[0] == streams[1] == streams[2]


@pytest.mark.gpu
def test_cfg_file_entry_path_card_stream_equals_cpu_stream(tmp_path):
    """encoder.cfg + a YUV file on disk -> FractalCodec at QCIF: the card's
    stream equals the CPU's, and the card's launches are the P planes'."""
    _need_card()
    from h264tpu_torch.utils.config import config_from_cfg
    from h264tpu_torch.utils.yuv import YUVReader, YUVWriter
    cfg_path = tmp_path / "encoder.cfg"
    cfg_path.write_text('InputFile = "qcif.yuv"  # a quoted string\n'
                        "ImageWidth = 176\nImageHeight = 144\n"
                        "I_Frame = 0\nFramesToBeEncoded = 4\n"
                        "QPFirstFrame = 24\nQPRemainingFrame = 26\n"
                        "Search_Range = 7\n")
    cfg = config_from_cfg(str(cfg_path))
    yuv = str(tmp_path / "qcif.yuv")
    with YUVWriter(yuv) as w:
        for fr in _blocky_frames(cfg.num_frames, cfg.height, cfg.width):
            w.write(*fr)
    reader = YUVReader(yuv, cfg.width, cfg.height)
    frames = [reader.read(i) for i in range(len(reader))]
    before = F.cross_cell_sums.launches
    res, card = FractalCodec(cfg, device="cuda").encode_sequence(frames)
    torch.cuda.synchronize()
    assert F.cross_cell_sums.launches - before == 3 * (cfg.num_frames - 1)
    _, cpu = FractalCodec(cfg, device="cpu").encode_sequence(frames)
    assert card == cpu
    assert [r.qp for r in res] == [24, 26, 26, 26]


@pytest.mark.gpu
def test_trace_device_spans_resolve_and_name_profile_gaps():
    """With the tracer on, a fractal QCIF 1 I + 2 P encode on the card
    gives every device span a positive device time, the spans' host
    intervals fall inside a ``Profile`` window around the encode, and the
    profile names idle gaps by them."""
    _need_card()
    from h264tpu_torch import trace
    from benchmark.harness.profile import Profile
    cfg = CodecConfig(width=176, height=144, qp=24, intra_period=0,
                      deblock=True, fractal=FractalConfig(search_range=7))
    codec = FractalCodec(cfg, device="cuda")
    frames = _blocky_frames(3, 144, 176)
    codec.encode_sequence(frames)                       # warm
    prof = Profile()
    trace.reset()
    trace.enable()
    try:
        prof.start()
        codec.encode_sequence(frames)
        prof.stop()
    finally:
        trace.disable()
    recs = trace.records()
    spans = [r for r in recs if r["kind"] == "span"]
    device = [r for r in spans if r["device_ms"] is not None]
    assert {r["name"] for r in device} >= {
        "fractal.frame", "fractal.intra", "fractal.search", "fractal.recon",
        "fractal.residual", "fractal.deblock", "fractal.upload"}
    assert all(r["device_ms"] > 0 for r in device)
    assert len([r for r in recs if r["kind"] == "frame"]) == 3
    t0, t1 = prof.window_ns
    intervals = trace.intervals()
    assert intervals and all(t0 <= s <= e <= t1 for _, s, e in intervals)
    summary = prof.summary(2, intervals)
    names = {n for n, _, _ in intervals}
    assert any(label.split(" / ")[0] in names
               for label, _ in summary["idle_gaps"])
    trace.reset()
