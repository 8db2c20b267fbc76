"""Card-only tests of the PyTorch port (marker ``gpu``).

They import neither JAX nor ``h264tpu``, so that they run on a machine with
a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Without a CUDA device each test skips from inside itself.
"""

import numpy as np
import pytest
import torch

from h264tpu_torch.ops import deblock as DB
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


def _deblock_inputs(H, W, layout, bs_kind, seed):
    """A blocky plane (4x4 cells of one level, a little noise, so that both
    the normal and the strong filter fire) and its strengths, shaped for
    ``layout``: ("grouped", groups) or ("batch", B) planes of [B, H, W]."""
    rng = np.random.default_rng(seed)
    kind, n = layout
    lead = (n,) if kind == "batch" else ()
    tex = np.kron(rng.integers(40, 220, (*lead, H // 4, W // 4)),
                  np.ones((4, 4), np.int64))
    plane = np.clip(tex + rng.integers(-3, 4, tex.shape), 0, 255)
    cells = (*lead, H // 4, W // 4)
    bs = [{"random": rng.integers(0, 5, cells),
           "all4": np.full(cells, 4), "all0": np.zeros(cells, np.int64)}[
        bs_kind] for _ in range(2)]
    return [torch.as_tensor(a, dtype=torch.int32) for a in (plane, *bs)]


@pytest.mark.gpu
@pytest.mark.parametrize("bs_kind", ["random", "all4", "all0"])
@pytest.mark.parametrize("qp", [0, 15, 16, 24, 36, 51])
@pytest.mark.parametrize("H,W,layout", [
    (288, 352, ("grouped", 1)),   # CIF luma
    (288, 352, ("grouped", 2)),
    (288, 352, ("grouped", 9)),
    (288, 352, ("batch", 3)),     # a batch of planes in one deblock_plane
    (144, 176, ("grouped", 1)),   # CIF chroma
    (144, 176, ("grouped", 2)),
    (144, 176, ("grouped", 9)),
    (144, 176, ("batch", 3))])
def test_deblock_kernel_matches_plain_version(H, W, layout, qp, bs_kind):
    """The CUDA kernel pair equals the plain loop (on the CPU) exactly, for
    luma and chroma, row bands and batches, every kind of strength."""
    _need_card()
    plane, bs_v, bs_h = _deblock_inputs(H, W, layout, bs_kind, H + qp)
    for luma in (True, False):
        if layout[0] == "batch":
            want = DB.deblock_plane(plane, bs_v, bs_h, qp, luma)
            got = DB.deblock_plane(plane.cuda(), bs_v.cuda(), bs_h.cuda(), qp,
                                   luma)
        else:
            want = DB.deblock_plane_grouped(plane, bs_v, bs_h, qp, luma,
                                            layout[1])
            got = DB.deblock_plane_grouped(plane.cuda(), bs_v.cuda(),
                                           bs_h.cuda(), qp, luma, layout[1])
        assert got.dtype == torch.int32 and got.shape == plane.shape
        assert torch.equal(got.cpu(), want), (luma, int((got.cpu() != want)
                                                        .sum()))
        if qp >= 16 and bs_kind != "all0":
            assert not torch.equal(want, plane)


@pytest.mark.gpu
def test_deblock_rejects_bad_inputs_and_counts_launches():
    _need_card()
    plane = torch.zeros((16, 16), dtype=torch.int32, device="cuda")
    bs = torch.zeros((4, 4), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        DB.deblock_plane(plane.float(), bs, bs, 30)
    with pytest.raises(ValueError):
        DB.deblock_plane(plane, bs.long(), bs, 30)
    with pytest.raises(ValueError):
        DB.deblock_plane(plane, bs, bs[:3].contiguous(), 30)
    with pytest.raises(ValueError):
        DB.deblock_plane(torch.zeros((16, 18), dtype=torch.int32,
                                     device="cuda"), bs, bs, 30)
    with pytest.raises(ValueError):
        DB.deblock_plane(plane, bs.cpu(), bs, 30)
    before = DB.deblock_plane.launches
    DB.deblock_plane_grouped(plane, bs, bs, 30, True, 2)
    torch.cuda.synchronize()
    assert DB.deblock_plane.launches == before + 2


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


@pytest.mark.gpu
def test_avc_card_cropped_stream_equals_cpu_stream():
    """A 352x280 source, coded as 352x288 with SPS cropping, IDR + P + P in
    9 slices: the card writes the CPU's bytes and reconstructions, coded and
    visible, and the port's decoder outputs the visible ones."""
    _need_card()
    from h264tpu_torch.avc.slice_dec import AVCDecoder
    frames = _blocky_frames(3, 280, 352)
    out = {dev: _avc_codec(280, 352, 9, dev).encode_sequence(frames)
           for dev in ("cpu", "cuda")}
    res, s_gpu = out["cuda"]
    assert s_gpu == out["cpu"][1]
    assert [r.frame_type for r in res] == ["IDR", "P", "P"]
    for r, c in zip(res, out["cpu"][0]):
        assert r.recon[0].shape == (280, 352)
        assert r.coded[0].shape == (288, 352)
        for a, b in zip(r.recon + r.coded, c.recon + c.coded):
            np.testing.assert_array_equal(a, b)
    for r, planes in zip(res, AVCDecoder().decode(s_gpu)):
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


def _hierb_codec(device):
    """chip_smoke.py's hierarchical-B CABAC codec at QCIF: Main, 3 slices,
    one GOP of 4 after the IDR."""
    from h264tpu_torch.avc.device_codec import DeviceAVCCodec
    from h264tpu_torch.avc.params import AVCParams
    p = AVCParams(width=176, height=144, qp=28, profile_idc=77, poc_type=0,
                  num_ref_frames=3, cabac=True)
    return DeviceAVCCodec(p, search_range=8, n_slices=3, bframes=3,
                          hierarchical=True, device=device)


@pytest.mark.gpu
def test_avc_hierb_cabac_card_stream_equals_cpu_stream():
    """A hierarchical-B CABAC QCIF stream (3 slices, IDR + one GOP of 4)
    from the card equals the CPU's, which the CPU tests hold against the
    JAX package, and decodes to the encoder's reconstruction."""
    _need_card()
    from h264tpu_torch.avc.slice_dec import AVCDecoder
    frames = _blocky_frames(5, 144, 176)
    out = {dev: _hierb_codec(dev).encode_sequence(frames)
           for dev in ("cpu", "cuda")}
    res, s_gpu = out["cuda"]
    assert s_gpu == out["cpu"][1]
    assert [r.frame_type for r in res] == ["IDR", "B", "B", "B", "P"]
    for r, planes in zip(res, AVCDecoder().decode(s_gpu)):
        for a, b in zip(r.recon, planes):
            np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["ippp", "hierb"])
def test_avc_scan_plans_captured_once_on_the_card(kind):
    """A QCIF clip (IPPP, or IDR + a hierarchical-B GOP) encoded twice
    through one codec on the card writes the CPU's bytes both times; the
    first pass, on a thread without plans, captures one graph per plan
    key, and the second captures none."""
    _need_card()
    from h264tpu_torch import trace
    from h264tpu_torch.avc import device_enc as DE
    make, n = dict(ippp=(lambda d: _avc_codec(144, 176, 3, d), 4),
                   hierb=(_hierb_codec, 5))[kind]
    frames = _blocky_frames(n, 144, 176)
    _, s_cpu = make("cpu").encode_sequence(frames)
    codec = make("cuda")
    DE.drop_plans()
    passes = []
    try:
        for _ in range(2):
            trace.reset()
            trace.enable()
            _, stream = codec.encode_sequence(frames)
            trace.disable()
            names = [r["name"] for r in trace.records()
                     if r["kind"] == "span"]
            passes.append((stream, names.count("avc.scan.capture"),
                           len(DE._plans())))
    finally:
        trace.disable()
        trace.reset()
    assert [s == s_cpu for s, _, _ in passes] == [True, True]
    (_, captures, keys), (_, again, _) = passes
    assert captures == keys == (2 if kind == "ippp" else 3)
    assert again == 0


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


# ---------------------------------------------------------------------------
# The intra 4x4 sub-scan kernel (csrc/intra4.cu) against its plain version
# ---------------------------------------------------------------------------

def _i4_args(L, mb_w, qps, seed):
    """Random ``_eval_i4`` arguments on the CPU for L lanes: random and
    smooth patches, MBs at column 0, a middle column and mb_w - 1 and at
    rows 0 and after, neighbour modes -2..8 and counts 0..16, adaptive
    rounding offsets at 0, at AR_RANGE and random, and each lane's QP drawn
    from ``qps``."""
    from h264tpu_torch.avc import device_enc as DE, quant_dev as Q
    rng = np.random.default_rng(seed)
    smooth = (np.arange(L) % 2 == 1)[:, None, None]
    base = rng.integers(40, 216, (L, 1, 1))
    patch = np.where(smooth, np.clip(base + rng.integers(-6, 7, (L, 17, 25)),
                                     0, 255), rng.integers(0, 256, (L, 17, 25)))
    org = np.where(smooth, np.clip(base + rng.integers(-9, 10, (L, 16, 16)),
                                   0, 255), rng.integers(0, 256, (L, 16, 16)))
    ar_kind = (np.arange(L) % 3)[:, None, None]
    ar_off = np.where(ar_kind == 0, 0, np.where(
        ar_kind == 1, Q.AR_RANGE, rng.integers(0, Q.AR_RANGE + 1, (L, 4, 4))))
    mbx = np.array([0, mb_w // 2, mb_w - 1])[np.arange(L) % 3]
    mby = np.array([0, 0, 1, 2, 5])[np.arange(L) % 5]
    qp = torch.as_tensor(rng.choice(qps, L), dtype=torch.int32)

    def i32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int32)

    lc = dict(mby=torch.as_tensor(mby, dtype=torch.int64),
              mbx=torch.as_tensor(mbx, dtype=torch.int64))
    nbr = {k: i32(rng.integers(lo, hi, (L, 4))) for k, lo, hi in (
        ("l_nnz", 0, 17), ("t_nnz", 0, 17), ("l_i4m", -2, 9),
        ("t_i4m", -2, 9))}
    return (i32(patch), i32(org), lc, nbr, qp, DE.lane_lambdas(qp)[0], mb_w,
            i32(ar_off))


def _on(x, dev):
    """``x`` with every tensor in it (in tuples and dicts) moved to dev."""
    if isinstance(x, dict):
        return {k: _on(v, dev) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_on(v, dev) for v in x)
    return x.to(dev) if isinstance(x, torch.Tensor) else x


def _i4_tables(name, dev):
    from h264tpu_torch.avc import qmatrix as QM
    if name == "flat":
        return None
    return {k: {m: torch.as_tensor(t).to(dev) for m, t in tabs.items()}
            for k, tabs in QM.enc_tables_default().items()}


@pytest.mark.gpu
@pytest.mark.parametrize("tables", ["flat", "default"])
@pytest.mark.parametrize("L,mb_w,qps", [
    (18, 22, [0]), (18, 22, [12]), (18, 22, [28]), (18, 22, [51]),
    (18, 22, [0, 12, 28, 51, 20, 37]),          # per-lane mixed QPs
    (68, 120, [0, 12, 28, 51, 20, 37])])        # 1080p with 17 slices
def test_intra4_kernel_matches_plain_version(L, mb_w, qps, tables):
    """Every output of the intra 4x4 sub-scan on the card equals the plain
    version's on CPU copies of the same inputs, dtypes included."""
    _need_card()
    from h264tpu_torch.avc import device_enc as DE
    args = _i4_args(L, mb_w, qps, seed=L + len(qps) * 7 + qps[0])
    want = DE._eval_i4(*args, _i4_tables(tables, "cpu"))
    before = DE.intra4.launches
    got = DE._eval_i4(*_on(args, "cuda"), _i4_tables(tables, "cuda"))
    assert DE.intra4.launches == before + 1
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k].cpu(), v), k


@pytest.mark.gpu
def test_intra4_counts_launches_and_rejects_bad_inputs():
    """One launch per call outside a capture; what the kernel does not take
    raises instead of falling back."""
    _need_card()
    from h264tpu_torch.avc import device_enc as DE
    patch, org, lc, nbr, qp, lam, mb_w, ar = _on(_i4_args(4, 5, [28], 0),
                                                 "cuda")
    before = DE.intra4.launches
    for _ in range(3):
        DE._eval_i4(patch, org, lc, nbr, qp, lam, mb_w, ar)
    torch.cuda.synchronize()
    assert DE.intra4.launches == before + 3
    bad = [dict(patch=patch.to(torch.int64)),
           dict(patch=patch[:, :, :24]),
           dict(org=org.transpose(1, 2)),
           dict(qp=qp.cpu()),
           dict(lam=lam.to(torch.float32)),
           dict(ar=ar[:3])]
    for change in bad:
        a = dict(dict(patch=patch, org=org, qp=qp, lam=lam, ar=ar), **change)
        with pytest.raises(ValueError):
            DE._eval_i4(a["patch"], a["org"], lc, nbr, a["qp"], a["lam"],
                        mb_w, a["ar"])
    assert DE.intra4.launches == before + 3


# ---------------------------------------------------------------------------
# The P inter candidates' RD kernel (csrc/inter_rd.cu) against its plain
# version
# ---------------------------------------------------------------------------

def _inter_rd_args(L, mb_w, qps, R, n_valid, tables, wp, sub8x8, seed):
    """Random ``_inter_rd`` arguments on the CPU for one step of L lanes:
    a one-band picture at L 18, 4-row bands at more; each lane's MB in its
    band at column 0, mb_w - 1 or between and at band row 0 or after; a
    band MV field of random cells (refs -2..R-1); MVs small and large
    enough that every MC window hits the band view's clamps; adaptive
    rounding offsets at 0,
    AR_RANGE and between; every fifth lane forced intra; each lane's QP
    from ``qps``; explicit-WP chroma weights with ``wp``; with ``sub8x8``
    the 41 slots of High profile's sub-partitions.  Planes are flat
    around 128 (so that residuals quantize to few levels) or noise."""
    from h264tpu_torch.avc import device_enc as DE, quant_dev as Q
    rng = np.random.default_rng(seed)
    sb_h = L if L <= 18 else 4
    S, sr = L // sb_h, 7
    H, W = S * sb_h * 16, mb_w * 16
    P, PC = DE.luma_pad(sr), DE.chroma_pad(sr)
    lane = np.arange(L)

    def i32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int32)

    def i64(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64)

    def planes(shape):                  # flat (small residuals) or noise
        flat = rng.integers(126, 131, shape, dtype=np.uint8)
        noise = rng.integers(0, 256, shape, dtype=np.uint8)
        return np.where(rng.random(shape[:-2] + (1, 1)) < 0.5, flat, noise)

    ups = torch.as_tensor(planes((R, 4, 4, H + 2 * P, W + 2 * P)))
    us, vs = (i32(planes((R, H // 2 + 2 * PC, W // 2 + 2 * PC)))
              for _ in range(2))
    mby = lane % sb_h
    mbx = np.where(lane % 3 == 0, 0, np.where(
        lane % 3 == 1, mb_w - 1, rng.integers(0, mb_w, L)))
    band = lane // sb_h
    lc = dict(band=i64(band), mby=i64(mby), mbx=i64(mbx), by0=i64(4 * mby),
              bx0=i64(4 * mbx))
    st = dict(mv=i32(rng.integers(-40, 41, (S, sb_h * 4, mb_w * 4, 2))),
              ref=i32(rng.integers(-2, R, (S, sb_h * 4, mb_w * 4))))
    ns = 41 if sub8x8 else 9
    big = rng.random((L, R, ns, 1)) < 0.3
    mv_mb = i32(np.where(big, rng.integers(-900, 901, (L, R, ns, 2)),
                         rng.integers(-24, 25, (L, R, ns, 2))))
    sad_mb = i32(rng.integers(0, 6000, (L, R, ns)))
    org16 = i32(planes((L, 16, 16)))
    org2 = i32(planes((L, 2, 8, 8)))
    ar_kind = (lane % 3)[:, None, None]
    ar_p = i32(np.where(ar_kind == 0, 0, np.where(
        ar_kind == 1, Q.AR_RANGE, rng.integers(0, Q.AR_RANGE + 1, (L, 4, 4)))))
    nbr = dict(l_nnz=i32(rng.integers(0, 17, (L, 4))),
               t_nnz=i32(rng.integers(0, 17, (L, 4))))
    forced = torch.as_tensor(lane % 5 == 4)
    qp = i32(rng.choice(qps, L))
    lam, lam_me = DE.lane_lambdas(qp)
    qpc = i32([Q.chroma_qp(int(q), 0) for q in qp])
    cfg = dict(qp=qp, qpc=qpc, lam=lam, lam_me=lam_me, n_valid=n_valid,
               sub8x8=sub8x8, qm=_i4_tables(tables, "cpu"))
    wp_c = i32(np.stack([rng.integers(1, 128, R), rng.integers(-20, 21, R),
                         rng.integers(1, 128, R), rng.integers(-20, 21, R)],
                        -1)) if wp else None
    fr = DE._frame_view(None, None, ups, us, vs, lc["band"], sr, sb_h, wp_c)
    return st, lc, fr, mv_mb, sad_mb, forced, cfg, org16, org2, nbr, ar_p


def _inter_rd_on(args, dev):
    """``_inter_rd_args`` moved to ``dev``, its frame view rebuilt there."""
    from h264tpu_torch.avc import device_enc as DE
    st, lc, fr, *rest = args
    lc = _on(lc, dev)
    fr = DE._frame_view(None, None, *(fr[k].to(dev) for k in ("ups", "us",
                                                               "vs")),
                        lc["band"], fr["P"] - 4, fr["band_h"] // 16,
                        _on(fr["wp_c"], dev))
    return (_on(st, dev), lc, fr, *(_on(a, dev) for a in rest))


@pytest.mark.gpu
@pytest.mark.parametrize("tables", ["flat", "default"])
@pytest.mark.parametrize("L,mb_w,qps,R,n_valid,wp,sub8x8", [
    (18, 22, [0], 1, 1, False, False),
    (18, 22, [12], 3, 3, False, False),
    (18, 22, [28], 3, 2, True, False),
    (18, 22, [51], 3, 1, False, True),
    (18, 22, [0, 12, 28, 51, 20, 37], 3, 3, True, True),   # per-lane QPs
    (68, 120, [0, 12, 28, 51, 20, 37], 1, 1, False, False),  # 1080p
    (68, 120, [0, 12, 28, 51, 20, 37], 3, 3, True, True)])
def test_inter_rd_kernel_matches_plain_version(L, mb_w, qps, R, n_valid, wp,
                                               sub8x8, tables):
    """Every output of the P inter candidates' RD on the card equals the
    plain version's on CPU copies of the same inputs, dtypes included."""
    _need_card()
    from h264tpu_torch.avc import device_enc as DE
    args = _inter_rd_args(L, mb_w, qps, R, n_valid, tables, wp, sub8x8,
                          seed=L + R * 5 + len(qps) * 7 + qps[0])
    want = DE._inter_rd(*args)
    before = DE.inter_rd.launches
    got = DE._inter_rd(*_inter_rd_on(args, "cuda"))
    assert DE.inter_rd.launches == before + 1
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k].cpu(), v), k


@pytest.mark.gpu
def test_inter_rd_counts_launches_and_rejects_bad_inputs():
    """One launch per call outside a capture; what the kernel does not take
    raises instead of falling back."""
    _need_card()
    from h264tpu_torch.avc import device_enc as DE
    args = _inter_rd_on(_inter_rd_args(4, 5, [28], 2, 2, "flat", False,
                                       False, 0), "cuda")
    st, lc, fr, mv_mb, sad_mb, forced, cfg, org16, org2, nbr, ar_p = args
    before = DE.inter_rd.launches
    for _ in range(3):
        DE._inter_rd(*args)
    torch.cuda.synchronize()
    assert DE.inter_rd.launches == before + 3
    bad = [dict(mv_mb=mv_mb.to(torch.int64)),                  # dtype
           dict(org16=org16[:, :, :15]),                       # shape
           dict(org2=org2.transpose(2, 3)),                    # strides
           dict(ar_p=ar_p.cpu()),                              # device
           dict(sad_mb=sad_mb[:3]),
           dict(forced=forced.to(torch.int32)),
           dict(cfg=dict(cfg, lam=cfg["lam"].to(torch.float32))),
           dict(st=dict(st, ref=st["ref"][:, :-1])),
           dict(fr=dict(fr, us=fr["us"][:, 1:])),
           dict(mv_mb=mv_mb.repeat(1, 9, 1, 1),                # R > 16
                sad_mb=sad_mb.repeat(1, 9, 1))]
    names = ("st", "lc", "fr", "mv_mb", "sad_mb", "forced", "cfg", "org16",
             "org2", "nbr", "ar_p")
    for change in bad:
        a = dict(zip(names, args), **change)
        with pytest.raises(ValueError):
            DE._inter_rd(*(a[n] for n in names))
    assert DE.inter_rd.launches == before + 3


def _picture_inputs(kind, dev):
    """(function, args, kwargs) of one QCIF picture's bands (3 slices) on
    ``dev``: an I picture, a P picture with n_valid 1 or 3 of 3 stacked
    references (MB row 4 forced intra), or a B picture; references and
    colocated motion are made from a moving texture, the same on either
    device."""
    from h264tpu_torch.avc import device_enc as DE
    rng = np.random.default_rng(1)
    big = rng.normal(0, 1, (160, 192))
    for _ in range(3):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)) / 3
    big = 128 + 50 * big / big.std()
    frames = []
    for i in range(4):                  # moving 2 pels a frame, noisy
        y = np.clip(big[2 * i:2 * i + 144, 2 * i:2 * i + 176]
                    + rng.normal(0, 4, (144, 176)), 0, 255).astype(np.uint8)
        frames.append((y, y[::2, ::2] // 2 + 60, 255 - y[1::2, 1::2] // 2))
    sr, S = 4, 3
    y, u, v = (torch.as_tensor(pl).to(torch.int32).to(dev)
               for pl in frames[0])
    refs = [DE.prep_ref(*(torch.as_tensor(pl).to(dev) for pl in f), sr)
            for f in frames[1:]]
    stack = [torch.stack([r[k] for r in refs]) for k in range(3)]
    opts = dict(sr=sr, n_slices=S)
    force = torch.zeros((9, 11), dtype=torch.bool, device=dev)
    force[4] = True                     # an intra MB row inside P slices
    if kind == "I":
        return DE._encode_bands, (y, u, v, *stack, 28, 0, force), dict(
            intra_only=True, sub8x8=False, **opts)
    if kind in ("P1", "P3"):
        return DE._encode_bands, (y, u, v, *stack, 28, int(kind[1]),
                                  force), dict(intra_only=False,
                                               sub8x8=False, **opts)
    col_mv = torch.as_tensor(rng.integers(-9, 10, (36, 44, 2)),
                             dtype=torch.int32).to(dev)
    col_ref = torch.as_tensor(rng.integers(-1, 1, (36, 44)),
                              dtype=torch.int32).to(dev)
    r0 = tuple(x[:1] for x in stack)
    r1 = tuple(x[1:2] for x in stack)
    return DE._encode_bands_b, (y, u, v, r0, r1, col_mv, col_ref, 30, 1, 1), \
        opts


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["I", "P1", "P3", "B"])
def test_avc_picture_symbols_and_band_state_card_equal_cpu(kind):
    """One QCIF picture's decision scan on the card, with the intra 4x4
    kernel in every step's graph (and the inter RD kernel in a P
    picture's), gives the CPU's symbols, reconstruction and band state
    exactly."""
    _need_card()
    out = {}
    for dev in ("cpu", "cuda"):
        fn, args, kw = _picture_inputs(kind, dev)
        sym, st = fn(*args, **kw)
        out[dev] = ({k: x.cpu() for k, x in sym.items()},
                    {k: x.cpu() for k, x in st.items()})
    for want, got in zip(out["cpu"], out["cuda"]):
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.gpu
def test_decide_miss_then_hit_replays_the_same_outputs():
    """``decide`` twice on one shape: the first call misses, runs step 0
    eagerly (each kernel's first launch: intra4 and inter_rd) and captures
    (one more host launch of each, into the graph); the second replays and
    captures nothing, and both give the same outputs."""
    _need_card()
    from h264tpu_torch import trace
    from h264tpu_torch.avc import device_enc as DE
    fn, args, kw = _picture_inputs("P3", "cuda")
    y, u, v, ups, us, vs, qp, n_valid, force = args
    mv_q, sad_q = DE.search(y, ups, kw["sr"], qp, kw["n_slices"])
    DE.drop_plans()
    runs = []
    try:
        for _ in range(2):
            before = (DE.intra4.launches, DE.inter_rd.launches)
            trace.reset()
            trace.enable()
            sym, st = DE.decide(y, u, v, ups, us, vs, mv_q, sad_q, qp,
                                n_valid, force, sr=kw["sr"], sb_h=3,
                                intra_only=False)
            torch.cuda.synchronize()
            trace.disable()
            names = [r["name"] for r in trace.records()
                     if r["kind"] == "span"]
            runs.append((sym, st, names.count("avc.scan.capture"),
                         (DE.intra4.launches - before[0],
                          DE.inter_rd.launches - before[1])))
    finally:
        trace.disable()
        trace.reset()
    (sym0, st0, cap0, n0), (sym1, st1, cap1, n1) = runs
    assert (cap0, n0) == (1, (2, 2))
    assert (cap1, n1) == (0, (0, 0))
    for a, b in ((sym0, sym1), (st0, st1)):
        assert set(a) == set(b)
        assert all(torch.equal(a[k], b[k]) for k in a)
