"""The PyTorch port's input, configuration and report utilities against the
JAX package's, on the CPU: reference-style ``encoder.cfg`` parsing, YUV
files at every chroma format and bit depth (synthetic files written here),
RGB and TIFF, ``YUVWriter`` / ``pad_to_mb``, the lencod-style report text,
and the cfg-file entry path into the port's ``FractalCodec``."""

import dataclasses
import enum

import numpy as np
import pytest

from h264tpu.utils import config as JCFG
from h264tpu.utils import input as JIN
from h264tpu.utils import report as JREP
from h264tpu.utils import yuv as JYUV
from h264tpu_torch.utils import config as TCFG
from h264tpu_torch.utils import input as TIN
from h264tpu_torch.utils import report as TREP
from h264tpu_torch.utils import yuv as TYUV

# JM/FR syntax: "#" comments (whole-line and trailing), quoted strings,
# floats, keys the codec does not map, and a line without "="
ENCODER_CFG = """\
# encoder.cfg (reference layout)
InputFile             = "foreman_part_qcif.yuv"   # input sequence
ImageWidth            = 64
ImageHeight           = 48      # luma rows
FramesToBeEncoded     = 3
FrameRate             = 25.0
I_Frame               = 0
QPFirstFrame          = 26
QPRemainingFrame      = 30
Search_Range          = 4
Tol_16                = 9.5
Num_Regions           = 1
ProfileIDC            = 66      # not mapped onto CodecConfig
SomethingWithoutValue
"""


def plain(d):
    """``dataclasses.asdict`` output with enum members as their values."""
    if isinstance(d, dict):
        return {k: plain(v) for k, v in d.items()}
    return d.value if isinstance(d, enum.Enum) else d


@pytest.fixture
def cfg_path(tmp_path):
    path = tmp_path / "encoder.cfg"
    path.write_text(ENCODER_CFG)
    return str(path)


def test_parse_cfg_file_equals_jax(cfg_path):
    got = TCFG.parse_cfg_file(cfg_path)
    assert got == JCFG.parse_cfg_file(cfg_path)
    assert got["InputFile"] == "foreman_part_qcif.yuv"
    assert got["ImageHeight"] == 48 and got["FrameRate"] == 25.0
    assert TCFG._REF_KEY_MAP == JCFG._REF_KEY_MAP


@pytest.mark.parametrize("overrides", [{}, dict(qp=22, deblock=False,
                                                intra_period=4)],
                         ids=["cfg", "overrides"])
def test_config_from_cfg_equals_jax(cfg_path, overrides):
    got = TCFG.config_from_cfg(cfg_path, **overrides)
    want = JCFG.config_from_cfg(cfg_path, **overrides)
    assert plain(dataclasses.asdict(got)) == plain(dataclasses.asdict(want))
    assert (got.mbs_x, got.mbs_y, got.num_mbs, got.qp_i) == \
        (want.mbs_x, want.mbs_y, want.num_mbs, want.qp_i) == (4, 3, 12, 26)
    assert got.fractal.search_range == 4 and got.fractal.tol_16 == 9.5


def test_config_from_cfg_validates(tmp_path):
    path = tmp_path / "bad.cfg"
    path.write_text("ImageWidth = 60\nImageHeight = 48\n")
    for mod in (TCFG, JCFG):
        with pytest.raises(ValueError):
            mod.config_from_cfg(str(path))


def write_raw(path, planes, bit_depth):
    dt = np.uint8 if bit_depth <= 8 else np.dtype("<u2")
    with open(path, "ab") as f:
        for p in planes:
            f.write(np.ascontiguousarray(p, dt).tobytes())


@pytest.mark.parametrize("chroma", [420, 422, 444])
@pytest.mark.parametrize("bit_depth", [8, 10])
def test_read_yuv_frame_equals_jax(tmp_path, chroma, bit_depth):
    H, W = 32, 48
    dx, dy = {420: (2, 2), 422: (2, 1), 444: (1, 1)}[chroma]
    rng = np.random.default_rng(chroma + bit_depth)
    path = str(tmp_path / f"seq_{chroma}_{bit_depth}.yuv")
    top = (1 << bit_depth) - 1
    for _ in range(2):
        write_raw(path, [rng.integers(0, top + 1, (H, W)),
                         rng.integers(0, top + 1, (H // dy, W // dx)),
                         rng.integers(0, top + 1, (H // dy, W // dx))],
                  bit_depth)
    assert TIN.frame_bytes(W, H, chroma, bit_depth) == \
        JIN.frame_bytes(W, H, chroma, bit_depth)
    for idx in range(2):
        got = TIN.read_yuv_frame(path, W, H, idx, chroma, bit_depth)
        want = JIN.read_yuv_frame(path, W, H, idx, chroma, bit_depth)
        for g, w_, shape in zip(got, want, [(H, W)] + [(H // 2, W // 2)] * 2):
            assert g.dtype == np.uint8 and g.shape == shape
            np.testing.assert_array_equal(g, w_)


def test_read_yuv_frame_inverts_upsampled_10bit_444(tmp_path):
    """4:2:0 planes written as 10-bit 4:4:4 (chroma repeated 2x2, samples
    shifted left by 2) read back exactly."""
    rng = np.random.default_rng(5)
    y, u, v = (rng.integers(0, 256, s).astype(np.uint8)
               for s in ((32, 48), (16, 24), (16, 24)))
    path = str(tmp_path / "up.yuv")
    write_raw(path, [y.astype(np.int64) << 2] +
              [np.kron(c, np.ones((2, 2), np.int64)) << 2 for c in (u, v)],
              10)
    for got, want in zip(TIN.read_yuv_frame(path, 48, 32, 0, 444, 10),
                         (y, u, v)):
        np.testing.assert_array_equal(got, want)


def test_rgb_yuv_conversions_equal_jax():
    rng = np.random.default_rng(11)
    rgb = rng.integers(0, 256, (32, 48, 3)).astype(np.uint8)
    got, want = TIN.rgb_to_yuv(rgb), JIN.rgb_to_yuv(rgb)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)
    np.testing.assert_array_equal(TIN.yuv_to_rgb(*got), JIN.yuv_to_rgb(*want))
    for chroma in (422, 444):
        plane = rng.integers(0, 256, (32, 48 if chroma == 444 else 24))
        np.testing.assert_array_equal(TIN.chroma_to_420(plane, chroma),
                                      JIN.chroma_to_420(plane, chroma))


@pytest.mark.parametrize("channels", [1, 3], ids=["gray", "rgb"])
def test_tiff_round_trip_equals_jax(tmp_path, channels):
    rng = np.random.default_rng(channels)
    shape = (24, 40) if channels == 1 else (24, 40, 3)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    tp, jp = str(tmp_path / "t.tif"), str(tmp_path / "j.tif")
    TIN.write_tiff(tp, img)
    JIN.write_tiff(jp, img)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    np.testing.assert_array_equal(TIN.read_tiff(jp), img)
    np.testing.assert_array_equal(JIN.read_tiff(tp), img)


def test_yuv_writer_and_pad_to_mb_equal_jax(tmp_path):
    rng = np.random.default_rng(2)
    frames = [tuple(rng.integers(0, 256, s).astype(np.uint8)
                    for s in ((32, 48), (16, 24), (16, 24))) for _ in range(3)]
    tp, jp = str(tmp_path / "t.yuv"), str(tmp_path / "j.yuv")
    with TYUV.YUVWriter(tp) as w:
        for f in frames:
            w.write(*f)
    with JYUV.YUVWriter(jp) as w:
        for f in frames:
            w.write(*f)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    reader = TYUV.YUVReader(tp, 48, 32)
    assert len(reader) == 3
    for i, f in enumerate(frames):
        for got, want in zip(reader.read(i), f):
            np.testing.assert_array_equal(got, want)
    for shape in ((30, 44), (32, 48), (17, 16)):
        plane = rng.integers(0, 256, shape).astype(np.uint8)
        got = TYUV.pad_to_mb(plane)
        np.testing.assert_array_equal(got, JYUV.pad_to_mb(plane))
        assert got.shape[0] % 16 == 0 and got.shape[1] % 16 == 0
    np.testing.assert_array_equal(TYUV.pad_to_mb(plane, 8),
                                  JYUV.pad_to_mb(plane, 8))


@dataclasses.dataclass
class _Row:
    frame_type: str
    psnr_y: float
    psnr_u: float
    psnr_v: float
    bits: int
    qp: int


def test_sequence_report_text_equals_jax(tmp_path):
    rows = [_Row("I", 38.123456, 41.5, 42.25, 40960, 24),
            _Row("P", 36.5, 40.0, 41.0, 6144, 26),
            _Row("P", 35.25, 39.75, 40.5, 5120, 26)]
    reps = []
    for mod in (TREP, JREP):
        rep = mod.SequenceReport(label="cif blocky", frame_rate=25.0,
                                 t_start=100.0)
        for r in rows:
            rep.add(r)
        rep.t_end = 100.75
        reps.append(rep)
    t, j = reps
    assert t.summary() == j.summary()
    assert t.frame_lines() == j.frame_lines()
    assert t.logdat_row() == j.logdat_row()
    assert (t.total_bits, t.avg_psnr_y, t.bitrate_kbps, t.fps) == \
        (j.total_bits, j.avg_psnr_y, j.bitrate_kbps, j.fps)
    tp, jp = str(tmp_path / "t.dat"), str(tmp_path / "j.dat")
    for _ in range(2):
        t.append_logdat(tp)
        j.append_logdat(jp)
    assert open(tp).read() == open(jp).read()
    assert open(tp).read().count("\n") == 3


@pytest.fixture
def one_torch_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cfg_file_entry_path_fractal_codec(cfg_path, tmp_path,
                                           one_torch_thread):
    """encoder.cfg + a YUV file on disk -> the port's FractalCodec on the
    CPU gives the stream of the same frames passed in memory."""
    from h264tpu_torch.models.fractal_codec import FractalCodec, \
        FractalDecoder
    cfg = TCFG.config_from_cfg(cfg_path)
    rng = np.random.default_rng(9)
    base = [np.kron(rng.integers(20, 236, (h // 8, w // 8)),
                    np.ones((8, 8), np.int64))
            for h, w in ((cfg.height, cfg.width),
                         (cfg.height // 2, cfg.width // 2),
                         (cfg.height // 2, cfg.width // 2))]
    frames = [tuple(np.roll(p, (i, -i), (0, 1)).astype(np.uint8)
                    for p in base) for i in range(cfg.num_frames)]
    path = str(tmp_path / "in.yuv")
    with TYUV.YUVWriter(path) as w:
        for f in frames:
            w.write(*f)
    reader = TYUV.YUVReader(path, cfg.width, cfg.height)
    read = [reader.read(i) for i in range(len(reader))]
    res_file, stream_file = FractalCodec(cfg, device="cpu").encode_sequence(
        read)
    res_mem, stream_mem = FractalCodec(cfg, device="cpu").encode_sequence(
        frames)
    assert stream_file == stream_mem
    assert [r.frame_type for r in res_file] == ["I", "P", "P"]
    assert res_file[0].qp == 26 and res_file[1].qp == 30
    decoded = FractalDecoder(device="cpu").decode(stream_file)
    for r, planes in zip(res_file, decoded):
        for c in range(3):
            np.testing.assert_array_equal(planes[c], r.recon[c])
