"""The port's native FVC coders (``h264tpu_torch/entropy/native.py`` over
``csrc/fvc_native.cpp``) against their Python twins and the JAX package's
Python coders, on the CPU: CAVLC and CABAC residual planes (zero, sparse,
dense and large-level blocks), MPM intra-mode resolution, emulation
prevention, the fractal syntax's residual read/write, and the build's
failure modes.  Every comparison is exact (bytes, integer arrays, bit
positions)."""

import numpy as np
import pytest

from h264tpu.entropy import cavlc as JCAVLC
from h264tpu.entropy import cabac_eng as JCABAC
from h264tpu.entropy import fractal_syntax as JFS
from h264tpu.entropy.bitio import BitReader as JBitReader
from h264tpu.entropy.bitio import BitWriter as JBitWriter
from h264tpu.bitstream import nal as JNAL
from h264tpu_torch import kernels
from h264tpu_torch.bitstream import nal as NAL
from h264tpu_torch.entropy import cabac_eng, cavlc
from h264tpu_torch.entropy import fractal_syntax as FS
from h264tpu_torch.entropy import native as FN
from h264tpu_torch.entropy.bitio import BitReader, BitWriter

CY, CX = 6, 11
CASES = ("zero", "sparse", "dense", "large")


def planes(case: str, seed: int = 0):
    """[CY*CX, 16] zig-zag level blocks of one kind."""
    rng = np.random.default_rng(seed)
    shape = (CY * CX, 16)
    if case == "zero":
        return np.zeros(shape, np.int64)
    if case == "sparse":
        return rng.integers(-3, 4, shape) * (rng.random(shape) < 0.3)
    if case == "dense":
        v = rng.integers(1, 21, shape) * rng.choice([-1, 1], shape)
        return v * (rng.random((CY * CX, 1)) < 0.8)       # some empty blocks
    return rng.integers(-40000, 40001, shape)               # escape codes


def native_cavlc_bytes(zz, prefix_bits: int = 0) -> bytes:
    w = BitWriter()
    if prefix_bits:
        w.u(np.ones(prefix_bits, np.int64), 1)
    codes, lens = FN.cavlc_encode_plane(zz, CY, CX)
    w.raw(codes[lens > 0], lens[lens > 0])
    return w.to_bytes()


@pytest.mark.parametrize("case", CASES)
def test_cavlc_encode_equals_python(case):
    zz = planes(case)
    w = BitWriter()
    cavlc.encode_plane(zz, CY, CX, w)
    jw = JBitWriter()
    JCAVLC.encode_plane(zz, CY, CX, jw)
    assert native_cavlc_bytes(zz) == w.to_bytes() == jw.to_bytes()


@pytest.mark.parametrize("case", CASES)
def test_cavlc_decode_equals_python(case):
    """From an unaligned bit position: the same levels and end position."""
    zz = planes(case, seed=1)
    data = native_cavlc_bytes(zz, prefix_bits=5)
    r = BitReader(data)
    r.pos = 5
    ref = cavlc.decode_plane(r, CY, CX)
    out, pos = FN.cavlc_decode_plane(data, len(r._bits), 5, CY, CX)
    np.testing.assert_array_equal(ref, zz)
    np.testing.assert_array_equal(out, zz)
    assert out.dtype == np.int64 and pos == r.pos


@pytest.mark.parametrize("case", CASES)
def test_cabac_equals_python(case):
    zz = planes(case, seed=2)
    payload = FN.cabac_encode_plane(zz, CY, CX)
    assert payload == cabac_eng.encode_plane(zz, CY, CX)
    assert payload == JCABAC.encode_plane(zz, CY, CX)
    out = FN.cabac_decode_plane(payload, CY, CX)
    np.testing.assert_array_equal(out, zz)
    np.testing.assert_array_equal(cabac_eng.decode_plane(payload, CY, CX), zz)


@pytest.mark.parametrize("p_mpm", [0.0, 0.5, 1.0])
def test_resolve_intra_modes_equals_python(p_mpm):
    rng = np.random.default_rng(3)
    use = rng.random((CY, CX)) < p_mpm
    rem = rng.integers(0, 8, int((~use).sum()))
    out = FN.resolve_intra_modes(use, rem, CY, CX)
    np.testing.assert_array_equal(
        out, FS.resolve_intra_modes_python(use, rem, CY, CX))
    assert out.shape == (CY, CX) and out.dtype == np.int64


def test_intra_modes_read_equals_jax():
    rng = np.random.default_rng(4)
    modes = rng.integers(0, 9, (CY, CX))
    w = BitWriter()
    FS.write_intra_modes(w, modes)
    data = w.to_bytes()
    out = FS.read_intra_modes(BitReader(data), CY, CX)
    np.testing.assert_array_equal(
        out, JFS.read_intra_modes(JBitReader(data), CY, CX))
    np.testing.assert_array_equal(out, modes)


def ep_inputs():
    rng = np.random.default_rng(5)
    out = [b"", b"\x00", b"\x00\x00", b"\x00\x00\x00", b"\x00\x00\x03",
           b"\x00\x00\x01\x00\x00\x02\x00\x00\x03\x00\x00\x04",
           bytes(64)]
    for n in (17, 300, 4096):
        # mostly zero bytes with small values: every emulation pattern
        v = rng.integers(0, 5, n) * (rng.random(n) < 0.4)
        out.append(v.astype(np.uint8).tobytes())
    out.append(rng.integers(0, 256, 1000).astype(np.uint8).tobytes())
    return out


def test_emulation_prevention_equals_python():
    for raw in ep_inputs():
        ebsp = NAL.ep_insert(raw)
        assert ebsp == NAL.ep_insert_python(raw) == JNAL.ep_insert(raw)
        assert NAL.ep_strip(ebsp) == NAL.ep_strip_python(ebsp) == raw
        # stripping a stream that holds no emulation bytes
        assert NAL.ep_strip(raw) == NAL.ep_strip_python(raw)


@pytest.mark.parametrize("mode", [FS.ENTROPY_CAVLC, FS.ENTROPY_CABAC])
def test_residual_syntax_equals_jax(mode):
    """``write_residual`` after 3 unaligned bits, then ``read_residual``:
    the JAX package's bytes, and the levels back."""
    zz = planes("sparse", seed=6)
    w, jw = BitWriter(), JBitWriter()
    for wr in (w, jw):
        wr.u(np.array([5]), 3)
    FS.write_residual(w, zz, CY, CX, mode)
    JFS.write_residual(jw, zz, CY, CX, mode)
    data = w.to_bytes()
    assert data == jw.to_bytes()
    r = BitReader(data)
    r.u(3)
    np.testing.assert_array_equal(FS.read_residual(r, CY, CX, mode), zz)


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(FN, "_lib", None)
    monkeypatch.setattr(FN, "library_path", lambda: tmp_path / "none.so")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        NAL.ep_insert(b"\x00\x00\x01")
    assert not (tmp_path / "none.so").exists()


def test_failed_build_raises_with_the_log(monkeypatch, tmp_path):
    bad = tmp_path / "fvc_native.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(FN, "_lib", None)
    monkeypatch.setattr(FN, "SOURCE", bad)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        FN.cabac_encode_plane(np.zeros((4, 16), np.int64), 2, 2)
    assert not FN.library_path().exists()
