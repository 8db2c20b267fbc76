"""The PyTorch port's native host stages (``h264tpu_torch/avc/native.py`` over
``csrc/avc_native.cpp``) against their numpy twins and the JAX package's
``avc.native``, on the CPU: slice packing byte for byte, the deblocking
filter plane for plane, a build that fails loudly, and import isolation.
The symbols come from the port's own ``DeviceAVCCodec(device="cpu")``; no
JAX graph runs here."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from h264tpu.avc import native as JN
from h264tpu.avc.params import AVCParams as JParams
from h264tpu_torch import kernels
from h264tpu_torch.avc import device_enc as DE
from h264tpu_torch.avc import native as AN
from h264tpu_torch.avc import pack as PK
from h264tpu_torch.avc.deblock import DeblockContext, deblock_frame
from h264tpu_torch.avc.device_codec import (DeviceAVCCodec, host_context,
                                            host_symbols, deblock_context)
from h264tpu_torch.avc.params import AVCParams, SLICE_I, SLICE_P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QP, SR, SLICES = 28, 4, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n, H, W, seed=7):
    """A smooth texture moving (1, 2) pels a frame with noise on the left
    half, a still right half and a new random block in each frame, so that
    skip, inter and intra MBs all occur."""
    rng = np.random.default_rng(seed)
    big = rng.normal(0, 1, (H + 2 * n, W + 2 * n))
    for _ in range(2):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)) / 3
    big = 128 + big / big.std() * 60
    still = big[:H, :W].copy()
    out = []
    for i in range(n):
        y = big[i:i + H, 2 * i:2 * i + W] + rng.normal(0, 4, (H, W))
        y[:, W // 2:] = still[:, W // 2:]
        y[16:32, :16] = rng.integers(0, 256, (16, 16))
        y = np.clip(y, 0, 255).astype(np.uint8)
        u = np.clip(y[::2, ::2] * 0.4 + 70, 0, 255).astype(np.uint8)
        v = np.clip(200 - y[1::2, 1::2] * 0.3, 0, 255).astype(np.uint8)
        out.append((y, u, v))
    return out


CONFIGS = {"4x4": dict(),
           "8x8": dict(profile_idc=100, transform_8x8=True)}


@pytest.fixture(scope="module", params=list(CONFIGS))
def encoded(request):
    """IDR and P symbols, contexts and (undeblocked) reconstructions of the
    port's encoder at 64x64 in two slices."""
    p = AVCParams(width=64, height=64, qp=QP, **CONFIGS[request.param])
    codec = DeviceAVCCodec(p, search_range=SR, n_slices=SLICES, device="cpu")
    frames = _frames(2, 64, 64)
    out = []
    refs = []
    for i, yuv in enumerate(frames):
        sym, rec, ctx = codec.encode_frame(yuv, refs, QP)
        ctx_np, rec_np = host_context(ctx, rec)
        out.append(dict(sym=host_symbols(sym), ctx=ctx_np, rec=rec_np))
        refs = [DE.prep_ref(*rec, SR)]
    return dict(p=p, name=request.param, frames=out)


def _jax_params(p):
    return JParams(**dataclasses.asdict(p))


@pytest.mark.parametrize("slice_idx", range(SLICES))
@pytest.mark.parametrize("frame", ["IDR", "P"])
def test_native_pack_equals_numpy_and_jax(encoded, frame, slice_idx):
    p = encoded["p"]
    rows = p.mb_h // SLICES
    sym = encoded["frames"][0 if frame == "IDR" else 1]["sym"]
    row = dict(row0=slice_idx * rows, n_rows=rows)
    if frame == "IDR":
        args = (SLICE_I, QP, 0, True, 3, 1)
        want = PK.pack_i_slice(sym, p, QP, frame_num=0, idr=True,
                               idr_pic_id=3, **row)
    else:
        args = (SLICE_P, QP, 1, False, 0, 1)
        want = PK.pack_p_slice(sym, p, QP, frame_num=1, num_ref=1, **row)
    got = AN.pack_slice(sym, p, *args, **row)
    assert got == want
    assert JN.available()
    assert JN.pack_slice(sym, _jax_params(p), *args, **row) == got


@pytest.mark.parametrize("slice_idx", range(SLICES))
def test_native_pack_with_wp_equals_numpy_and_jax(encoded, slice_idx):
    """A P slice under explicit WP: the header's pred_weight_table (two
    references, luma and chroma weights and offsets, negative ones too)."""
    p = dataclasses.replace(encoded["p"], weighted_pred=True)
    rows = p.mb_h // SLICES
    sym = encoded["frames"][1]["sym"]
    wp = dict(d_l=5, d_c=5, l0=[(37, -4, 30, 3, 34, -2),
                                (-6, 11, 33, -1, 31, 2)])
    row = dict(row0=slice_idx * rows, n_rows=rows, wp=wp)
    want = PK.pack_p_slice(sym, p, QP, frame_num=1, num_ref=2, **row)
    got = AN.pack_slice(sym, p, SLICE_P, QP, 1, False, 0, 2, **row)
    assert got == want
    assert JN.pack_slice(sym, _jax_params(p), SLICE_P, QP, 1, False, 0, 2,
                         **row) == got
    assert got != AN.pack_slice(sym, encoded["p"], SLICE_P, QP, 1, False, 0,
                                2, row0=row["row0"], n_rows=rows)


def test_symbols_exercise_every_path(encoded):
    """The P frame holds skip, inter and intra MBs; the 8x8 configuration
    chooses the 8x8 transform somewhere."""
    sym = encoded["frames"][1]["sym"]
    win = sym["win"]
    assert (win == 0).any() and ((win >= 1) & (win <= 4)).any()
    assert ((win == 5) | (win == 6)).any()
    if encoded["name"] == "8x8":
        assert sym["t8"].any()
    else:
        assert "t8" not in sym


@pytest.mark.parametrize("frame", ["IDR", "P"])
def test_native_deblock_equals_numpy(encoded, frame):
    p = encoded["p"]
    f = encoded["frames"][0 if frame == "IDR" else 1]
    ctx = deblock_context(f["ctx"], p.mb_h, p.mb_w, QP, 0, frame == "IDR")
    if frame == "P" and encoded["name"] == "8x8":
        assert ctx.transform8.any()
    got = AN.deblock_frame(*f["rec"], ctx)
    want = deblock_frame(*f["rec"], ctx)
    for a, b in zip(got, want):
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    assert any((a != r).any() for a, r in zip(got, f["rec"]))


@pytest.mark.parametrize("seed", range(4))
def test_native_deblock_equals_numpy_random_context(seed):
    """Random pictures and contexts: intra, inter and 8x8-transform MBs,
    per-MB QPs, filter offsets and a chroma QP offset."""
    rng = np.random.default_rng(seed)
    mb_h, mb_w = 3, 4
    H, W = mb_h * 16, mb_w * 16
    rec = (rng.integers(0, 256, (H, W)), rng.integers(0, 256, (H // 2, W // 2)),
           rng.integers(0, 256, (H // 2, W // 2)))
    rec = tuple((np.round(pl / 24) * 24 + rng.integers(-3, 4, pl.shape))
                .clip(0, 255).astype(np.int64) for pl in rec)
    ctx = DeblockContext(mb_w, mb_h, 30, chroma_qp_offset=seed - 2)
    ctx.mb_qp = rng.integers(20, 45, (mb_h, mb_w))
    ctx.mb_intra = rng.random((mb_h, mb_w)) < 0.3
    ctx.transform8 = rng.random((mb_h, mb_w)) < 0.4
    ctx.nnz = rng.integers(0, 3, (mb_h * 4, mb_w * 4)) * (
        rng.random((mb_h * 4, mb_w * 4)) < 0.5)
    ctx.mv = rng.integers(-9, 10, (mb_h * 4, mb_w * 4, 2))
    ctx.ref = rng.integers(0, 2, (mb_h * 4, mb_w * 4))
    ctx.alpha_off, ctx.beta_off = 2 * (seed % 2), -2 * (seed % 2)
    got = AN.deblock_frame(*rec, ctx)
    for a, b in zip(got, deblock_frame(*rec, ctx)):
        np.testing.assert_array_equal(a, b)


def _tiny_sym():
    mb = 4
    z = np.zeros
    return dict(win=np.full(mb, 6), ri=z(mb), mvd=z((mb, 4, 2)),
                i4flags=z((mb, 16, 2)), i16mode=np.full(mb, 2),
                i16dc=z((mb, 16)), cmode=z(mb), cbp_luma=z(mb),
                cbp_chroma=z(mb), zz=z((mb, 16, 16)), cdc=z((mb, 2, 4)),
                cac=z((mb, 2, 2, 2, 15)))


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(AN, "_lib", None)
    monkeypatch.setattr(AN, "library_path", lambda: tmp_path / "none.so")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        AN.pack_slice(_tiny_sym(), AVCParams(width=32, height=32), SLICE_I,
                      QP, 0, True, 0, 1)
    assert not (tmp_path / "none.so").exists()


def test_failed_build_raises_with_the_log(monkeypatch, tmp_path):
    bad = tmp_path / "avc_native.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(AN, "_lib", None)
    monkeypatch.setattr(AN, "SOURCE", bad)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        AN.deblock_frame(np.zeros((16, 16)), np.zeros((8, 8)),
                         np.zeros((8, 8)), DeblockContext(1, 1, QP))
    assert not AN.library_path().exists()


def test_native_stages_load_no_jax():
    code = (
        "import sys, numpy as np\n"
        "from h264tpu_torch.avc import native as AN\n"
        "from h264tpu_torch.avc.params import AVCParams\n"
        "from h264tpu_torch.avc.deblock import DeblockContext\n"
        "z = np.zeros\n"
        "sym = dict(win=np.full(4, 6), ri=z(4), mvd=z((4, 4, 2)),"
        " i4flags=z((4, 16, 2)), i16mode=np.full(4, 2), i16dc=z((4, 16)),"
        " cmode=z(4), cbp_luma=z(4), cbp_chroma=z(4), zz=z((4, 16, 16)),"
        " cdc=z((4, 2, 4)), cac=z((4, 2, 2, 2, 15)))\n"
        "rb = AN.pack_slice(sym, AVCParams(width=32, height=32), 2, 28, 0,"
        " True, 0, 1)\n"
        "AN.deblock_frame(z((32, 32)), z((16, 16)), z((16, 16)),"
        " DeblockContext(2, 2, 28))\n"
        "assert len(rb) > 4\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'h264tpu' or m.startswith('h264tpu.')]\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout
