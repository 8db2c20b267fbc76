"""The PyTorch port's distortion metrics (h264tpu_torch.utils.metrics)
against the JAX package on the CPU, and against a direct float64 evaluation
of every window.

Tolerance against JAX: rtol 1e-4.  The port sums its integral images in
float64, exactly for integer pixels; the JAX package sums them in float32,
whose prefix sums of squared pixels round once they pass 2^24 (a 64x64 plane
of squares reaches ~2^28), and SSIM's variances subtract two such sums.  On
these inputs the two differ by up to ~3e-5 in SSIM and ~1e-7 in PSNR; the
port's own window sums are held to the direct evaluation at rtol 1e-12."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from h264tpu.utils import metrics as JM
from h264tpu_torch.utils import metrics as TM

RTOL_JAX = 1e-4


def _pair(kind, H=64, W=64, seed=0):
    """(original, reconstruction-like) uint8 planes."""
    rng = np.random.default_rng(seed)
    if kind == "blocky":
        ref = np.kron(rng.integers(16, 240, (H // 8, W // 8)), np.ones((8, 8)))
    elif kind == "smooth":
        big = rng.normal(0, 1, (H, W))
        for _ in range(3):
            big = (big + np.roll(big, 1, 0) + np.roll(big, -1, 0)
                   + np.roll(big, 1, 1) + np.roll(big, -1, 1)) / 5
        ref = 128 + big / big.std() * 50
    else:
        ref = rng.integers(0, 256, (H, W))
    ref = np.clip(ref, 0, 255).astype(np.uint8)
    enc = np.clip(ref.astype(int) + rng.integers(-6, 7, (H, W)), 0,
                  255).astype(np.uint8)
    return ref, enc


KINDS = ["blocky", "smooth", "noise"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ["psnr", "ssim", "ms_ssim"])
def test_metric_matches_jax(name, kind):
    ref, enc = _pair(kind)
    j_fn = getattr(JM, name)
    want = float(j_fn(ref, enc) if name == "ms_ssim"
                 else jax.jit(j_fn)(ref, enc))
    got = getattr(TM, name)(torch.as_tensor(ref), torch.as_tensor(enc))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), want, rtol=RTOL_JAX)


def test_frame_metrics_matches_jax():
    planes = [_pair(k, *s, seed=i) for i, (k, s) in enumerate(
        zip(KINDS, ((64, 64), (32, 32), (32, 32))))]
    ref = tuple(p[0] for p in planes)
    enc = tuple(p[1] for p in planes)
    want = JM.frame_metrics(ref, enc)
    got = TM.frame_metrics(tuple(map(torch.as_tensor, ref)),
                           tuple(map(torch.as_tensor, enc)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL_JAX, err_msg=k)


def _direct_ssim(ref, enc, win=8, step=8):
    """Mean SSIM from every window's moments computed directly."""
    ref, enc = ref.astype(np.float64), enc.astype(np.float64)
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    vals = []
    for y in range(0, ref.shape[0] - win + 1, step):
        for x in range(0, ref.shape[1] - win + 1, step):
            o, e = ref[y:y + win, x:x + win], enc[y:y + win, x:x + win]
            mo, me = o.mean(), e.mean()
            vo, ve = ((o - mo) ** 2).mean(), ((e - me) ** 2).mean()
            cov = ((o - mo) * (e - me)).mean()
            vals.append((2 * mo * me + c1) * (2 * cov + c2)
                        / ((mo * mo + me * me + c1) * (vo + ve + c2)))
    return float(np.mean(vals))


@pytest.mark.parametrize("kind", KINDS)
def test_ssim_exact_window_sums(kind):
    ref, enc = _pair(kind, 144, 176, seed=3)
    got = float(TM.ssim(torch.as_tensor(ref), torch.as_tensor(enc)))
    np.testing.assert_allclose(got, _direct_ssim(ref, enc), rtol=1e-12)


def test_downsample_equals_jax_and_edge_cases():
    """The MS-SSIM downsample is exact in both packages (integers in,
    half-to-even rounding); equal planes give 99.99 dB and SSIM 1."""
    ref, _ = _pair("noise", 40, 56, seed=5)
    np.testing.assert_array_equal(
        TM._downsample(torch.as_tensor(ref, dtype=torch.float64)).numpy(),
        np.asarray(JM._downsample(jnp.asarray(ref))).astype(np.float64))
    t = torch.as_tensor(ref)
    assert float(TM.psnr(t, t)) == 99.99
    assert float(TM.ssim(t, t)) == pytest.approx(1.0, abs=1e-12)
    assert float(TM.ms_ssim(t, t)) == pytest.approx(1.0, abs=1e-12)


def test_device_of_inputs(monkeypatch):
    """Tensors stay on their device; numpy input goes to ``device``, the card
    by default, and with no card and no device given the metrics raise."""
    ref, enc = _pair("blocky", 32, 32, seed=7)
    want = float(TM.psnr(torch.as_tensor(ref), torch.as_tensor(enc)))
    got = TM.psnr(ref, enc, device="cpu")
    assert got.device.type == "cpu" and float(got) == want
    fm = TM.frame_metrics((ref,), (enc,), device="cpu")
    assert fm["psnr_y"] == want
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (TM.psnr, TM.ssim, TM.ms_ssim):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(ref, enc)
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.frame_metrics((ref,), (enc,))
