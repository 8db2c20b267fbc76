"""The port's GOP-parallel encoding (``h264tpu_torch/models/gop_parallel.py``
with the factories of ``gop_workers.py``) on the CPU: the threaded,
spawned-process and resumed-from-checkpoint streams are byte-identical to
the sequential stream, and at one tiny size the fractal GOP units equal
the JAX package's ``GOPEncoder`` units byte for byte."""

import functools
import os

import numpy as np
import pytest
import torch

from h264tpu.models import gop_parallel as JGP
from h264tpu.models import gop_workers as JGW
from h264tpu_torch.avc.slice_dec import AVCDecoder
from h264tpu_torch.models import gop_parallel as GP
from h264tpu_torch.models import gop_workers as GW
from h264tpu_torch.models.fractal_codec import FractalDecoder

H, W, QP, N, PERIOD = 32, 32, 30, 6, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frames(n=N, seed=0):
    """A random texture drifting one pel a frame, with noise."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (H + n, W + n))
    out = []
    for t in range(n):
        y = np.clip(base[t:t + H, t:t + W] + rng.integers(-4, 5, (H, W)),
                    0, 255).astype(np.uint8)
        out.append((y, y[::2, ::2].copy(), y[1::2, 1::2].copy()))
    return out


FRACTAL = functools.partial(GW.fractal_factory, W, H, QP, search_range=2,
                            device="cpu")
AVC = functools.partial(GW.device_avc_factory, W, H, QP, search_range=4,
                        device="cpu")


@pytest.fixture(scope="module")
def fractal_sequential():
    return GP.GOPEncoder(FRACTAL, PERIOD).encode(frames())


def test_split_gops_equals_jax():
    for n in (1, 5, 6, 7, 16):
        for period in (-1, 0, 1, 3, 6, 20):
            assert GP.split_gops(n, period) == JGP.split_gops(n, period)


def test_fractal_units_equal_jax(fractal_sequential):
    """Sequential GOP units: each unit's stream, PSNRs and bits equal the
    JAX package's, and the concatenation too."""
    units, stream = fractal_sequential
    jfac = functools.partial(JGW.fractal_cpu_factory, W, H, QP,
                             search_range=2)
    junits, jstream = JGP.GOPEncoder(jfac, PERIOD).encode(frames())
    assert len(units) == len(junits) == 2
    for u, ju in zip(units, junits):
        assert u["stream"] == ju["stream"]
        assert u["bits"] == ju["bits"]
        np.testing.assert_allclose(u["psnr"], ju["psnr"], rtol=1e-12)
    assert stream == jstream


@pytest.mark.parametrize("mode", ["threads", "processes"])
def test_fractal_parallel_equals_sequential(mode, fractal_sequential):
    units, stream = GP.GOPEncoder(FRACTAL, PERIOD).encode(
        frames(), workers=2, processes=mode == "processes")
    assert stream == fractal_sequential[1]
    assert [u["stream"] for u in units] == \
        [u["stream"] for u in fractal_sequential[0]]
    # every unit decodes on its own, starting from its IDR
    dec = FractalDecoder(device="cpu").decode(units[1]["stream"])
    assert len(dec) == PERIOD


def test_resume_from_checkpoint(tmp_path, fractal_sequential):
    ckpt = str(tmp_path / "ckpt")
    GP.GOPEncoder(FRACTAL, PERIOD, checkpoint_dir=ckpt).encode(frames())
    assert sorted(os.listdir(ckpt)) == ["gop_00000.pkl", "gop_00001.pkl"]

    def no_codec():
        raise AssertionError("a checkpointed unit was encoded again")

    # every unit resumes from its checkpoint: no codec is made
    _, stream = GP.GOPEncoder(no_codec, PERIOD,
                              checkpoint_dir=ckpt).encode(frames())
    assert stream == fractal_sequential[1]
    # a restart after unit 0 finished: only unit 1 is encoded
    os.remove(os.path.join(ckpt, "gop_00001.pkl"))
    _, stream = GP.GOPEncoder(FRACTAL, PERIOD, checkpoint_dir=ckpt).encode(
        frames(), workers=2, processes=True)
    assert stream == fractal_sequential[1]


def test_avc_threads_equal_sequential():
    """Annex-B units: the threaded stream keeps one parameter-set prefix
    and equals the sequential one; the decoder reads all frames."""
    fr = frames()
    units, stream = GP.GOPEncoder(AVC, PERIOD).encode(fr)
    t_units, t_stream = GP.GOPEncoder(AVC, PERIOD).encode(fr, workers=2)
    assert t_stream == stream
    assert [u["stream"] for u in t_units] == [u["stream"] for u in units]
    assert stream.count(b"\x00\x00\x00\x01\x67") == 1        # one SPS
    assert sum(len(u["psnr"]) for u in units) == N
    assert len(AVCDecoder().decode(stream)) == N


def test_factories_need_a_device():
    if torch.cuda.is_available():
        assert GW.fractal_factory(W, H, QP).device.type == "cuda"
        return
    for fac in (GW.fractal_factory, GW.device_avc_factory):
        with pytest.raises(RuntimeError, match="CUDA"):
            fac(W, H, QP)
