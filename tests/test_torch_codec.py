"""The PyTorch port's IPPP fractal codec against the JAX package, on the CPU:
byte-identical FVC streams, cross-decoding, carried reference state, import
isolation and device selection."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from h264tpu.utils.config import CodecConfig as JCfg, FractalConfig as JFr
from h264tpu.models.fractal_codec import (FractalCodec as JCodec,
                                          FractalDecoder as JDecoder)
from h264tpu_torch.utils import config as TCfgMod
from h264tpu_torch.utils.config import config_from_dict
from h264tpu_torch.models.fractal_codec import (FractalCodec as TCodec,
                                                FractalDecoder as TDecoder)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def blocky_frames(n, H, W, seed=0):
    """A blocky random texture per plane, shifted one pel per frame."""
    rng = np.random.default_rng(seed)
    tex = [np.kron(rng.integers(0, 255, (h // 4, w // 4)),
                   np.ones((4, 4), np.int64)).astype(np.uint8)
           for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    return [tuple(np.roll(t, (i, -i), axis=(0, 1)) for t in tex)
            for i in range(n)]


def _jax_cfg(H, W):
    return JCfg(width=W, height=H, qp=24, intra_period=0, deblock=True,
                fractal=JFr(search_range=4))


@pytest.fixture(scope="module", params=[(64, 64), (144, 176)],
                ids=["64x64", "144x176"])
def encoded(request):
    H, W = request.param
    frames = blocky_frames(3, H, W)
    jcfg = _jax_cfg(H, W)
    j_res, j_stream = JCodec(jcfg).encode_sequence(frames)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    t_res, t_stream = TCodec(tcfg, device="cpu").encode_sequence(frames)
    return dict(frames=frames, jcfg=jcfg, tcfg=tcfg, j_res=j_res,
                j_stream=j_stream, t_res=t_res, t_stream=t_stream)


def test_stream_byte_identical(encoded):
    assert [r.frame_type for r in encoded["t_res"]] == ["I", "P", "P"]
    assert encoded["t_stream"] == encoded["j_stream"]


def test_recon_bits_and_psnr_match(encoded):
    for j, t in zip(encoded["j_res"], encoded["t_res"]):
        assert (t.frame_type, t.bits, t.qp) == (j.frame_type, j.bits, j.qp)
        for a, b in zip(t.recon, j.recon):
            np.testing.assert_array_equal(a, b)
        # JAX sums the SSE in float32; the port sums it exactly
        for name in ("psnr_y", "psnr_u", "psnr_v"):
            assert abs(getattr(t, name) - getattr(j, name)) < 1e-3


def test_port_decoder_decodes_jax_stream(encoded):
    dec = TDecoder(device="cpu").decode(encoded["j_stream"])
    for r, planes in zip(encoded["j_res"], dec):
        for a, b in zip(r.recon, planes):
            np.testing.assert_array_equal(a, b)


def test_jax_decoder_decodes_port_stream(encoded):
    dec = JDecoder().decode(encoded["t_stream"])
    for r, planes in zip(encoded["t_res"], dec):
        for a, b in zip(r.recon, planes):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_carried_state_p_frame_payload(encoded):
    """JAX frame 0's recon, handed to the port as the reference, gives the
    JAX P-frame payload byte for byte."""
    j0, j1 = encoded["j_res"][:2]
    header = len(encoded["j_stream"]) - sum(r.bits // 8 for r in encoded["j_res"])
    start = header + j0.bits // 8
    want = encoded["j_stream"][start:start + j1.bits // 8]
    codec = TCodec(encoded["tcfg"], device="cpu")
    res, payload = codec.encode_frame(encoded["frames"][1], ref=j0.recon,
                                      frame_idx=1)
    assert res.frame_type == "P"
    assert payload == want


def test_config_from_dict_round_trip():
    jcfg = JCfg(width=176, height=144, qp=30, intra_period=5,
                fractal=JFr(search_range=5, search_mode=3, tol_16=9.0))
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert isinstance(tcfg.fractal.search_mode, TCfgMod.SearchMode)
    assert tcfg.qp_i == 30


def test_import_and_encode_load_no_jax():
    """Importing the port and encoding on the CPU — the IPPP path and every
    option (classic inter, rate control, Annex-B, RTP, CABAC, Exp-Golomb,
    region and 3-view coding), GOP-parallel encoding in threads, the
    loss-aware drift models, the legacy still-image codec, the Huffman
    fractal stream and MVC stereo — loads neither jax nor h264tpu."""
    code = (
        "import dataclasses, sys, numpy as np\n"
        "from h264tpu_torch.utils.config import CodecConfig, FractalConfig\n"
        "from h264tpu_torch.models.fractal_codec import FractalCodec, "
        "FractalDecoder\n"
        "from h264tpu_torch.utils.metrics import frame_metrics\n"
        "cfg = CodecConfig(width=32, height=32, intra_period=0, qp=30,\n"
        "                  fractal=FractalConfig(search_range=2))\n"
        "rng = np.random.default_rng(0)\n"
        "f = [tuple(rng.integers(0, 255, s).astype(np.uint8)\n"
        "           for s in ((32, 32), (16, 16), (16, 16))) for _ in range(3)]\n"
        "def check(res, dec):\n"
        "    assert all((a == b).all() for r, d in zip(res, dec)\n"
        "               for a, b in zip(r.recon, d))\n"
        "for kw in ({}, dict(inter_mode='classic', me_search_range=4),\n"
        "           dict(rate_control=True, target_bitrate=30000.0),\n"
        "           dict(container='annexb'), dict(container='rtp'),\n"
        "           dict(entropy=1), dict(entropy=2)):\n"
        "    c = dataclasses.replace(cfg, **kw)\n"
        "    res, stream = FractalCodec(c, device='cpu').encode_sequence(f)\n"
        "    check(res, FractalDecoder(device='cpu').decode(stream))\n"
        "c = dataclasses.replace(cfg, num_regions=2)\n"
        "res, stream, masks = FractalCodec(c, device='cpu')"
        ".encode_sequence_region(f)\n"
        "check(res, FractalDecoder(device='cpu').decode(stream, masks=masks))\n"
        "c = dataclasses.replace(cfg, views=3)\n"
        "res, stream = FractalCodec(c, device='cpu')"
        ".encode_sequence_views([f, f[::-1], f])\n"
        "dec = FractalDecoder(device='cpu').decode(stream)\n"
        "for v in range(3):\n"
        "    check(res[v], dec[v])\n"
        "assert frame_metrics(f[0], dec[0][0], device='cpu')['psnr_y'] > 10\n"
        "import functools\n"
        "from h264tpu_torch.models.gop_parallel import GOPEncoder\n"
        "from h264tpu_torch.models import gop_workers, errdo\n"
        "from h264tpu_torch.models import legacy_icodec as LIC\n"
        "from h264tpu_torch.entropy import fractal_huffman as FH\n"
        "from h264tpu_torch.avc.mvc import MVCStereoCodec\n"
        "from h264tpu_torch.avc.params import AVCParams\n"
        "from h264tpu_torch.avc.slice_dec import AVCDecoder\n"
        "fac = functools.partial(gop_workers.fractal_factory, 32, 32, 30,\n"
        "                        search_range=2, device='cpu')\n"
        "one = GOPEncoder(fac, 2).encode(f)[1]\n"
        "assert GOPEncoder(fac, 2).encode(f, workers=2)[1] == one\n"
        "sim = errdo.KDecoderSim(4, 0.2, 32, 32, device='cpu')\n"
        "mh = errdo.MultiHypothesisDrift(0.2, 32, 32, device='cpu')\n"
        "for y, _, _ in f:\n"
        "    assert sim.step(y).shape == mh.step(y).shape == (2, 2)\n"
        "s = LIC.encode_image(*f[0], device='cpu')\n"
        "assert LIC.decode_image(s, device='cpu')[0].shape == (32, 32)\n"
        "maps = {k: np.zeros((8, 8), np.int64) for k in\n"
        "        ('shape', 'a', 'beta', 'dx', 'dy', 'ref')}\n"
        "assert FH.decode_maps(FH.encode_maps(maps, 2), 32, 32, 2)\n"
        "p = AVCParams(width=32, height=32, qp=30, num_ref_frames=2)\n"
        "r0, r1, s = MVCStereoCodec(p, search_range=2, device='cpu')"
        ".encode_sequence(f, f[::-1])\n"
        "v0, v1 = AVCDecoder().decode_mvc(s)\n"
        "check(r1, v1)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "'jax.') or m == 'h264tpu' or m.startswith('h264tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_silent_cpu_fallback():
    """With no device given the codec runs on the card or raises."""
    cfg = config_from_dict(dataclasses.asdict(_jax_cfg(64, 64)))
    if torch.cuda.is_available():
        assert TCodec(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TCodec(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            TDecoder()
