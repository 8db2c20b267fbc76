"""The port's loss-aware encoding (``h264tpu_torch/models/errdo.py``) and its
Threefry (``h264tpu_torch/utils/prng.py``) against the JAX package on the
CPU.  Every comparison is exact: random bits and loss masks equal
``jax.random``'s, simulated decoder states are equal integer arrays, and
the float32 drift maps are bit-equal (compared as int32 bit patterns)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from h264tpu.models import errdo as JE
from h264tpu_torch.models import errdo as TE
from h264tpu_torch.utils import prng

SEEDS = (0, 1, 7, 12345, 2 ** 31 - 1, -1)
SHAPES = ((1,), (5,), (3, 4, 7), (8, 18, 22))


def bits_of(a) -> np.ndarray:
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a, np.float32)
    return a.view(np.int32)


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_equals_jax_random(seed):
    key = jax.random.PRNGKey(seed)
    tkey = prng.prng_key(seed)
    assert tuple(np.asarray(key).tolist()) == tkey
    for num in (2, 3, 5):
        assert [list(k) for k in prng.split(tkey, num)] == \
            np.asarray(jax.random.split(key, num)).tolist()
    for shape in SHAPES:
        np.testing.assert_array_equal(
            prng.random_bits(tkey, shape, "cpu").numpy(),
            np.asarray(jax.random.bits(key, shape)).astype(np.int64))
        np.testing.assert_array_equal(
            bits_of(prng.uniform(tkey, shape, "cpu")),
            bits_of(jax.random.uniform(key, shape)))
        for p in (0.0, 0.1, 0.25, 0.5, 1.0):
            np.testing.assert_array_equal(
                prng.bernoulli(tkey, p, shape, "cpu").numpy(),
                np.asarray(jax.random.bernoulli(key, p, shape)))


def frames(n, H, W, seed, noise=3):
    """A moving random texture; ``noise`` 0 gives the raw random planes
    (large errors: per-MB sums past 2^24 exercise the sequential adds)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (H, W)).astype(np.int32)
    out = []
    for t in range(n):
        if noise:
            out.append(np.clip(np.roll(base, t, axis=1)
                               + rng.integers(-noise, noise + 1, (H, W)),
                               0, 255).astype(np.int32))
        else:
            out.append(rng.integers(0, 256, (H, W)).astype(np.int32))
    return out


# (K, p, H, W, seed, frame noise)
SIM_CASES = {"k8_p02": (8, 0.2, 48, 64, 2, 3),
             "k8_p05_large_err": (8, 0.5, 64, 96, 3, 0),
             "k7_p09_large_err": (7, 0.9, 48, 64, 4, 0),
             "k3_p03": (3, 0.3, 48, 64, 4, 3),
             "k5_p0": (5, 0.0, 32, 48, 5, 3)}


@pytest.mark.parametrize("case", list(SIM_CASES))
def test_kdecoder_sim_equals_jax(case, monkeypatch):
    """State and drift after every frame, through an IDR reset midway."""
    K, p, H, W, seed, noise = SIM_CASES[case]
    seq_calls = []
    seq = TE._sequential_sum
    monkeypatch.setattr(TE, "_sequential_sum",
                        lambda terms: seq_calls.append(1) or seq(terms))
    js = JE.KDecoderSim(K, p, H, W, seed=seed)
    ts = TE.KDecoderSim(K, p, H, W, seed=seed, device="cpu")
    fr = frames(6, H, W, seed, noise)
    for i, f in enumerate(fr):
        if i == 3:
            js.reset(f)
            ts.reset(f)
        jd, td = js.step(f), ts.step(f)
        assert td.shape == (H // 16, W // 16) and td.dtype == torch.float32
        np.testing.assert_array_equal(bits_of(td), bits_of(jd))
        np.testing.assert_array_equal(ts.sim.numpy(), np.asarray(js.sim))
        assert ts.key == tuple(np.asarray(js.key).tolist())
        np.testing.assert_array_equal(
            ts.force_intra_mask(td, 1.0).numpy(),
            np.asarray(js.force_intra_mask(jd, 1.0)))
    if noise == 0:
        assert seq_calls              # some MB's error sum passed 2^24


@pytest.mark.parametrize("p,leak", [(0.1, 0.9), (0.03, 0.95), (1 / 3, 0.7)])
def test_multi_hypothesis_drift_equals_jax(p, leak):
    """Expected drift per MB after every frame, with intra MBs, an IDR
    reset from a drifting state, and the recursion's fused multiply-add."""
    H, W = 48, 80
    jm = JE.MultiHypothesisDrift(p, H, W, leak=leak)
    tm = TE.MultiHypothesisDrift(p, H, W, leak=leak, device="cpu")
    rng = np.random.default_rng(6)
    fr = frames(7, H, W, 7, noise=40)
    for i, f in enumerate(fr):
        intra = rng.random((H // 16, W // 16)) < 0.3 if i % 2 else None
        if i == 4:
            jm.reset(f)
            tm.reset(f)
            continue
        jd, td = jm.step(f, intra), tm.step(f, intra)
        np.testing.assert_array_equal(bits_of(td), bits_of(jd))
        np.testing.assert_array_equal(bits_of(tm.exp), bits_of(jm.exp))
        np.testing.assert_array_equal(tm.prev.numpy(), np.asarray(jm.prev))
    np.testing.assert_array_equal(tm.force_intra_mask(td, 50.0).numpy(),
                                  jm.force_intra_mask(jd, 50.0))


def test_mhyp_step_fusion_patterns():
    """The step on its own, from random float32 states: the one fused
    product (p times the concealment sum) that jitted JAX computes."""
    rng = np.random.default_rng(8)
    H, W = 32, 64
    for p, leak in ((0.1, 0.9), (0.25, 0.7), (0.03, 0.95)):
        E = (rng.random((H, W)) * rng.choice([1, 1e2, 1e4], (H, W))
             ).astype(np.float32)
        prev = rng.integers(0, 256, (H, W)).astype(np.int32)
        enc = rng.integers(0, 256, (H, W)).astype(np.int32)
        intra = rng.random((H, W)) < 0.2
        ref = JE._mhyp_step(jnp.asarray(E), jnp.asarray(prev),
                            jnp.asarray(enc), jnp.asarray(intra), p, leak)
        out = TE._mhyp_step(torch.tensor(E), torch.tensor(prev),
                            torch.tensor(enc), torch.tensor(intra), p, leak)
        np.testing.assert_array_equal(bits_of(out), bits_of(ref))


def test_entry_points_need_a_device():
    if torch.cuda.is_available():
        assert TE.KDecoderSim(2, 0.1, 16, 16).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.KDecoderSim(2, 0.1, 16, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.MultiHypothesisDrift(0.1, 16, 16)
