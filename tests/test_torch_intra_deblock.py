"""Parity of the PyTorch port's intra wavefront (h264tpu_torch.ops.intra)
and loop filter (h264tpu_torch.ops.deblock) with the JAX package, on the
CPU."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from h264tpu.ops import intra as JI
from h264tpu.ops import deblock as JD
from h264tpu_torch.ops import intra as TI
from h264tpu_torch.ops import deblock as TD


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a, np.int32))


def test_lambda_penalty_all_qps():
    """All 52 QPs equal JAX's penalty, both as the intra jit traces it and
    eagerly."""
    jitted = jax.jit(JI._lambda_penalty)
    for qp in range(52):
        want = int(jitted(qp))
        assert TI._lambda_penalty(qp) == want == int(JI._lambda_penalty(qp)), qp


def test_predict_modes_all_availabilities():
    rng = np.random.default_rng(3)
    M = 64
    A = rng.integers(0, 256, (M, 9)).astype(np.int32)
    L = rng.integers(0, 256, (M, 4)).astype(np.int32)
    at, al, atr = (rng.integers(0, 2, M).astype(bool) for _ in range(3))
    pj, aj = JI.predict_modes_4x4(jnp.asarray(A), jnp.asarray(L),
                                  jnp.asarray(at), jnp.asarray(al),
                                  jnp.asarray(atr))
    pt, a_t = TI.predict_modes_4x4(_t(A), _t(L), torch.as_tensor(at),
                                   torch.as_tensor(al), torch.as_tensor(atr))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(aj))


@pytest.mark.parametrize("shape,qp", [((32, 48), 24), ((24, 40), 36)])
def test_intra_encode_decode_plane(shape, qp):
    rng = np.random.default_rng(qp)
    org = np.kron(rng.integers(0, 256, (shape[0] // 4, shape[1] // 4)),
                  np.ones((4, 4), int)) + rng.integers(-6, 7, shape)
    org = np.clip(org, 0, 255).astype(np.int32)
    mj, zj, rj = JI.encode_plane(jnp.asarray(org), qp)
    mt, zt, rt = TI.encode_plane(_t(org), qp)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(
        TI.decode_plane(mt, zt, *shape, qp).numpy(), np.asarray(rj))


@pytest.mark.parametrize("luma,groups,qp", [(True, 1, 30), (True, 2, 40),
                                            (False, 1, 36), (False, 2, 45)])
def test_deblock_plane_grouped(luma, groups, qp):
    rng = np.random.default_rng(qp)
    H, W = 32, 48
    plane = np.clip(np.kron(rng.integers(60, 200, (H // 4, W // 4)),
                            np.ones((4, 4), int))
                    + rng.integers(-3, 4, (H, W)), 0, 255).astype(np.int32)
    bs_v = rng.integers(0, 5, (H // 4, W // 4)).astype(np.int32)
    bs_h = rng.integers(0, 5, (H // 4, W // 4)).astype(np.int32)
    want = JD.deblock_plane_grouped(jnp.asarray(plane), jnp.asarray(bs_v),
                                    jnp.asarray(bs_h), qp, luma, groups)
    got = TD.deblock_plane_grouped(_t(plane), _t(bs_v), _t(bs_h), qp, luma,
                                   groups)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), plane)


def test_strengths_match():
    for got, want in zip(TD.strengths_intra(32, 48, "cpu"),
                         JD.strengths_intra(32, 48)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rng = np.random.default_rng(5)
    maps = {k: rng.integers(-1, 2, (8, 12)).astype(np.int32)
            for k in ("dx", "dy", "ref")}
    nz = rng.integers(0, 2, (8, 12)).astype(bool)
    got = TD.strengths_fractal({k: _t(v) for k, v in maps.items()},
                               torch.as_tensor(nz))
    want = JD.strengths_fractal({k: jnp.asarray(v) for k, v in maps.items()},
                                jnp.asarray(nz))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
