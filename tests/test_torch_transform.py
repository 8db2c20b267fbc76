"""Parity of the PyTorch port's transform/quant path
(h264tpu_torch.ops.transform) with the JAX package, on the CPU."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from h264tpu.ops import transform as JT
from h264tpu_torch.ops import transform as TT


def _t(a):
    return torch.as_tensor(np.array(a, np.int32))


@pytest.fixture(scope="module")
def blocks():
    rng = np.random.default_rng(11)
    return rng.integers(-255, 256, (300, 4, 4)).astype(np.int32)


def test_fdct_idct_match(blocks):
    np.testing.assert_array_equal(TT.fdct4x4(_t(blocks)).numpy(),
                                  np.asarray(JT.fdct4x4(jnp.asarray(blocks))))
    w = blocks * 37
    np.testing.assert_array_equal(TT.idct4x4(_t(w)).numpy(),
                                  np.asarray(JT.idct4x4(jnp.asarray(w))))


@pytest.mark.parametrize("qp", [0, 5, 17, 24, 28, 36, 51])
def test_quant_dequant_reconstruct_match(blocks, qp):
    w = np.asarray(JT.fdct4x4(jnp.asarray(blocks)))
    lev_j = np.asarray(JT.quant4x4(jnp.asarray(w), qp))
    lev_t = TT.quant4x4(_t(w), qp)
    np.testing.assert_array_equal(lev_t.numpy(), lev_j)
    deq_j = np.asarray(JT.dequant4x4(jnp.asarray(lev_j), qp))
    np.testing.assert_array_equal(TT.dequant4x4(lev_t, qp).numpy(), deq_j)
    pred = (blocks + 255) // 2
    np.testing.assert_array_equal(
        TT.reconstruct(_t(pred), TT.idct4x4(_t(deq_j))).numpy(),
        np.asarray(JT.reconstruct(jnp.asarray(pred),
                                  JT.idct4x4(jnp.asarray(deq_j)))))


def test_zigzag_and_coeff_cost(blocks):
    lev = np.clip(blocks // 40, -3, 3)
    zz_j = np.asarray(JT.zigzag_scan(jnp.asarray(lev)))
    zz_t = TT.zigzag_scan(_t(lev))
    np.testing.assert_array_equal(zz_t.numpy(), zz_j)
    np.testing.assert_array_equal(TT.zigzag_unscan(zz_t).numpy(), lev)
    np.testing.assert_array_equal(TT.coeff_cost_4x4(zz_t).numpy(),
                                  np.asarray(JT.coeff_cost_4x4(jnp.asarray(zz_j))))


@pytest.mark.parametrize("name,shape", [("hadamard4x4_fwd", (4, 4)),
                                        ("hadamard4x4_inv", (4, 4)),
                                        ("hadamard2x2", (2, 2))])
def test_hadamard_match(name, shape):
    rng = np.random.default_rng(5)
    dc = rng.integers(-4096, 4097, (200,) + shape).astype(np.int32)
    got = getattr(TT, name)(_t(dc))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(getattr(JT, name)(jnp.asarray(dc))))


def test_chroma_qp_all():
    assert [TT.chroma_qp(q) for q in range(52)] == \
        [JT.chroma_qp(q) for q in range(52)]


@pytest.mark.parametrize("qp,luma", [(12, True), (24, True), (24, False),
                                     (40, False)])
def test_residual_code_plane_matches(qp, luma):
    rng = np.random.default_rng(qp + luma)
    org = rng.integers(0, 256, (48, 64))
    pred = np.clip(org + rng.integers(-60, 61, org.shape), 0, 255)
    zz_j, rec_j = JT.residual_code_plane(jnp.asarray(org, jnp.int32),
                                         jnp.asarray(pred, jnp.int32),
                                         qp, False, luma)
    zz_t, rec_t = TT.residual_code_plane(_t(org), _t(pred), qp, luma)
    np.testing.assert_array_equal(zz_t.numpy(), np.asarray(zz_j))
    np.testing.assert_array_equal(rec_t.numpy(), np.asarray(rec_j))
    assert (zz_t != 0).any()


def test_frame_block_roundtrip():
    x = np.arange(24 * 32, dtype=np.int32).reshape(24, 32)
    b = TT.frame_to_blocks(_t(x), 4)
    np.testing.assert_array_equal(b.numpy(),
                                  np.asarray(JT.frame_to_blocks(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(TT.blocks_to_frame(b, 24, 32).numpy(), x)
