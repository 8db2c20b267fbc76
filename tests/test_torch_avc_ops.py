"""Parity of the PyTorch port's conformant-encoder building blocks with the
JAX package, on the CPU: quantization, intra prediction, CAVLC bit costs,
quarter-pel interpolation, Exp-Golomb lengths, the lambda table, and the
motion search stages.  Everything is exact."""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from h264tpu.avc import quant_jax as QJ, intra_jax as IJ, cavlc_jax as CJ
from h264tpu.avc import tpu_enc as TE
from h264tpu.ops import me as JME
from h264tpu_torch.avc import quant_dev as QD, intra_dev as ID
from h264tpu_torch.avc import cavlc_dev as CD, device_enc as DE
from h264tpu_torch.ops import me as TME


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=np.int32):
    return torch.as_tensor(np.array(a, dtype))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def coeffs():
    rng = np.random.default_rng(3)
    res = rng.integers(-255, 256, (64, 4, 4)).astype(np.int32)
    return np.asarray(QJ.fdct4x4(jnp.asarray(res)))


# ---------------------------------------------------------------------------
# quant_dev against quant_jax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qp", [0, 28, 51])
@pytest.mark.parametrize("ar", [False, True], ids=["fixed", "adaptive"])
def test_quant_dev_matches_quant_jax(coeffs, qp, ar):
    rng = np.random.default_rng(qp)
    off = rng.integers(0, 1025, (4, 4)).astype(np.int32) if ar else None
    w = coeffs
    for intra in (True, False):
        lev_j = QJ.quant4x4(jnp.asarray(w), qp, intra,
                            offsets=None if off is None else jnp.asarray(off))
        lev_t = QD.quant4x4(_t(w), qp, intra,
                            offsets=None if off is None else _t(off))
        _eq(lev_t, lev_j)
        _eq(QD.ar_fadjust(_t(w), lev_t, qp),
            QJ.ar_fadjust(jnp.asarray(w), lev_j, qp))
        _eq(QD.dequant4x4(lev_t, qp), QJ.dequant4x4(lev_j, qp))
    lev = np.asarray(lev_j)
    _eq(QD.zigzag(_t(lev)), QJ.zigzag(jnp.asarray(lev)))
    zz = np.asarray(QJ.zigzag(jnp.asarray(lev)))
    _eq(QD.unzigzag(_t(zz)), QJ.unzigzag(jnp.asarray(zz)))
    dc = w[:16, 0, 0].reshape(4, 4)
    had = np.asarray(QJ.hadamard4x4_fwd(jnp.asarray(dc)))
    _eq(QD.hadamard4x4_fwd(_t(dc)), had)
    dcl = np.asarray(QJ.quant_dc16(jnp.asarray(had), qp))
    _eq(QD.quant_dc16(_t(had), qp), dcl)
    _eq(QD.dequant_dc16(_t(dcl), qp), QJ.dequant_dc16(jnp.asarray(dcl), qp))
    c2 = w[:8, 0, 0].reshape(2, 2, 2)
    h2 = np.asarray(QJ.hadamard2x2_fwd(jnp.asarray(c2)))
    _eq(QD.hadamard2x2_fwd(_t(c2)), h2)
    qpc = int(QJ.chroma_qp(qp))
    assert QD.chroma_qp(qp) == qpc
    for intra in (True, False):
        cl = np.asarray(QJ.quant_dc_chroma(jnp.asarray(h2), qpc, intra))
        _eq(QD.quant_dc_chroma(_t(h2), qpc, intra), cl)
        _eq(QD.dequant_dc_chroma(_t(cl), qpc),
            QJ.dequant_dc_chroma(jnp.asarray(cl), qpc))


# ---------------------------------------------------------------------------
# intra_dev against intra_jax, every availability combination
# ---------------------------------------------------------------------------

def _avail(n_flags, reps):
    """Every combination of n_flags bools, each repeated ``reps`` times."""
    combos = np.array([[(c >> b) & 1 for b in range(n_flags)]
                       for c in range(1 << n_flags)], bool)
    return np.repeat(combos, reps, axis=0)


def test_intra_dev_matches_intra_jax():
    rng = np.random.default_rng(5)
    fl = _avail(3, 6)                                   # t, l, tr
    n = len(fl)
    top, left = rng.integers(0, 256, (n, 16)), rng.integers(0, 256, (n, 16))
    corner = rng.integers(0, 256, n)
    j = IJ.pred4x4_all(jnp.asarray(top[:, :8]), jnp.asarray(left[:, :4]),
                       jnp.asarray(corner), *(jnp.asarray(fl[:, i])
                                              for i in range(3)))
    t = ID.pred4x4_all(_t(top[:, :8]), _t(left[:, :4]), _t(corner),
                       *(torch.as_tensor(fl[:, i]) for i in range(3)))
    for a, b in zip(t, j):
        _eq(a, b)
    for fn_t, fn_j, k in ((ID.pred16x16_all, IJ.pred16x16_all, 16),
                          (ID.pred_chroma_all, IJ.pred_chroma_all, 8)):
        j = fn_j(jnp.asarray(top[:, :k]), jnp.asarray(left[:, :k]),
                 jnp.asarray(corner), jnp.asarray(fl[:, 0]),
                 jnp.asarray(fl[:, 1]))
        t = fn_t(_t(top[:, :k]), _t(left[:, :k]), _t(corner),
                 torch.as_tensor(fl[:, 0]), torch.as_tensor(fl[:, 1]))
        for a, b in zip(t, j):
            _eq(a, b)


# ---------------------------------------------------------------------------
# cavlc_dev against cavlc_jax
# ---------------------------------------------------------------------------

def _levels(rng, n, m):
    """Sparse scan-order levels: mostly zeros and +-1, some large."""
    mag = rng.choice([0, 0, 0, 1, 1, 2, 3, 5, 9, 17, 40, 300, 2063],
                     size=(n, m))
    return (mag * rng.choice([-1, 1], size=(n, m))).astype(np.int32)


@pytest.mark.parametrize("m,chroma_dc", [(16, False), (15, False),
                                         (4, True)])
def test_cavlc_dev_bits_match_cavlc_jax(m, chroma_dc):
    rng = np.random.default_rng(m)
    zz = _levels(rng, 400, m)
    zz[:40] = 0
    zz[40:80, :] = rng.choice([-1, 1], size=(40, m))
    nc = rng.integers(0, 17, 400).astype(np.int32)
    for fn_t, fn_j in ((CD.block_bits, CJ.block_bits),
                       (CD.block_bits_est, CJ.block_bits_est)):
        _eq(fn_t(_t(zz), _t(nc), m, chroma_dc=chroma_dc),
            fn_j(jnp.asarray(zz), jnp.asarray(nc), m, chroma_dc=chroma_dc))


def test_bitlen_exact_over_int32():
    x = np.array([0, 1, 2, 3, 4, 7, 8, 255, 256, 65535, 65536,
                  2 ** 30, 2 ** 31 - 1, -5], np.int64)
    want = [int(v).bit_length() if v > 0 else 0 for v in x]
    assert CD.bitlen(torch.as_tensor(x.astype(np.int32))).tolist() == want


# ---------------------------------------------------------------------------
# Exp-Golomb lengths and the lambda table
# ---------------------------------------------------------------------------

def test_exp_golomb_bits_match():
    v = np.arange(-300, 301, dtype=np.int32)
    _eq(DE.se_bits(_t(v)), TE.se_bits(jnp.asarray(v)))
    u = np.arange(0, 601, dtype=np.int32)
    _eq(DE.ue_bits(_t(u)), TE.ue_bits(jnp.asarray(u)))
    for n in (1, 2, 3, 5):
        _eq(DE.te_bits(_t(u), n),
            jnp.broadcast_to(TE.te_bits(jnp.asarray(u), n), u.shape))
        _eq(DE.te_bits(_t(u), n),
            TE.te_bits_t(jnp.asarray(u), jnp.int32(n)))


def test_lambda_table_equals_jitted_jax_at_every_qp():
    f = jax.jit(TE.lambdas)
    for qp in range(52):
        lam_j, lme_j = (np.float32(x) for x in f(jnp.int32(qp)))
        lam_t, lme_t = DE.lambdas(qp)
        assert np.float32(lam_t).view(np.int32) == lam_j.view(np.int32), qp
        assert np.float32(lme_t).view(np.int32) == lme_j.view(np.int32), qp


# ---------------------------------------------------------------------------
# quarter-pel planes and the motion search stages
# ---------------------------------------------------------------------------

def test_sixtap_planes_match():
    rng = np.random.default_rng(9)
    plane = rng.integers(0, 256, (24, 40)).astype(np.int32)
    _eq(TME.sixtap_phases(_t(plane)), JME.sixtap_phases(jnp.asarray(plane)))
    _eq(TME.sixtap_halfpel(_t(plane)), JME.sixtap_halfpel(jnp.asarray(plane)))


def _smooth_planes(n, H, W, seed):
    rng = np.random.default_rng(seed)
    big = rng.normal(0, 1, (H + 24, W + 24))
    for _ in range(3):
        big = (big + np.roll(big, 1, 0) + np.roll(big, -1, 0)
               + np.roll(big, 1, 1) + np.roll(big, -1, 1)) / 5
    big = 128 + big / big.std() * 50
    out = [np.clip(big[3 * i:3 * i + H, 2 * i:2 * i + W]
                   + rng.normal(0, 2, (H, W)), 0, 255).astype(np.int32)
           for i in range(n)]
    # frame 0 sits half a pel between two integer positions of the others
    out[0] = (out[0] + np.roll(out[0], 1, 1) + 1) // 2
    return out


@pytest.mark.parametrize("R", [1, 2])
def test_prep_ref_and_search_stages_match(R):
    _check_prep_ref_and_search_stages(R, 4)


@pytest.mark.parametrize("R", [1, 2])
def test_prep_ref_and_search_stages_match_sr8(R):
    """At SR 8, the search range of the bench_avc configuration."""
    _check_prep_ref_and_search_stages(R, 8)


def _check_prep_ref_and_search_stages(R, sr):
    H = W = 64
    qp = 28
    ys = _smooth_planes(R + 1, H, W, R)
    chroma = [p[::2, ::2].copy() for p in ys]
    prep_j = jax.jit(TE.prep_ref, static_argnums=3)
    refs_j = [prep_j(jnp.asarray(y), jnp.asarray(c), jnp.asarray(c), sr)
              for y, c in zip(ys[1:], chroma[1:])]
    for (y, c), rj in zip(zip(ys[1:], chroma[1:]), refs_j):
        for a, b in zip(DE.prep_ref(_t(y), _t(c), _t(c), sr), rj):
            _eq(a, b)
    ups_j = jnp.stack([r[0] for r in refs_j])
    lam_me = jax.jit(TE.lambdas)(jnp.int32(qp))[1]
    search_j = jax.jit(TE._integer_search, static_argnums=2)
    mv_j, sad_j, pmv_j = search_j(jnp.asarray(ys[0]),
                                  ups_j[:, 0, 0].astype(jnp.int32), sr, lam_me)
    ups_t = torch.as_tensor(np.asarray(ups_j))
    lme = DE.lambdas(qp)[1]
    mv_t, sad_t, pmv_t = DE._integer_search(_t(ys[0]),
                                            ups_t[:, 0, 0].to(torch.int32),
                                            sr, lme)
    for a, b in ((mv_t, mv_j), (sad_t, sad_j), (pmv_t, pmv_j)):
        _eq(a, b)
    refine_j = jax.jit(functools.partial(TE._subpel_refine, sr=sr))
    mq_j, dq_j = refine_j(jnp.asarray(ys[0]), ups_j, mv_j, sad_j, pmv_j,
                          lam_me=lam_me)
    mq_t, dq_t = DE._subpel_refine(_t(ys[0]), ups_t, mv_t, pmv_t, sr, lme)
    _eq(mq_t, mq_j)
    _eq(dq_t, dq_j)
    assert (np.asarray(mq_j) % 4 != 0).any()           # sub-pel MVs won
