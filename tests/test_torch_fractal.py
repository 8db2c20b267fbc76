"""Parity of the PyTorch port's fractal engine (h264tpu_torch.ops.fractal)
with the JAX package, on the CPU.  Inputs come from numpy with fixed seeds
and cross between the frameworks as numpy arrays."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from h264tpu.ops import fractal as JF
from h264tpu_torch.ops import fractal as TF


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a, np.int32))


def _planes(seed, shape, n=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, shape).astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("sr,shape", [(3, (32, 48)), (7, (48, 64))])
def test_cross_reference_matches_jax_cross_cell_sums(sr, shape):
    org, ref = _planes(10 + sr, shape)
    offsets = JF.spiral_offsets(sr)
    refs = np.asarray(JF.build_reference_stack(jnp.asarray(ref), True))
    refs_pad = np.pad(refs, ((0, 0), (sr, sr), (sr, sr)))
    got = TF.cross_cell_sums_reference(_t(org), _t(refs_pad), _t(offsets), sr)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (4, len(offsets), shape[0] // 4, shape[1] // 4)
    for r in range(4):
        want = np.asarray(JF.cross_cell_sums(jnp.asarray(org),
                                             jnp.asarray(refs[r]), offsets))
        np.testing.assert_array_equal(got[r].numpy(), want)


def test_cross_reference_matches_pallas_interpret():
    """The port's plain version equals the TPU kernel (interpret mode) pooled
    by 4 columns, as _search_all_shapes pools it (fractal.py:484-487)."""
    H, W, sr = 32, 48, 3
    org, ref = _planes(21, (H, W))
    offsets = JF.spiral_offsets(sr)[:16]
    refs = JF.build_reference_stack(jnp.asarray(ref), True)
    TH = JF._plan_row_tiles(H, W, 16)
    tiles = JF._build_ref_tiles(refs, H, W, sr, 0, TH)
    rows = JF.pallas_cross_rows(jnp.asarray(org), tiles, offsets, H, W, sr, TH,
                                interpret=True)
    want = np.asarray(rows).reshape(4, 16, H // 4, W // 4, 4).sum(-1)
    refs_pad = np.pad(np.asarray(refs), ((0, 0), (sr, sr), (sr, sr)))
    got = TF.cross_cell_sums(_t(org), _t(refs_pad), _t(offsets), sr)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cross_cell_sums_on_cpu_runs_plain_version_uncounted():
    H, W, sr = 16, 16, 2
    org, ref = _planes(3, (H, W))
    offsets = _t(JF.spiral_offsets(sr))
    refs_pad = _t(np.pad(ref[None], ((0, 0), (sr, sr), (sr, sr))))
    before = TF.cross_cell_sums.launches
    got = TF.cross_cell_sums(_t(org), refs_pad, offsets, sr)
    assert TF.cross_cell_sums.launches == before
    np.testing.assert_array_equal(
        got.numpy(),
        TF.cross_cell_sums_reference(_t(org), refs_pad, offsets, sr).numpy())


def test_quan_a_halfpel_and_window_sums():
    x = np.arange(-1000, 1001, dtype=np.int32)
    np.testing.assert_array_equal(TF.quan_a(_t(x)).numpy(),
                                  np.asarray(JF.quan_a(jnp.asarray(x))))
    (ref,) = _planes(5, (24, 40), 1)
    for got, want in zip(TF.halfpel_planes(_t(ref)),
                         JF.halfpel_planes(jnp.asarray(ref))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ii_t = TF.integral_image(_t(ref * ref))
    ii_j = JF.integral_image(jnp.asarray(ref * ref))
    for bh, bw in TF.SHAPES:
        np.testing.assert_array_equal(
            TF.window_sums(ii_t, bh, bw).numpy(),
            np.asarray(JF.window_sums(ii_j, bh, bw)))


def test_window_sums_exact_past_int32_wrap():
    """Σd² over a saturated plane passes 2^31; int64 prefix sums narrowed per
    window give the exact window sums."""
    plane = np.full((320, 352), 255, np.int32)
    ii = TF.integral_image(_t(plane) * _t(plane))
    assert int(ii[-1, -1]) > 2 ** 31
    ws = TF.window_sums(ii, 16, 16)
    assert int(ws[0, 0]) == 255 * 255 * 256
    assert int(ws[-16, -16]) == 255 * 255 * 256


@pytest.mark.parametrize("n", [16, 32, 64, 256])
def test_fit_and_rms_bit_exact(n):
    """a, beta and every rms bit equal the JAX fit as XLA compiles it."""
    rng = np.random.default_rng(n)
    N = 20000
    org = rng.integers(0, 256, (N, n))
    d = rng.integers(0, 256, (N, n))
    half = N // 2
    d[:half] = np.clip(org[:half] * rng.uniform(0, 2, (half, 1))
                       + rng.integers(-30, 30, (half, 1)), 0, 255).astype(int)
    sums = [v.astype(np.int32) for v in (org.sum(1), (org * org).sum(1),
                                         d.sum(1), (d * d).sum(1),
                                         (org * d).sum(1))]
    want = jax.jit(lambda *x: JF.fit_and_rms(n, *x))(*sums)
    got = TF.fit_and_rms(n, *(_t(s) for s in sums))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _assert_trees_equal(t_port, t_jax):
    np.testing.assert_array_equal(t_port.mb_split.numpy(),
                                  np.asarray(t_jax.mb_split))
    np.testing.assert_array_equal(t_port.b8_mode.numpy(),
                                  np.asarray(t_jax.b8_mode))
    for s in ("s16", "s8", "s84", "s48", "s44"):
        a, b = getattr(t_port, s), getattr(t_jax, s)
        for f in ("a", "beta", "dx", "dy", "ref", "s_d"):
            np.testing.assert_array_equal(getattr(a, f).numpy(),
                                          np.asarray(getattr(b, f)))
        np.testing.assert_allclose(a.rms.numpy(), np.asarray(b.rms), rtol=1e-4)


@pytest.fixture(scope="module")
def search_inputs():
    rng = np.random.default_rng(1234)
    org = rng.integers(0, 256, (96, 128)).astype(np.int32)
    ref = rng.integers(0, 256, (96, 128)).astype(np.int32)
    kw = dict(search_range=4, tol16=10.5, tol8=8.0)
    port = TF.search_plane(_t(org), _t(ref), **kw)
    scan = JF.search_plane(jnp.asarray(org), jnp.asarray(ref), impl="scan",
                           **kw)
    return org, ref, kw, port, scan


def test_search_plane_matches_jax_scan(search_inputs):
    """The bar of test_fractal.py::test_search_impls_agree: parameters exact,
    rms within rtol 1e-4, against the lax.scan search."""
    _, _, _, port, scan = search_inputs
    _assert_trees_equal(port, scan)


def test_search_plane_matches_jax_pallas_interpret(search_inputs):
    """The same bar against the search through the Pallas kernel (interpret
    mode)."""
    org, ref, kw, port, _ = search_inputs
    t_pal = JF.search_plane(jnp.asarray(org), jnp.asarray(ref), impl="pallas",
                            interpret=True, cross_chunk=8, **kw)
    _assert_trees_equal(port, t_pal)


def test_search_plane_correlated_content_hex_lattice():
    """Shifted blocky texture (exact matches, ties, split MBs) searched over
    a subsampled (hex) lattice."""
    rng = np.random.default_rng(7)
    tex = np.kron(rng.integers(0, 255, (16, 16)), np.ones((4, 4), int))
    org = np.roll(tex, (1, -2), axis=(0, 1)).astype(np.int32)
    org[:16] = rng.integers(0, 255, (16, 64))
    kw = dict(search_range=4, tol16=10.5, tol8=8.0, search_mode=3)
    t_jax = JF.search_plane(jnp.asarray(org), jnp.asarray(tex), **kw)
    t_port = TF.search_plane(_t(org), _t(tex), **kw)
    _assert_trees_equal(t_port, t_jax)


def test_leaf_maps_and_reconstruct_from_maps(search_inputs):
    org, ref, kw, port, t_jax = search_inputs
    H, W = org.shape
    maps_j = JF.leaf_maps(t_jax, H, W)
    maps_t = TF.leaf_maps(port, H, W)
    for k in maps_j:
        np.testing.assert_array_equal(maps_t[k].numpy(), np.asarray(maps_j[k]))
    np.testing.assert_array_equal(
        TF.reconstruct_from_maps(maps_t, _t(ref), H, W).numpy(),
        np.asarray(JF.reconstruct_from_maps(maps_j, jnp.asarray(ref), H, W)))
    # random leaf parameters exercise negative numerators and every shape
    rng = np.random.default_rng(99)
    cy, cx = H // 4, W // 4
    shape = np.repeat(np.repeat(rng.integers(0, 5, (cy // 4, cx // 4)), 4, 0),
                      4, 1)
    maps = dict(a=rng.integers(-47, 81, (cy, cx)) * 5,
                beta=rng.integers(-12, 52, (cy, cx)) * 5,
                dx=rng.integers(-4, 5, (cy, cx)), dy=rng.integers(-4, 5, (cy, cx)),
                ref=rng.integers(0, 4, (cy, cx)), shape=shape)
    np.testing.assert_array_equal(
        TF.reconstruct_from_maps({k: _t(v) for k, v in maps.items()},
                                 _t(ref), H, W).numpy(),
        np.asarray(JF.reconstruct_from_maps(
            {k: jnp.asarray(v, jnp.int32) for k, v in maps.items()},
            jnp.asarray(ref), H, W)))


def test_chun_correlation_close_to_jax():
    org, ref = _planes(8, (64, 96))
    ref[:16, :16] = org[:16, :16]                   # perfectly correlated MB
    got = TF.chun_correlation(_t(org), _t(ref)).numpy()
    want = np.asarray(JF.chun_correlation(jnp.asarray(org), jnp.asarray(ref)))
    # the port's centred sums are exact; JAX rounds 256 float32 products, so
    # the two agree to float32 precision of the [0, 1] gate value
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[0, 0] == 1.0 and want[0, 0] == 1.0


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_candidate_offsets_match(mode):
    np.testing.assert_array_equal(TF.candidate_offsets(7, mode),
                                  JF.candidate_offsets(7, mode))
