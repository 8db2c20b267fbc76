"""The ``pan`` generator."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.harness.registry import Registry

REG = Registry()
PARAMS = dict(REG.traffic("pan"), clip_frames=5, pool_clips=2)


def _pool(seed, h=144, w=176):
    return REG.generator("pan").make_pool(PARAMS, h, w, seed)


def test_pan_is_deterministic_for_a_seed():
    a, b = _pool(2147483659), _pool(2147483659)
    for ca, cb in zip(a, b):
        for fa, fb in zip(ca, cb):
            for pa, pb in zip(fa, fb):
                np.testing.assert_array_equal(pa, pb)


@pytest.mark.parametrize("seeds", [(0, 1), (17, 2 ** 31 + 5)])
def test_pan_differs_across_seeds(seeds):
    a, b = (_pool(s) for s in seeds)
    assert not np.array_equal(a[0][0][0], b[0][0][0])


def test_pan_shapes_and_pool():
    pool = _pool(5, 288, 352)
    assert len(pool) == 2 and all(len(c) == 5 for c in pool)
    assert not np.array_equal(pool[0][0][0], pool[1][0][0])
    for y, u, v in pool[0]:
        assert y.shape == (288, 352) and u.shape == v.shape == (144, 176)
        assert y.dtype == u.dtype == v.dtype == np.uint8


def test_pan_frames_differ():
    y0, y1 = (f[0].astype(np.int64) for f in _pool(3, 288, 352)[0][:2])
    assert np.abs(y0 - y1).mean() > 0
