"""The host side of the cross_cells kernel (h264tpu_torch.ops.fractal), on
the CPU: the slot table that maps each position of the (2sr+1)^2 search box
to its index in the caller's offsets, and the wrapper's CPU path."""

import numpy as np
import pytest
import torch

from h264tpu_torch.ops import fractal as TF


@pytest.mark.parametrize("sr", range(1, 17))
def test_offset_slots_every_mode(sr):
    """Every candidate offset of every search mode gets its own slot, at its
    box position; every position outside the candidate set is -1."""
    nd = 2 * sr + 1
    for mode in range(4):
        offsets = TF.candidate_offsets(sr, mode)
        slots = TF.offset_slots(offsets, sr)
        assert slots.dtype == np.int32 and slots.shape == (nd * nd,)
        pos = (offsets[:, 1] + sr) * nd + offsets[:, 0] + sr
        np.testing.assert_array_equal(slots[pos], np.arange(len(offsets)))
        rest = np.ones(nd * nd, bool)
        rest[pos] = False
        assert (slots[rest] == -1).all()
        assert (slots >= 0).sum() == len(offsets)


def test_offset_slots_rejects_bad_offsets():
    with pytest.raises(ValueError):
        TF.offset_slots(np.array([[0, 0], [3, 0]], np.int32), 2)
    with pytest.raises(ValueError):
        TF.offset_slots(np.array([[0, 0], [1, -1], [1, -1]], np.int32), 2)
    np.testing.assert_array_equal(
        TF.offset_slots(np.zeros((0, 2), np.int32), 1), np.full(9, -1))


@pytest.mark.parametrize("mode", range(4))
def test_raster_walk_through_slots_equals_spiral_order(mode):
    """What the kernel does: sums for every box position in raster order,
    each written to its slot, give the plain version's output in the
    caller's (spiral) order."""
    sr, H, W, R = 4, 24, 32, 2
    rng = np.random.default_rng(40 + mode)
    org = torch.as_tensor(rng.integers(0, 256, (H, W)), dtype=torch.int32)
    refs_pad = torch.as_tensor(
        np.pad(rng.integers(0, 256, (R, H, W)), ((0, 0), (sr, sr), (sr, sr))),
        dtype=torch.int32)
    offsets = TF.candidate_offsets(sr, mode)
    slots = TF.offset_slots(offsets, sr)
    dy, dx = np.divmod(np.arange((2 * sr + 1) ** 2), 2 * sr + 1)
    raster = torch.as_tensor(np.stack([dx - sr, dy - sr], 1).astype(np.int32))
    box = TF.cross_cell_sums_reference(org, refs_pad, raster, sr)
    got = torch.empty((R, len(offsets), H // 4, W // 4), dtype=torch.int32)
    for p in np.flatnonzero(slots >= 0):
        got[:, slots[p]] = box[:, p]
    want = TF.cross_cell_sums_reference(org, refs_pad,
                                        torch.as_tensor(offsets), sr)
    assert torch.equal(got, want)


def test_offset_tables_cached_and_cpu_wrapper_ignores_slots():
    sr = 3
    offsets = TF.candidate_offsets(sr, 1)
    offs, slots = TF.offset_tables(offsets, sr, "cpu")
    again = TF.offset_tables(offsets, sr, "cpu")
    assert again[0] is offs and again[1] is slots
    np.testing.assert_array_equal(offs.numpy(), offsets)
    np.testing.assert_array_equal(slots.numpy(), TF.offset_slots(offsets, sr))
    rng = np.random.default_rng(3)
    org = torch.as_tensor(rng.integers(0, 256, (16, 20)), dtype=torch.int32)
    refs_pad = torch.as_tensor(rng.integers(0, 256, (1, 22, 26)),
                               dtype=torch.int32)
    before = TF.cross_cell_sums.launches
    got = TF.cross_cell_sums(org, refs_pad, offs, sr, slots)
    assert TF.cross_cell_sums.launches == before
    assert torch.equal(got, TF.cross_cell_sums_reference(org, refs_pad,
                                                         offs, sr))
