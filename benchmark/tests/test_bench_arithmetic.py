"""The arithmetic of the metrics on fixed inputs."""

from __future__ import annotations

import importlib.util

import numpy as np
import pytest

from benchmark.harness import roofline, stats
from benchmark.harness.profile import summarise
from benchmark.harness.registry import Registry
from conftest import ROOT

REG = Registry()


def _rec(**kw):
    rec = dict(frame_ms=[], window_s=1.0, types=[], spans={}, counters={},
               profile=None, setup_s=0.0,
               settings=REG.config("fractal_cif")["settings"])
    rec.update(kw)
    return rec


def test_frame_times_run_from_take_to_take_and_last_to_return():
    takes = [[0.0, 0.5, 1.25], [2.0, 2.1]]
    returns = [1.5, 2.6]
    assert stats.frame_times_ms(takes, returns) == pytest.approx(
        [500.0, 750.0, 250.0, 100.0, 500.0])


def test_fps_counts_every_frame_over_the_whole_window():
    rec = _rec(frame_ms=[1.0] * 30, window_s=12.0)
    assert REG.metric("fps").read(rec) == pytest.approx(2.5)


def test_p90_is_over_all_frames():
    times = list(range(1, 101))              # 1..100 ms
    rec = _rec(frame_ms=times)
    assert REG.metric("frame_ms_p90").read(rec) == pytest.approx(90.1)
    assert stats.percentile(times, 90) == pytest.approx(
        float(np.percentile(times, 90)))


def test_union_of_intervals_counts_overlaps_once():
    assert stats.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.75)]) == 4
    assert stats.union_length([]) == 0
    assert stats.idle_gaps([(1, 2), (1.5, 3), (4, 5)], 0, 6) == [
        (0, 1), (3, 4), (5, 6)]


def test_profile_summary_busy_idle_launches_and_gaps():
    dev = [("kernel", "k1", 10, 20), ("kernel", "k2", 15, 30),
           ("gpu_memcpy", "Memcpy HtoD", 50, 60), ("kernel", "k1", 70, 80)]
    host = [("user_annotation", "span.a", 28, 75), ("cpu_op", "aten::add", 35, 45)]
    s = summarise(dev, host, 0, 100, frames=2)
    assert s["busy_s"] == pytest.approx(40e-9)
    assert s["window_s"] == pytest.approx(100e-9)
    assert s["launches"] == 3
    assert s["device_ops"][0] == ["k1", pytest.approx(20e-9)]
    # gaps 30-50 (mid 40: inside span.a and aten::add), 80-100, 0-10, 60-70
    assert s["idle_gaps"][0] == ["span.a / aten::add", pytest.approx(20e-9)]
    assert s["idle_gaps"][1] == ["host outside any op", pytest.approx(20e-9)]
    assert [n for n, _ in s["idle_gaps"][2:]] == ["host outside any op",
                                                  "span.a"]
    # busy 20 ns a profiled frame against a window of 4 frames in 100 ns
    rec = _rec(profile=s, window_s=100e-9, frame_ms=[25e-6] * 4)
    assert REG.metric("device_idle_pct").read(rec) == pytest.approx(20.0)
    assert REG.metric("launches_per_frame").read(rec) == pytest.approx(1.5)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_frozen_source", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", [(288, 352, 4, 7), (144, 176, 4, 7),
                                  (1088, 1920, 4, 7), (288, 352, 8, 7)])
def test_peaks_and_cross_bound_are_chip_smokes(case):
    cs = _chip_smoke()
    H, W, R, sr = case
    n_off = (2 * sr + 1) ** 2
    assert roofline.HBM_BYTES_PER_S == cs.HBM_BYTES_PER_S
    assert roofline.CUDA_CORE_OPS_PER_S == cs.CUDA_CORE_OPS_PER_S
    assert roofline.cross_cells_bound_ms(H, W, R, sr, n_off) == \
        cs.cross_cells_bound_ms(H, W, R, sr, n_off)


def test_search_work_counts_the_cross_term_as_chip_smoke_does():
    H, W, sr = 288, 352, 7
    ops, nbytes = roofline.search_plane_work(H, W, sr, True)
    cross = 2 * 4 * (2 * sr + 1) ** 2 * H * W   # chip_smoke's operation term
    fit = sum((H // bh) * (W // bw) * 4 * (2 * sr + 1) ** 2
              * (roofline.FIT_OPS + (bh // 4) * (bw // 4) - 1)
              for bh, bw in roofline.SHAPES)
    assert ops == cross + fit
    assert nbytes == 2 * H * W + (H // 4) * (W // 4) * 24


def test_search_roofline_share_on_a_fixed_span():
    settings = REG.config("fractal_cif")["settings"]
    bound_ms, by = roofline.fractal_search_bound_ms(settings)
    assert by == "operations"
    label = "h264tpu_torch.ops.fractal.search_plane"
    rec = _rec(types=["I", "P", "P"], spans={label: (20.0, 6)})
    got = REG.metric("fractal.search_roofline_pct").read(rec)
    assert got == pytest.approx(100 * bound_ms / 10.0)
    assert REG.metric("fractal.search_ms").read(rec) == pytest.approx(10.0)
    assert REG.metric("fractal.search_ms").read(_rec(types=["I"])) is None


def test_span_and_counter_readers_divide_by_their_frames():
    spans = {"h264tpu_torch.ops.deblock.deblock_plane_grouped": (90.0, 9),
             "h264tpu_torch.entropy.fractal_syntax.write_tree": (4.0, 6),
             "h264tpu_torch.entropy.fractal_syntax.write_residual": (5.0, 9),
             "h264tpu_torch.avc.device_enc.search": (40.0, 2),
             "h264tpu_torch.avc.device_enc.decide": (300.0, 3)}
    rec = _rec(types=["I", "P", "P"], spans=spans,
               counters={"host_ms.pack": [3.0, 6.0, 9.0]})
    assert REG.metric("fractal.deblock_ms").read(rec) == pytest.approx(30.0)
    assert REG.metric("fractal.entropy_ms").read(rec) == pytest.approx(3.0)
    assert REG.metric("avc.search_ms").read(rec) == pytest.approx(20.0)
    assert REG.metric("avc.decide_ms").read(rec) == pytest.approx(100.0)
    assert REG.metric("avc.pack_ms").read(rec) == pytest.approx(6.0)
