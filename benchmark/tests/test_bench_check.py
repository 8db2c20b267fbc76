"""The check that decides ``correct``, its control and the faults it must
catch, driven through the rest of a run on the CPU at QCIF (the cells'
configurations with 4-frame clips, as new files in a copy).  Every number
of a cell has an upper reading: from the control or from a planted fault
(``benchmark/faults.py``)."""

from __future__ import annotations

import io

import pytest
import torch

from benchmark.faults import plant
from benchmark.harness.cell import run_cell
from benchmark.harness.registry import Registry

SEED = 2147483659


def _run(bench, cell, seconds=3.0, controls=False):
    torch.set_num_threads(2)
    return run_cell(cell, SEED, seconds, False, "cpu", 1, Registry(bench),
                    log=io.StringIO(), controls=controls)


@pytest.fixture(scope="module")
def sound(tiny_bench):
    return {cell: _run(tiny_bench, cell, controls=True)
            for cell in ("fractal_qcif.tiny", "avc_qcif.tiny")}


@pytest.mark.parametrize("cell", ["fractal_qcif.tiny", "avc_qcif.tiny"])
def test_sound_run_is_correct(sound, cell):
    res = sound[cell]
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 2
    assert set(res["metrics"]) == {"fps", "frame_ms_p90", "setup_s"}
    assert list(res)[-1] == "checks"
    assert res["checks"]["decode_mismatch_px"]["value"] == 0


CONTROL_FAILS = {"fractal_qcif.tiny": ("decode_mismatch_px", "search_gap"),
                 "avc_qcif.tiny": ("decode_mismatch_px",)}


@pytest.mark.parametrize("cell", ["fractal_qcif.tiny", "avc_qcif.tiny"])
def test_control_is_not_correct(sound, cell):
    checks = sound[cell]["control_checks"]
    assert not sound[cell]["control_correct"], checks
    for key in CONTROL_FAILS[cell]:
        assert checks[key]["value"] > checks[key]["limit"], checks


@pytest.mark.parametrize("cell,fault,number", [
    ("avc_qcif.tiny", "zero_mv", "motion_gap"),
    ("avc_qcif.tiny", "drop_residual", "level_band_violations"),
    ("fractal_qcif.tiny", "drop_residual", "residual_mismatch"),
    ("fractal_qcif.tiny", "split_all", "split_violations"),
])
def test_planted_fault_is_not_correct(tiny_bench, cell, fault, number):
    with plant(fault):
        res = _run(tiny_bench, cell)
    assert not res["correct"], res["checks"]
    c = res["checks"][number]
    assert c["value"] > c["limit"], res["checks"]
    assert res["checks"]["decode_mismatch_px"]["value"] == 0   # consistent


def test_faults_are_undone_after_the_run():
    import h264tpu_torch.avc.device_enc as DE
    import h264tpu_torch.ops.fractal as F
    import h264tpu_torch.ops.transform as T
    before = (DE._integer_search, DE._code_inter_luma, F.search_plane,
              T.residual_code_plane)
    for name in ("zero_mv", "drop_residual", "split_all"):
        with plant(name):
            pass
    assert (DE._integer_search, DE._code_inter_luma, F.search_plane,
            T.residual_code_plane) == before
    with pytest.raises(KeyError):
        with plant("no_such_fault"):
            pass


def test_fractal_token_altered_where_written(tiny_bench, monkeypatch):
    import h264tpu_torch.entropy.fractal_syntax as FS
    orig = FS.write_residual

    def altered(w, zz, cy, cx, mode):
        zz = zz.copy()
        zz.reshape(-1)[zz.size // 2] += 1
        return orig(w, zz, cy, cx, mode)

    monkeypatch.setattr(FS, "write_residual", altered)
    res = _run(tiny_bench, "fractal_qcif.tiny")
    assert not res["correct"]
    assert res["checks"]["decode_mismatch_px"]["value"] > 0


def test_fractal_search_answer_altered_where_made(tiny_bench, monkeypatch):
    import h264tpu_torch.ops.fractal as F
    orig = F.search_plane

    def altered(*args, **kwargs):
        tree = orig(*args, **kwargs)
        moved = [s._replace(dx=torch.clamp(s.dx + 1, -7, 7))
                 for s in (tree.s16, tree.s8, tree.s84, tree.s48, tree.s44)]
        return tree._replace(s16=moved[0], s8=moved[1], s84=moved[2],
                             s48=moved[3], s44=moved[4])

    monkeypatch.setattr(F, "search_plane", altered)
    res = _run(tiny_bench, "fractal_qcif.tiny")
    assert not res["correct"]
    gap = res["checks"]["search_gap"]
    assert gap["value"] > gap["limit"]


def test_avc_token_altered_where_packed(tiny_bench, monkeypatch):
    import h264tpu_torch.avc.native as AN
    orig = AN.pack_slice

    def altered(*args, **kwargs):
        rbsp = bytearray(orig(*args, **kwargs))
        rbsp[len(rbsp) // 2] ^= 0x10
        return bytes(rbsp)

    monkeypatch.setattr(AN, "pack_slice", altered)
    res = _run(tiny_bench, "avc_qcif.tiny")
    assert not res["correct"]
