"""The manifest, the files it names, and additions by new files only."""

from __future__ import annotations

import hashlib
import json
import re

import pytest

from benchmark.harness.registry import Registry
from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
REG = Registry()


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in MANIFEST[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for e in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(e["unit"]), e
        assert e["better"] in ("lower", "higher")
    for e in MANIFEST["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    assert {e["name"] for e in MANIFEST["end_to_end"]} >= {
        "fps", "frame_ms_p90", "setup_s"}
    assert {w["name"] for w in MANIFEST["workloads"]} == {
        "fractal_cif.clip50", "avc_cif.clip50"}
    assert all(w["chips"] == 1 for w in MANIFEST["workloads"])


@pytest.mark.parametrize("entry", MANIFEST["configs"], ids=lambda e: e["name"])
def test_config_resolves(entry):
    cfg = REG.config(entry["name"])
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert REG.system(cfg["system"]).build


@pytest.mark.parametrize("entry", MANIFEST["workloads"], ids=lambda e: e["name"])
def test_cell_resolves(entry):
    cell = REG.cell(entry["name"])
    for key in ("config", "traffic", "chips", "why"):
        assert cell[key] == entry[key]
    assert REG.config(cell["config"])
    traffic = REG.traffic(cell["traffic"])
    assert REG.generator(traffic["generator"]).make_pool
    assert set(cell["check"]["limits"]) <= {
        "decode_mismatch_px", "search_gap", "residual_mismatch",
        "split_violations", "level_band_violations", "motion_gap"}


@pytest.mark.parametrize("entry", MANIFEST["end_to_end"] + MANIFEST["per_layer"],
                         ids=lambda e: e["name"])
def test_metric_resolves(entry):
    reader = REG.metric(entry["name"])
    assert reader.SOURCE == entry["source"]
    if "layer" in entry:
        assert reader.LAYER == entry["layer"]
        assert reader.MOVES == entry["moves"] == "fps"


def test_per_layer_metrics_only_in_cells_that_report_fps():
    fps_cells = {w["name"] for w in MANIFEST["workloads"]}
    fps = next(e for e in MANIFEST["end_to_end"] if e["name"] == "fps")
    if "workloads" in fps:
        fps_cells &= set(fps["workloads"])
    for e in MANIFEST["per_layer"]:
        assert e["workloads"] and set(e["workloads"]) <= fps_cells
    for w in MANIFEST["workloads"]:
        assert REG.cell_metrics(w["name"], traced=True)


def _digests(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in folder.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_additions_are_new_files_only(tmp_path):
    from conftest import tiny_copy
    before = _digests(ROOT / "benchmark")
    bench = tiny_copy(tmp_path)
    # a new per-layer metric: its reader and its manifest entry
    (bench / "metrics" / "frames_per_clip.py").write_text(
        'SOURCE = "program_counter"\nLAYER = "window"\nMOVES = "fps"\n\n\n'
        'def read(rec):\n    return len(rec["frame_ms"])\n')
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    manifest["per_layer"].append(dict(
        name="frames_per_clip", unit="frames", better="higher",
        source="program_counter", layer="window", moves="fps",
        workloads=["fractal_qcif.tiny"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    reg = Registry(bench)
    assert reg.cell("avc_qcif.tiny")["config"] == "avc_qcif"
    assert reg.config("fractal_qcif")["settings"]["width"] == 176
    assert reg.traffic("pan_short")["clip_frames"] == 4
    names = [n for n, _, _ in reg.cell_metrics("fractal_qcif.tiny", True)]
    assert "frames_per_clip" in names
    assert "frames_per_clip" not in [
        n for n, _, _ in reg.cell_metrics("avc_qcif.tiny", True)]
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before
