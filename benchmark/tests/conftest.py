"""Fixtures of the benchmark's own tests (run with
``python -m pytest benchmark/tests``; they import no JAX)."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny_copy(dst: Path) -> Path:
    """A copy of the benchmark (folder and manifest) under ``dst`` with the
    program linked beside it and two QCIF cells of 4-frame clips added as
    new files and manifest entries: ``fractal_qcif.tiny`` and
    ``avc_qcif.tiny``.  Returns the copy's benchmark folder."""
    bench = dst / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench,
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    (dst / "h264tpu_torch").symlink_to(ROOT / "h264tpu_torch")
    traffic = json.loads((bench / "traffic" / "pan.json").read_text())
    traffic.update(name="pan_short", clip_frames=4)
    (bench / "traffic" / "pan_short.json").write_text(json.dumps(traffic))
    manifest = json.loads((dst / "BENCHMARK.json").read_text())
    for base, extra in (("fractal_cif", {}), ("avc_cif", {})):
        cfg = json.loads((bench / "configs" / f"{base}.json").read_text())
        name = base.replace("cif", "qcif")
        cfg["name"] = name
        cfg["settings"].update(width=176, height=144, **extra)
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        cell = json.loads(
            (bench / "workloads" / f"{base}.clip50.json").read_text())
        cell.update(name=f"{name}.tiny", config=name, traffic="pan_short")
        (bench / "workloads" / f"{name}.tiny.json").write_text(json.dumps(cell))
        manifest["workloads"].append(dict(
            name=cell["name"], config=name, traffic="pan_short", chips=1,
            why=cell["why"]))
    (dst / "BENCHMARK.json").write_text(json.dumps(manifest))
    return bench


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("bench"))
