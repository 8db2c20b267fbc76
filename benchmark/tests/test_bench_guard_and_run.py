"""The import guard, and ``run.py`` without a card."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.harness.guard import forbidden_loaded
from conftest import ROOT


def test_guard_compares_whole_top_level_names():
    assert forbidden_loaded(["h264tpu_torch", "h264tpu_torch.ops"]) == []
    assert forbidden_loaded(["h264tpu.ops.fractal", "numpy"]) == ["h264tpu"]
    assert forbidden_loaded(["jaxlib.xla_client", "jax", "flax.linen",
                             "jaxtyping"]) == ["flax", "jax", "jaxlib"]


def test_reference_imports_no_program_and_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.fractal_ref, benchmark.reference.avc_ref\n"
            "from benchmark.harness.guard import forbidden_loaded\n"
            "print(forbidden_loaded(forbidden={'jax', 'jaxlib', 'flax', "
            "'h264tpu', 'h264tpu_torch'}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]"


def _run(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "fractal_cif.clip50",
         "--seed", "2147483659", "--seconds", "1", "--trace", "0", *extra],
        capture_output=True, text=True, cwd=cwd, env=env, timeout=300)


def test_run_exits_nonzero_without_a_card_and_prints_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert "metrics" not in out.stdout and out.stdout.strip() == ""


def test_run_exits_nonzero_with_only_the_benchmark(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
def test_cells_run_on_the_card(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cell in ("fractal_cif.clip50", "avc_cif.clip50"):
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", cell,
             "--seed", "2147483659", "--seconds", "5", "--trace", "0"],
            capture_output=True, text=True, cwd=ROOT, timeout=600)
        assert out.returncode == 0, out.stderr[-4000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"] and res["device"]["platform"] == "gpu"
        assert set(res["metrics"]) == {"fps", "frame_ms_p90", "setup_s"}
        assert list(res)[-1] == "checks"
