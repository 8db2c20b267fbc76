"""Find the benchmark's parts by name.

Everything that belongs to one configuration, cell, traffic mix, generator,
system or metric sits in a file of its own under the benchmark folder, so
that adding one is adding files:

    configs/<config>.json        workloads/<cell>.json
    traffic/<traffic>.json       generators/<generator>.py
    systems/<system>.py          metrics/<metric>.py

Python parts are loaded by path, so a dotted name such as
``fractal.search_ms`` is safe.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent


class Registry:
    """The parts under one benchmark folder (``root``/benchmark) and the
    manifest ``root``/BENCHMARK.json."""

    def __init__(self, bench_dir: Path = BENCH_DIR):
        self.dir = Path(bench_dir)
        self.root = self.dir.parent

    def _json(self, kind: str, name: str) -> dict:
        path = self.dir / kind / f"{name}.json"
        if not path.is_file():
            raise KeyError(f"no {kind} file named {name!r} ({path})")
        data = json.loads(path.read_text())
        if data.get("name", name) != name:
            raise ValueError(f"{path} names itself {data['name']!r}")
        return data

    def _module(self, kind: str, name: str):
        path = self.dir / kind / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no {kind} module named {name!r} ({path})")
        key = f"_bench_{kind}_{name}".replace(".", "_").replace("-", "_")
        mod = sys.modules.get(key)
        if mod is None or getattr(mod, "__file__", None) != str(path):
            spec = importlib.util.spec_from_file_location(key, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[key] = mod
            spec.loader.exec_module(mod)
        return mod

    def manifest(self) -> dict:
        return json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        return self._json("workloads", name)

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def generator(self, name: str):
        return self._module("generators", name)

    def system(self, name: str):
        return self._module("systems", name)

    def metric(self, name: str):
        return self._module("metrics", name)

    def cell_metrics(self, cell: str, traced: bool):
        """[(name, manifest entry, reader module)] of the metrics that
        ``cell`` reports: the end-to-end ones untraced, the per-layer ones
        traced; an entry with a ``workloads`` list only in those cells."""
        key = "per_layer" if traced else "end_to_end"
        out = []
        for entry in self.manifest()[key]:
            cells = entry.get("workloads")
            if cells is None or cell in cells:
                out.append((entry["name"], entry, self.metric(entry["name"])))
        return out
