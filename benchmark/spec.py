"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; a configuration names an
engine. Each is a file of its own under the benchmark's folder, so a new
cell, configuration, mix, engine or per-layer metric is a new file and a
new entry, never an edit of this module.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise ValueError(f"{what} {name!r} is not a valid name "
                         "(letters, digits, _, . and -, at most 64)")
    return name


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(path: Path, prefix: str):
    """Import the Python file ``path`` as a module of its own (file names
    may hold dots, which a package import cannot)."""
    name = f"_bench_{prefix}_{re.sub(r'[^A-Za-z0-9_]', '_', path.stem)}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` under ``root`` and the benchmark folder beside
    it (``bench_dir``, by default this package's own folder)."""

    def __init__(self, root: Path = ROOT, bench_dir: Path | None = None):
        self.root = Path(root)
        self.bench_dir = Path(bench_dir) if bench_dir else self.root / "benchmark"
        self.doc = load_json(self.root / "BENCHMARK.json")
        self.cells = {check_name(w["name"], "cell"): w
                      for w in self.doc["workloads"]}
        self.configs = {check_name(c["name"], "config"): c
                        for c in self.doc["configs"]}
        self.end_to_end = {check_name(m["name"], "metric"): m
                           for m in self.doc["end_to_end"]}
        self.per_layer = {check_name(m["name"], "metric"): m
                          for m in self.doc["per_layer"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                           f"(cells: {', '.join(sorted(self.cells))})")
        return self.cells[name]

    def config(self, name: str) -> dict:
        cfg = load_json(self.root / self.configs[name]["file"])
        cfg["name"] = name
        return cfg

    def traffic(self, name: str) -> dict:
        mix = load_json(self.bench_dir / "traffic" / f"{check_name(name, 'traffic')}.json")
        mix["name"] = name
        return mix

    def engine(self, name: str):
        return load_module(self.bench_dir / "engines" / f"{check_name(name, 'engine')}.py",
                           "engine")

    def metric_reader(self, name: str):
        return load_module(self.bench_dir / "metrics" / f"{check_name(name, 'metric')}.py",
                           "metric")

    def _cell_metrics(self, table: dict, cell_name: str) -> list:
        return [m for m in table.values()
                if cell_name in m.get("workloads", [cell_name])]

    def end_to_end_for(self, cell_name: str) -> list:
        """The cell's end-to-end metrics (a metric without ``workloads``
        belongs to every cell)."""
        return self._cell_metrics(self.end_to_end, cell_name)

    def per_layer_for(self, cell_name: str) -> list:
        """The cell's per-layer metrics: those listing it, and those
        without ``workloads`` whose end-to-end metric the cell reports."""
        mine = {m["name"] for m in self.end_to_end_for(cell_name)}
        return [m for m in self.per_layer.values()
                if cell_name in m.get("workloads", [cell_name])
                and ("workloads" in m or m["moves"] in mine)]
