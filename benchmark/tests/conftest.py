"""Tiny cells for the harness's CPU tests: a copy of the benchmark folder
under a temporary root, with tiny configurations and mixes added as new
files and new entries of its own ``BENCHMARK.json``, as a later PR adds a
cell."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from benchmark.spec import ROOT

TINY_DATA = {"kind": "gaussian_mixture", "n_centres": 64, "centre_spread": 1.0, "noise": 1.0,
             "seed": 3}


def _json(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


def make_tiny_root(root: Path, *, dim: int = 16, n_rows: int = 20000) -> Path:
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfgs = root / "benchmark" / "configs"
    flat = json.loads((cfgs / "deep10m-ivf_flat.json").read_text())
    pq = json.loads((cfgs / "deep10m-ivf_pq.json").read_text())
    small = {"n_rows": n_rows, "dim": dim, "n_queries": 256, "data": TINY_DATA}
    _json(cfgs / "tiny-ivf_flat.json",
          dict(flat, **small, index=dict(flat["index"], n_lists=32), search={"n_probes": 4}))
    _json(cfgs / "tiny-ivf_pq.json",
          dict(pq, **small, index=dict(pq["index"], n_lists=32, pq_dim=dim // 4),
               search={"n_probes": 4, "refine_ratio": 4.0}))
    mixes = root / "benchmark" / "traffic"
    batch = json.loads((mixes / "batch.json").read_text())
    _json(mixes / "tiny_batch.json", dict(batch, batch=128, trace_seconds=0.3))
    doc["configs"] += [
        {"name": "tiny-ivf_flat", "source": "tests", "reduced": [], "why": "tests",
         "file": "benchmark/configs/tiny-ivf_flat.json"},
        {"name": "tiny-ivf_pq", "source": "tests", "reduced": [], "why": "tests",
         "file": "benchmark/configs/tiny-ivf_pq.json"}]
    doc["workloads"] += [
        {"name": "tiny-ivf_flat.batch", "config": "tiny-ivf_flat", "traffic": "tiny_batch",
         "chips": 1, "why": "tests"},
        {"name": "tiny-ivf_pq.batch", "config": "tiny-ivf_pq", "traffic": "tiny_batch",
         "chips": 1, "why": "tests"}]
    for m in doc["end_to_end"] + doc["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [w.replace("deep10m", "tiny") for w in m["workloads"]]
    _json(root / "BENCHMARK.json", doc)
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("bench_root"))
