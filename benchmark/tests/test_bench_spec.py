"""BENCHMARK.json against the contract's shape, and the harness finding a
new cell, configuration, mix and metric by its file alone."""

from __future__ import annotations

import json
import re

import torch

from benchmark import run
from benchmark.spec import NAME_RE, ROOT, UNIT_RE, Bench

CONTRACT_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
                 "end_to_end", "per_layer"}


def _doc():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_names_units_and_keys_allowed():
    doc = _doc()
    assert set(doc) == CONTRACT_KEYS
    names = []
    for c in doc["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert all(NAME_RE.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        for text in (c["why"], c["source"]):
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
        # the file gives each cut its reason, and what was set here
        held = json.loads((ROOT / c["file"]).read_text())
        assert set(held["reduced"]) == set(c["reduced"]) and held["assumed"]
    for w in doc["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in doc["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in doc["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "\n" not in m["layer"] and "\t" not in m["layer"]
    for m in doc["end_to_end"] + doc["per_layer"]:
        names.append(m["name"])
        assert UNIT_RE.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(NAME_RE.match(n) for n in names)
    assert len(json.dumps(doc)) <= 64 * 1024
    for p in doc["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.endswith("_torch")
    assert all(isinstance(a, str) and not a.startswith("/") and ".." not in a
               for a in doc["command"])


def test_every_cell_reports_what_its_metrics_move():
    bench = Bench()
    e2e = {m["name"] for m in bench.doc["end_to_end"]}
    assert "setup_s" in e2e
    for cell in bench.cells:
        mine = {m["name"] for m in bench.end_to_end_for(cell)}
        assert "setup_s" in mine and len(mine) >= 2
        layer = bench.per_layer_for(cell)
        assert layer
        for m in layer:
            assert m["moves"] in mine, (cell, m["name"])
    for m in bench.doc["end_to_end"] + bench.doc["per_layer"]:
        bench.metric_reader(m["name"])           # every metric has its reader file
        for w in m.get("workloads", []):
            assert w in bench.cells


def test_new_files_found_by_name(tiny_root):
    """A cell, configuration, mix and per-layer metric added as new files
    and new entries, with no edit of the harness."""
    bench_dir = tiny_root / "benchmark"
    (bench_dir / "metrics" / "tiny.answered_queries.py").write_text(
        "def read(run):\n    return float(run.attempted)\n")
    doc = json.loads((tiny_root / "BENCHMARK.json").read_text())
    doc["per_layer"].append({"name": "tiny.answered_queries", "unit": "queries",
                             "better": "higher", "source": "host_clock", "layer": "search",
                             "moves": "qps", "workloads": ["tiny-ivf_flat.batch"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(doc))
    bench = Bench(tiny_root)
    assert bench.config("tiny-ivf_flat")["n_rows"] == 20000
    assert bench.traffic("tiny_batch")["batch"] == 128
    out = run.run_cell(bench, "tiny-ivf_flat.batch", seed=5, seconds=0.6, trace_on=True,
                       device=torch.device("cpu"))
    got = out["metrics"]["tiny.answered_queries"]
    assert got["value"] == out["attempted"] and got["unit"] == "queries"
