"""The result line's shape, the run's refusal without a card, and the
import guard: nothing the benchmark runs loads JAX or the JAX package, and
the reference loads nothing of the port."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import torch

from benchmark import run
from benchmark.spec import BENCH_DIR, ROOT, Bench

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_last_line_has_the_contract_keys(tiny_root):
    bench = Bench(tiny_root)
    for trace in (False, True):
        out = run.run_cell(bench, "tiny-ivf_flat.batch", seed=2**31 + 11, seconds=0.6,
                           trace_on=trace, device=torch.device("cpu"))
        keys = list(out)
        assert keys[:5] == RESULT_KEYS and keys[-1] == "checks"
        assert set(keys) <= set(RESULT_KEYS) | {"breakdown", "checks"}
        assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        if trace:
            assert {"busy_s", "window_s"} <= set(out["device"])
            assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        for m in out["metrics"].values():
            assert set(m) == {"value", "unit"}
        for c in out["checks"].values():
            assert set(c) == {"value", "limit"}
        json.loads(json.dumps(out))
        want = {m["name"] for m in (bench.per_layer_for if trace else
                                    bench.end_to_end_for)("tiny-ivf_flat.batch")}
        # read from the device's activity, of which the CPU has none
        device_read = {"device.idle_pct.batch", "flat_scan_roofline", "search_roofline"}
        assert set(out["metrics"]) == want - device_read


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "deep10m-ivf_flat.batch", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_no_port_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    folder the command fails and prints nothing on standard output."""
    import shutil

    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "deep10m-ivf_flat.batch", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=120, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout == ""


def test_whole_top_level_names():
    assert "raft_tpu_torch".split(".")[0] not in run.FORBIDDEN
    sys.modules.setdefault("raft_tpu_torchlike_probe", sys)
    assert run.forbidden_modules() == []


def test_cpu_run_loads_no_jax(tiny_root):
    code = (
        "import sys, torch\n"
        "from pathlib import Path\n"
        "from benchmark.spec import Bench\n"
        "from benchmark import run\n"
        "b = Bench(Path(sys.argv[1]))\n"
        "for cell in ('tiny-ivf_flat.batch', 'tiny-ivf_pq.batch'):\n"
        "    run.run_cell(b, cell, seed=3, seconds=0.5, trace_on=True,\n"
        "                 device=torch.device('cpu'))\n"
        "print(run.forbidden_modules(), 'raft_tpu_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code, str(tiny_root)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH_DIR / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("raft_tpu_torch", "raft_tpu", "jax"), path
    code = ("import sys, torch\n"
            "from benchmark.reference import exact\n"
            "x = torch.randn(500, 8); q = torch.randn(20, 8)\n"
            "exact.topk(x, q, 5)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'raft_tpu_torch', 'raft_tpu', 'jax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
