"""The brute-force kNN cell's pieces on the CPU: the reducer of the
program's ``knn.*`` ranges on hand-built events, the roofline counts at
SIFT-1M's shape against a hand count, and a tiny brute-force cell through
``run.run_cell`` (the adapter, the judge and the result line)."""

from __future__ import annotations

import json
import math
from types import SimpleNamespace

import pytest
import torch

from benchmark import knn_spans, roofline_knn, run
from benchmark.spec import Bench
from benchmark.tests.conftest import make_tiny_root

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
CELL = "tiny-brute_force.batch"
KNN_METRICS = ("knn.chunk_mins_ms", "knn.select_ms", "knn.rescore_ms", "knn.idle_ms",
               "chunk_mins_roofline", "rescore_roofline")


def ev(name, start, end, children=(), kernels=(), device=CPU):
    return SimpleNamespace(
        name=name, device_type=device,
        time_range=SimpleNamespace(start=start, end=end), cpu_children=list(children),
        kernels=[SimpleNamespace(name=n, duration=d) for n, d in kernels])


def op(start, end, us):
    return ev("aten::op", start, end, kernels=[("kernel", us)])


def capture():
    """Two fused calls (times in us): the first holds each phase, a
    harness span nested in its phase-1 range (its kernel counts, its
    device-side mirror stays out of the busy time) and an op between
    phases; the second launches nothing. Device activity from 2 to 70 and
    at 150; an IVF-named device event is no activity."""
    bench_cm = ev("bench.chunk_mins", 2, 20, kernels=[("chunk_mins_tc_kernel", 14.0)])
    first = ev("knn.search", 0, 100, [
        ev("knn.chunk_mins", 1, 22, [bench_cm]),
        ev("knn.select", 22, 40, [op(22, 39, 5.0)]),
        ev("knn.rescore", 40, 50, [op(40, 49, 1.0)]),
        ev("knn.select", 50, 60, [op(50, 59, 3.0)]),
        op(60, 70, 0.5)])
    second = ev("knn.search", 200, 210)
    cpu = [first, second, *first.cpu_children, bench_cm]
    device = [ev(n, s, e, device=CUDA) for n, s, e in (
        ("chunk_mins_tc_kernel", 2, 16), ("bench.chunk_mins", 2, 16), ("sort", 25, 30),
        ("rescore_kernel", 41, 42), ("sort", 52, 55), ("relu", 68, 70), ("ivf.scan", 0, 200),
        ("later", 150, 160))]
    return cpu + device


def fake_run(events, kept=None):
    trace = SimpleNamespace(_prof=SimpleNamespace(events=lambda: events), kept=kept or {})
    return SimpleNamespace(trace=trace)


def test_reduce_phases_and_idle():
    red = knn_spans.reduce_events(capture())
    assert red["calls"] == 2 and red["device"]
    assert red["phase_us"] == {"knn.chunk_mins": 14.0, "knn.select": 8.0,
                               "knn.rescore": 1.0, "knn.scan": 0.0}
    # gaps 16-25, 30-41, 42-52, 55-68 lie in the first entry; 70-150 in none
    assert red["idle_us"] == pytest.approx(9 + 11 + 10 + 13)


def test_span_readers_per_call_and_nothing_without_ranges():
    bench = Bench()
    want = {"knn.chunk_mins_ms": 14.0, "knn.select_ms": 8.0, "knn.rescore_ms": 1.0,
            "knn.idle_ms": 43.0}
    for name, us in want.items():
        assert bench.metric_reader(name).read(fake_run(capture())) == pytest.approx(us / 2e3)
    no_entries = [e for e in capture() if e.name != "knn.search"]
    no_device = [e for e in capture() if e.device_type == CPU]
    for events in (no_entries, no_device):
        for name in KNN_METRICS:
            assert bench.metric_reader(name).read(fake_run(events)) is None
    assert knn_spans.of(SimpleNamespace(trace=None)) is None


def test_roofline_readers_on_kept_launches():
    bench = Bench()
    cids = torch.tensor([[0, 1], [1, 2]])
    kept = {"bench.chunk_mins": [(2, 300, 8, 4)] * 2, "bench.rescore": [(cids, 300, 8, 4)]}
    run_ = fake_run(capture(), kept)
    cm = 2 * roofline_knn.chunk_mins_least_s(2, 300, 8, 4) / 14e-6
    rs = roofline_knn.rescore_least_s(cids, 300, 8, 4) / 1e-6
    assert bench.metric_reader("chunk_mins_roofline").read(run_) == pytest.approx(100 * cm)
    assert bench.metric_reader("rescore_roofline").read(run_) == pytest.approx(100 * rs)
    # no launches kept (the gather route, or an older harness): nothing
    assert bench.metric_reader("rescore_roofline").read(fake_run(capture())) is None


def test_counts_at_sift_shape_by_hand():
    m, n, d = 10_000, 1_000_000, 128
    ops, nbytes = roofline_knn.chunk_mins_counts(m, n, d, 4)
    assert ops == 2.56e12
    assert nbytes == n * d * 4 + m * d * 4 + m * 7813 * 4
    least = roofline_knn.chunk_mins_least_s(m, n, d, 4)
    assert least == pytest.approx(2.56e12 / 989e12) and round(1e3 * least, 3) == 2.588
    # 48 candidate chunks a query, of which 7,813 distinct (the last holds
    # 64 rows): operations at the f32 rate bound it
    cids = (torch.arange(m * 48) % 7813).reshape(m, 48)
    ops, nbytes = roofline_knn.rescore_counts(cids, n, d, 4)
    assert ops == 2 * d * m * 48 * 128
    assert nbytes == n * d * 4 + m * d * 4 + m * 48 * 128 * 4
    assert roofline_knn.rescore_least_s(cids, n, d, 4) == pytest.approx(ops / 67e12)
    assert round(1e3 * ops / 67e12, 3) == 0.235


def test_least_time_takes_the_larger_bound():
    assert math.isclose(roofline_knn.least_time_s(67e12, 0, 67e12), 1.0)
    assert math.isclose(roofline_knn.least_time_s(1, 3.35e12, 989e12), 1.0)


@pytest.fixture(scope="module")
def knn_root(tmp_path_factory):
    """The tiny root with a brute-force configuration and cell of its own:
    SIFT's width and the cell's settings, 16,384 rows."""
    root = make_tiny_root(tmp_path_factory.mktemp("bench_knn_root"))
    cfgs = root / "benchmark" / "configs"
    sift = json.loads((cfgs / "sift1m-brute_force.json").read_text())
    (cfgs / "tiny-brute_force.json").write_text(json.dumps(dict(
        sift, n_rows=16384, n_queries=256,
        data=dict(sift["data"], n_centres=16, seed=3))))
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "tiny-brute_force", "source": "tests", "reduced": [],
                           "why": "tests", "file": "benchmark/configs/tiny-brute_force.json"})
    doc["workloads"].append({"name": CELL, "config": "tiny-brute_force",
                             "traffic": "tiny_batch", "chips": 1, "why": "tests"})
    for m in doc["end_to_end"] + doc["per_layer"]:
        if "sift1m-brute_force.batch" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(doc, indent=1))
    return root


def test_tiny_cell_last_line(knn_root):
    bench = Bench(knn_root)
    for trace in (False, True):
        out = run.run_cell(bench, CELL, seed=2**31 + 23, seconds=0.5, trace_on=trace,
                           device=torch.device("cpu"))
        assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
        assert out["correct"], out["checks"]
        assert out["checks"]["dist_gap"]["value"] <= 1e-4
        json.loads(json.dumps(out))
        if trace:
            # the knn metrics read the device's activity, of which the CPU has none
            want = {m["name"] for m in bench.per_layer_for(CELL)}
            assert set(KNN_METRICS) <= want and not set(out["metrics"]) & set(KNN_METRICS)
        else:
            assert set(out["metrics"]) == {"qps", "recall_at_10", "build_s", "setup_s"}
            assert out["metrics"]["recall_at_10"]["value"] == 1.0


def test_tiny_cell_control_not_correct(knn_root):
    out = run.run_cell(Bench(knn_root), CELL, seed=5, seconds=0.3, trace_on=False,
                       device=torch.device("cpu"), engine_name="control_bf16")
    assert not out["correct"]
    assert out["checks"]["dist_gap"]["value"] > 10 * out["checks"]["dist_gap"]["limit"]
