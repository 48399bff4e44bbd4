"""The ``gist1m-ivf_flat`` configuration and its cell, found by name, and
the ``search.legacy_scan_pct`` reader on synthetic counter snapshots."""

from __future__ import annotations

from types import SimpleNamespace

from benchmark.spec import Bench
from raft_tpu_torch.obs import metrics as obs_metrics

CELL = "gist1m-ivf_flat.batch"
LISTED = ("qps", "search.host_ms", "search_roofline", "flat_scan_roofline",
          "device.idle_pct.batch", "build.kmeans_s", "build.rest_s",
          "search.probe_ms", "search.invert_ms", "search.scan_ms",
          "search.pool_ms", "search.rerank_ms", "search.idle_ms",
          "search.host_syncs", "search.dropped_pairs_pct",
          "search.legacy_scan_pct")


def test_config_loads_at_gist_shape():
    bench = Bench()
    cfg = bench.config(bench.cell(CELL)["config"])
    assert (cfg["dtype"], cfg["metric"], cfg["n_rows"], cfg["dim"],
            cfg["n_queries"], cfg["k"]) == ("float32", "l2", 1_000_000, 960,
                                            10_000, 10)
    assert cfg["engine"] == "ivf_flat" and cfg["search"] == {"n_probes": 32}
    assert cfg["index"] == {"n_lists": 1024, "kmeans_n_iters": 20,
                            "kmeans_init": "random", "seed": 0}
    assert list(cfg["reduced"]) == ["data"] and cfg["check"]["dist_gap"] > 0
    assert bench.engine(cfg["engine"]).DISTANCE == "l2"
    assert bench.traffic(bench.cell(CELL)["traffic"])["batch"] == 10_000


def test_cell_metrics_resolve():
    bench = Bench()
    names = {m["name"] for m in bench.end_to_end_for(CELL)}
    names |= {m["name"] for m in bench.per_layer_for(CELL)}
    assert set(LISTED) <= names
    assert {"recall_at_10", "build_s", "setup_s"} <= names
    for name in names:
        bench.metric_reader(name)
    # the brute force's and PQ's own metrics stay out of the cell
    assert not names & {"knn.chunk_mins_ms", "pq_adc_roofline", "search.lut_ms"}
    legacy = bench.per_layer["search.legacy_scan_pct"]
    assert legacy["workloads"] == ["deep10m-ivf_flat.batch",
                                   "deep10m-ivf_pq.batch", CELL]


def test_legacy_scan_pct_reads_counter_snapshots(monkeypatch):
    reader = Bench().metric_reader("search.legacy_scan_pct")
    reg = obs_metrics.MetricRegistry()
    monkeypatch.setattr(obs_metrics, "default_registry", lambda: reg)

    def run(engine):
        return SimpleNamespace(cfg={"engine": engine})

    # a program without the counter
    assert reader.read(run("ivf_flat")) is None
    name = "ivf_search_scan_form_total"
    reg.counter(name, engine="ivf_flat", form="kernel", reason="auto").inc(12)
    reg.counter(name, engine="ivf_pq", form="legacy", reason="fallback").inc(3)
    reg.counter(name, engine="ivf_pq", form="legacy", reason="pinned").inc(1)
    assert reader.read(run("ivf_flat")) == 0.0
    assert reader.read(run("ivf_pq")) == 100.0
    reg.counter(name, engine="ivf_flat", form="legacy", reason="fallback").inc(4)
    assert reader.read(run("ivf_flat")) == 25.0
    assert reader.read(run("ivf_sq")) is None
