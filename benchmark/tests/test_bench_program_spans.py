"""The readers of the program's own ranges and counters
(``benchmark/program_spans.py`` and the ``search.*`` metrics) on a fake
capture and a fake registry: each phase's own device time, the idle in
the entry ranges and around the host syncs, the counters' ratios, and
nothing read from a program that has none of them."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from benchmark import program_spans
from benchmark.spec import Bench
from raft_tpu_torch.obs import metrics as obs_metrics

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
SPAN_METRICS = {"search.probe_ms": 4.0, "search.invert_ms": 1.0, "search.lut_ms": 5.0,
                "search.scan_ms": 8.0, "search.pool_ms": 3.0, "search.rerank_ms": 2.0,
                "search.idle_ms": 50.0, "search.sync_idle_ms": 23.0}


def ev(name, start, end, children=(), kernels=(), device=CPU):
    return SimpleNamespace(
        name=name, device_type=device,
        time_range=SimpleNamespace(start=start, end=end), cpu_children=list(children),
        kernels=[SimpleNamespace(name=n, duration=d) for n, d in kernels])


def op(start, end, us):
    return ev("aten::op", start, end, kernels=[("kernel", us)])


def capture():
    """Two calls of IVF-PQ (times in us): the first holds every phase, a
    sync and a harness span (its device-side mirror and a stray
    program-named device event stay out of the busy time); the second
    launches nothing. Device activity from 1 to 74 and at 150."""
    adc = ev("bench.pq_adc", 41, 50, kernels=[("pq_lists_kernel", 8.0)])
    scan = ev("ivf.scan", 30, 60, [ev("ivf.lut", 31, 40, [op(31, 39, 5.0)]), adc])
    first = ev("ivf_pq.search", 0, 100, [
        ev("ivf.probe", 0, 10, [op(1, 9, 4.0)]),
        ev("ivf.invert", 10, 20, [op(10, 19, 1.0)]),
        ev("ivf.sync", 20, 30),
        scan,
        ev("ivf.pool", 60, 70, [op(60, 69, 3.0)]),
        ev("ivf.rerank", 70, 90, [op(70, 89, 2.0)])])
    second = ev("ivf_pq.search", 200, 210)
    cpu = [first, second, *first.cpu_children, *scan.cpu_children]
    device = [ev(n, s, e, device=CUDA) for n, s, e in (
        ("probe_kernel", 1, 5), ("invert_kernel", 11, 12), ("lut_kernel", 35, 40),
        ("pq_lists_kernel", 42, 50), ("bench.pq_adc", 42, 50), ("ivf.scan", 30, 60),
        ("pool_kernel", 62, 65), ("rerank_kernel", 72, 74), ("later", 150, 160))]
    return cpu + device


def fake_run(events, engine="ivf_pq"):
    trace = SimpleNamespace(_prof=SimpleNamespace(events=lambda: events))
    return SimpleNamespace(trace=trace, cfg={"engine": engine})


def test_reduce_phases_idle_and_syncs():
    red = program_spans.reduce_events(capture())
    assert red["calls"] == 2 and red["device"]
    assert red["phase_us"] == {"ivf.probe": 4.0, "ivf.invert": 1.0, "ivf.lut": 5.0,
                               "ivf.scan": 8.0, "ivf.pool": 3.0, "ivf.rerank": 2.0}
    assert red["entry_us"] == 23.0
    # gaps 5-11, 12-35 (the sync's), 40-42, 50-62, 65-72 lie in the entry;
    # 74-150 does not
    assert red["idle_us"] == pytest.approx(50.0)
    assert red["sync_idle_us"] == 23.0


def test_span_readers_per_call():
    bench = Bench()
    run = fake_run(capture())
    for name, us in SPAN_METRICS.items():
        got = bench.metric_reader(name).read(run)
        assert got == pytest.approx(us / 2 / 1e3), name


def test_nothing_read_without_program_ranges_or_device():
    bench = Bench()
    no_entries = [e for e in capture() if not e.name.endswith(".search")]
    no_device = [e for e in capture() if e.device_type == CPU]
    for events in (no_entries, no_device):
        run = fake_run(events)
        for name in SPAN_METRICS:
            assert bench.metric_reader(name).read(run) is None
    assert program_spans.of(SimpleNamespace(trace=None)) is None


def test_counter_readers(monkeypatch):
    bench = Bench()
    reg = obs_metrics.MetricRegistry()
    monkeypatch.setattr(obs_metrics, "default_registry", lambda: reg)
    syncs = bench.metric_reader("search.host_syncs")
    dropped = bench.metric_reader("search.dropped_pairs_pct")
    run = fake_run([])
    # a program without the counters
    assert syncs.read(run) is None and dropped.read(run) is None
    reg.counter("ivf_search_calls_total", engine="ivf_pq").inc(4)
    reg.counter("ivf_search_host_syncs_total", engine="ivf_pq", site="a").inc(4)
    reg.counter("ivf_search_host_syncs_total", engine="ivf_pq", site="b").inc(4)
    reg.counter("ivf_search_calls_total", engine="ivf_flat").inc(3)
    reg.counter("ivf_search_host_syncs_total", engine="ivf_flat", site="a").inc(30)
    assert syncs.read(run) == 2.0
    assert syncs.read(fake_run([], "ivf_flat")) == 10.0
    reg.counter("ivf_search_pairs_total", engine="ivf_pq").inc(1000)
    reg.counter("ivf_search_pairs_dropped_total", engine="ivf_pq").inc_deferred(
        torch.tensor(25))
    assert dropped.read(run) == 2.5
    # calls but no sync series: no host sync
    reg.counter("ivf_search_calls_total", engine="ivf_sq").inc(2)
    assert syncs.read(fake_run([], "ivf_sq")) == 0.0
    assert dropped.read(fake_run([], "ivf_sq")) is None
