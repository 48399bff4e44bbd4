"""The IVF searches' own measurement (raft_tpu_torch.spatial.ann.search_obs,
on the range layer raft_tpu_torch.core.annotate) on the CPU: the phase
ranges under a plain ``torch.profiler`` capture, nested under each call's
entry range, on both grouped searches and both scan engines; no range is
a user annotation and none is entered with the gate closed and no
capture; the counters of calls, host syncs and (query, probe) pairs, the
dropped ones held to ``common.probe_drop_stats`` on the same probe map.

The kernel engines run their scans' plain versions here.
"""

import importlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raft_tpu_torch.obs import MetricRegistry, default_registry
from raft_tpu_torch.obs import metrics as obs_metrics
from raft_tpu_torch.spatial.ann import (
    IVFFlatParams,
    IVFPQParams,
    ivf_flat_build,
    ivf_flat_search_grouped,
    ivf_pq_build,
    ivf_pq_search_grouped,
)
from raft_tpu_torch.spatial.ann import ivf_pq as tivf_pq
from raft_tpu_torch.spatial.ann.common import coarse_probe, probe_drop_stats

tann = importlib.import_module("raft_tpu_torch.core.annotate")

torch.set_num_threads(1)

CPU = torch.device("cpu")
D = 16
N_LISTS = 16
P = 4
K = 5
NQ = 64
PHASES = ("ivf.probe", "ivf.invert", "ivf.lut", "ivf.scan", "ivf.pool",
          "ivf.rerank", "ivf.sync")
ENTRIES = {"flat": "ivf_flat.search", "pq": "ivf_pq.search"}
ENGINES = {"flat": "ivf_flat", "pq": "ivf_pq"}


@pytest.fixture(scope="module")
def data():
    """Clustered rows and queries: hot lists, so a small qcap drops."""
    rng = np.random.default_rng(5)
    cents = rng.standard_normal((8, D)).astype(np.float32) * 4
    x = (cents[rng.integers(0, 8, 4096)]
         + rng.standard_normal((4096, D)).astype(np.float32))
    q = (cents[rng.integers(0, 8, NQ)]
         + rng.standard_normal((NQ, D)).astype(np.float32))
    return torch.as_tensor(x), torch.as_tensor(q)


@pytest.fixture(scope="module")
def indexes(data):
    x, _ = data
    flat = ivf_flat_build(x, IVFFlatParams(n_lists=N_LISTS, kmeans_n_iters=4,
                                           kmeans_init="random", seed=1),
                          device=CPU)
    pq = ivf_pq_build(x, IVFPQParams(n_lists=N_LISTS, pq_dim=4, pq_bits=4,
                                     kmeans_n_iters=4, pq_kmeans_n_iters=4,
                                     kmeans_init="random", store_raw=True,
                                     seed=1), device=CPU)
    return {"flat": flat, "pq": pq}


def _search(indexes, engine, q, *, use_kernel, qcap=NQ):
    if engine == "flat":
        return ivf_flat_search_grouped(indexes["flat"], q, K, n_probes=P,
                                       qcap=qcap, use_kernel=use_kernel)
    return ivf_pq_search_grouped(indexes["pq"], q, K, n_probes=P, qcap=qcap,
                                 refine_ratio=2.0, use_kernel=use_kernel)


def _small_lut_chunks(monkeypatch):
    """LUT chunks of a few pairs: the batch takes several, through the
    chunk plan's host syncs."""
    mk = 4 * (1 << 4)
    monkeypatch.setattr(tivf_pq, "_LUT_BLOCK_BYTES", 4 * mk * 40)


def _enclosing(e, name):
    p = e.cpu_parent
    while p is not None and p.name != name:
        p = p.cpu_parent
    return p


def _counter_sum(name, **labels):
    total = 0
    for c in default_registry().series(name):
        if all(c.labels.get(k) == v for k, v in labels.items()):
            total += c.value
    return total


CASES = [("flat", True), ("flat", False), ("pq", True), ("pq", False)]


@pytest.mark.parametrize("engine,use_kernel", CASES,
                         ids=[f"{e}-{'kernel' if k else 'legacy'}"
                              for e, k in CASES])
def test_phase_ranges_once_per_call_under_the_entry(indexes, data, monkeypatch,
                                                    engine, use_kernel):
    """A plain profiler capture (no start_trace, gate closed) sees each
    phase once per call, nested under that call's entry range; the PQ
    kernel engine's LUT build and scan once per LUT chunk with the chunk
    plan's two syncs, the legacy PQ engine's LUT build once per list
    block inside its scan. No range is a user annotation."""
    _, q = data
    if engine == "pq" and use_kernel:
        _small_lut_chunks(monkeypatch)
    prev = tann.set_profiling(False)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(2):
                _search(indexes, engine, q, use_kernel=use_kernel)
    finally:
        tann.set_profiling(prev)
    events = [e for e in prof.events()
              if e.name in PHASES or e.name in ENTRIES.values()]
    assert events and not any(e.is_user_annotation for e in events)
    entries = [e for e in events if e.name == ENTRIES[engine]]
    assert len(entries) == 2
    counts = {}
    for e in events:
        if e.name in PHASES:
            assert _enclosing(e, ENTRIES[engine]) is not None, e.name
            counts[e.name] = counts.get(e.name, 0) + 1
    want = {"ivf.probe": 2, "ivf.invert": 2, "ivf.scan": 2, "ivf.pool": 2}
    if engine == "flat":
        if use_kernel:
            want["ivf.rerank"] = 2
    elif use_kernel:
        want["ivf.rerank"] = 2
        chunks = counts.get("ivf.lut", 0)
        assert chunks >= 4 and chunks % 2 == 0
        want.update({"ivf.lut": chunks, "ivf.scan": chunks, "ivf.sync": 4})
    else:
        want["ivf.rerank"] = 2
        blocks = counts.get("ivf.lut", 0)
        assert blocks == 2 * -(-N_LISTS // 8)       # list_block 8
        want["ivf.lut"] = blocks
        for e in events:
            if e.name == "ivf.lut":
                assert _enclosing(e, "ivf.scan") is not None
    assert counts == want


def test_no_record_function_with_the_gate_closed(indexes, data, monkeypatch):
    """With the gate closed and no capture running, no search enters a
    record function; with the gate open, every range does."""
    _, q = data
    _small_lut_chunks(monkeypatch)
    entered = []

    class Fake:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return None

    monkeypatch.setattr(tann, "_record_function", Fake)
    prev = tann.set_profiling(False)
    try:
        for engine, use_kernel in CASES:
            _search(indexes, engine, q, use_kernel=use_kernel)
        assert entered == []
        tann.set_profiling(True)
        _search(indexes, "pq", q, use_kernel=True)
        assert entered[0] == "ivf_pq.search" and "ivf.sync" in entered
    finally:
        tann.set_profiling(prev)


@pytest.mark.parametrize("engine", ["flat", "pq"])
def test_dropped_pairs_counter_matches_probe_drop_stats(indexes, data, engine):
    """While a capture runs, the pairs counter gains nq * p a call and the
    dropped counter what ``probe_drop_stats`` counts on the same probe
    map; with the gate closed and no capture, and in a warm-up, neither
    moves."""
    _, q = data
    index = indexes[engine]
    qcap = 8                        # mean occupancy 16: hot lists drop
    probes, _ = coarse_probe(q.float(), index.centroids.float(), P)
    stats = probe_drop_stats(probes, N_LISTS, qcap)
    assert stats["dropped"] > 0
    lab = {"engine": ENGINES[engine]}

    def read():
        return (_counter_sum("ivf_search_pairs_total", **lab),
                _counter_sum("ivf_search_pairs_dropped_total", **lab))

    prev = tann.set_profiling(False)
    try:
        before = read()
        _search(indexes, engine, q, use_kernel=True, qcap=qcap)
        assert read() == before
        with profile(activities=[ProfilerActivity.CPU]):
            _search(indexes, engine, q, use_kernel=True, qcap=qcap)
        assert read() == (before[0] + stats["total"],
                          before[1] + stats["dropped"])
        tann.set_profiling(True)
        index.warmup(NQ, k=K, n_probes=P, qcap=qcap)
        assert read() == (before[0] + stats["total"],
                          before[1] + stats["dropped"])
    finally:
        tann.set_profiling(prev)


@pytest.mark.parametrize("engine,use_kernel,qcap,syncs", [
    ("flat", True, NQ, {}),
    ("flat", False, NQ, {}),
    ("flat", True, None, {"qcap": 1}),
    ("pq", True, NQ, {"live_pairs": 1, "chunk_plan": 1}),
    ("pq", False, NQ, {}),
], ids=["flat-kernel", "flat-legacy", "flat-auto_qcap", "pq-kernel-chunked",
        "pq-legacy"])
def test_host_syncs_counted_per_call(indexes, data, monkeypatch, engine,
                                     use_kernel, qcap, syncs):
    """``ivf_search_host_syncs_total`` counts 0 a call of IVF-Flat at a
    static qcap, the auto qcap's one read, and the PQ chunk plan's two
    reads a call; ``ivf_search_calls_total`` counts every call."""
    _, q = data
    if engine == "pq":
        _small_lut_chunks(monkeypatch)
    lab = ENGINES[engine]
    sites = ("qcap", "live_pairs", "chunk_plan")
    before = {s: _counter_sum("ivf_search_host_syncs_total", engine=lab,
                              site=s) for s in sites}
    calls = _counter_sum("ivf_search_calls_total", engine=lab)
    for _ in range(3):
        _search(indexes, engine, q, use_kernel=use_kernel, qcap=qcap)
    got = {s: _counter_sum("ivf_search_host_syncs_total", engine=lab,
                           site=s) - before[s] for s in sites}
    assert got == {s: 3 * syncs.get(s, 0) for s in sites}
    assert _counter_sum("ivf_search_calls_total", engine=lab) == calls + 3


def test_pq_one_lut_chunk_makes_no_host_sync(indexes, data):
    """A batch whose pairs fit one LUT chunk takes the one-launch path:
    one LUT build, one scan range and no host sync."""
    _, q = data
    before = _counter_sum("ivf_search_host_syncs_total", engine="ivf_pq")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _search(indexes, "pq", q, use_kernel=True)
    names = [e.name for e in prof.events()]
    assert names.count("ivf.lut") == 1 and names.count("ivf.scan") == 1
    assert "ivf.sync" not in names
    assert _counter_sum("ivf_search_host_syncs_total",
                        engine="ivf_pq") == before


def test_deferred_counter_folds_on_read():
    """``Counter.inc_deferred`` keeps device counts until the value is
    read, then folds them in once; the obs gate stops it as it stops
    ``inc``."""
    c = MetricRegistry().counter("c_total")
    c.inc(2)
    c.inc_deferred(torch.tensor(3))
    c.inc_deferred(torch.tensor(4))
    assert c.value == 9 and c.value == 9
    prev = obs_metrics.set_enabled(False)
    try:
        c.inc_deferred(torch.tensor(100))
    finally:
        obs_metrics.set_enabled(prev)
    assert c.value == 9


def test_ranges_under_a_plain_capture_are_not_user_annotations():
    """``annotate`` and ``push_range`` emit under any running capture,
    gate closed, as CPU-scope record functions that parent their ops."""
    prev = tann.set_profiling(False)
    try:
        assert not tann.ranges_on()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            assert tann.ranges_on() and not tann.profiling_enabled()
            with tann.annotate("outer %d", 1):
                tann.push_range("inner")
                torch.ones(4).sum()
                tann.pop_range()
        assert not tann.ranges_on()
    finally:
        tann.set_profiling(prev)
    ev = {e.name: e for e in prof.events() if e.name in ("outer 1", "inner")}
    assert set(ev) == {"outer 1", "inner"}
    assert not ev["outer 1"].is_user_annotation
    assert not ev["inner"].is_user_annotation
    assert ev["inner"].cpu_parent.name == "outer 1"
    assert any(c.name == "aten::sum" for c in ev["inner"].cpu_children)
