"""The brute-force kNN's own measurement (raft_tpu_torch.spatial.knn_obs,
on the range layer raft_tpu_torch.core.annotate) on the CPU: one
``knn.search`` range a call with the phases of its route nested in it,
under a plain ``torch.profiler`` capture; none entered with the gate
closed and no capture; the counters of partitions searched and of
rescores by route; and no ``knn.*`` range inside an IVF search.

The fused route runs its kernels' plain versions here.
"""

import importlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raft_tpu_torch.obs import default_registry
from raft_tpu_torch.obs import metrics as obs_metrics
from raft_tpu_torch.spatial import brute_force_knn
from raft_tpu_torch.spatial.ann import (
    IVFFlatParams,
    IVFPQParams,
    ivf_flat_build,
    ivf_flat_search_grouped,
    ivf_pq_build,
    ivf_pq_search_grouped,
)

tann = importlib.import_module("raft_tpu_torch.core.annotate")

torch.set_num_threads(1)

K = 5
NQ = 16
PHASES = ("knn.chunk_mins", "knn.select", "knn.rescore", "knn.scan")


def _data(d, n=4096, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, d, generator=g), torch.randn(NQ, d, generator=g)


def _counter(name, route):
    return sum(c.value for c in default_registry().series(name)
               if c.labels.get("route") == route)


def _captured(fn, calls=2):
    prev = tann.set_profiling(False)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(calls):
                fn()
    finally:
        tann.set_profiling(prev)
    return [e for e in prof.events() if e.name.startswith("knn.")]


def _enclosing(e, name):
    p = e.cpu_parent
    while p is not None and p.name != name:
        p = p.cpu_parent
    return p


ROUTES = {
    # (width, brute_force_knn keywords) -> the phases a call holds
    "fused-kernel": (128, {"use_fused": True, "compute_dtype": torch.bfloat16,
                           "extra_chunks": 32},
                     {"knn.chunk_mins": 1, "knn.select": 2, "knn.rescore": 1}),
    # width 96 rescores by the torch gather, one block of bq2 = 40 queries
    "fused-gather": (96, {"use_fused": True},
                     {"knn.chunk_mins": 1, "knn.select": 2, "knn.rescore": 1}),
    "scan": (128, {"use_fused": False}, {"knn.scan": 1}),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_phase_ranges_nested_under_one_entry_a_call(route):
    d, kw, phases = ROUTES[route]
    x, q = _data(d)
    events = _captured(lambda: brute_force_knn(x, q, K, **kw))
    assert events and not any(e.is_user_annotation for e in events)
    assert sum(e.name == "knn.search" for e in events) == 2
    counts = {}
    for e in events:
        if e.name in PHASES:
            assert _enclosing(e, "knn.search") is not None, e.name
            counts[e.name] = counts.get(e.name, 0) + 1
    assert counts == {p: 2 * n for p, n in phases.items()}


def test_no_record_function_with_the_gate_closed(monkeypatch):
    """With the gate closed and no capture running, no search enters a
    record function; with the gate open, every range does."""
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
        for d, kw, _ in ROUTES.values():
            x, q = _data(d)
            brute_force_knn(x, q, K, **kw)
        assert entered == []
        tann.set_profiling(True)
        d, kw, _ = ROUTES["fused-kernel"]
        x, q = _data(d)
        brute_force_knn(x, q, K, **kw)
        assert entered == ["knn.search", "knn.chunk_mins", "knn.select",
                           "knn.rescore", "knn.select"]
    finally:
        tann.set_profiling(prev)


def test_counters_by_route():
    """One ``knn_search_calls_total`` a partition searched, by route; one
    ``knn_rescore_calls_total`` a fused search, by its rescore's route;
    the obs gate stops both."""
    x128, q128 = _data(128, n=8192)
    x96, q96 = _data(96)
    names = ("knn_search_calls_total", "knn_rescore_calls_total")
    keys = [(names[0], "fused"), (names[0], "scan"), (names[1], "kernel"),
            (names[1], "gather")]

    def read():
        return [_counter(n, r) for n, r in keys]

    before = read()
    brute_force_knn([x128[:4096], x128[4096:]], q128, K, use_fused=True)
    brute_force_knn(x128, q128, K, use_fused=False)
    brute_force_knn(x96, q96, K, use_fused=True)
    got = [a - b for a, b in zip(read(), before)]
    assert got == [3, 1, 2, 1]
    prev = obs_metrics.set_enabled(False)
    try:
        brute_force_knn(x128, q128, K, use_fused=True)
    finally:
        obs_metrics.set_enabled(prev)
    assert [a - b for a, b in zip(read(), before)] == got


def test_no_knn_range_inside_an_ivf_search():
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((2048, 16)).astype(np.float32))
    q = torch.as_tensor(rng.standard_normal((NQ, 16)).astype(np.float32))
    cpu = torch.device("cpu")
    flat = ivf_flat_build(x, IVFFlatParams(n_lists=8, kmeans_n_iters=2,
                                           kmeans_init="random", seed=1), device=cpu)
    pq = ivf_pq_build(x, IVFPQParams(n_lists=8, pq_dim=4, pq_bits=4, kmeans_n_iters=2,
                                     pq_kmeans_n_iters=2, kmeans_init="random",
                                     store_raw=True, seed=1), device=cpu)

    def searches():
        for use_kernel in (True, False):
            ivf_flat_search_grouped(flat, q, K, n_probes=2, qcap=NQ, use_kernel=use_kernel)
            ivf_pq_search_grouped(pq, q, K, n_probes=2, qcap=NQ, refine_ratio=2.0,
                                  use_kernel=use_kernel)

    prev = tann.set_profiling(False)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            searches()
    finally:
        tann.set_profiling(prev)
    names = {e.name for e in prof.events()}
    assert {"ivf_flat.search", "ivf_pq.search"} <= names
    assert not any(n.startswith("knn.") for n in names)
