"""The graph index as the ``sift1m-graph`` configuration runs it, at a
small size on the CPU: ``graph_build`` and ``graph_search`` held to the
benchmark's plain reference (``benchmark/reference/graph_walk.py``), the
device form of the reachability patch held to its plain version
``graph._patch_reachability_plain``, the walk's ranges and counters, and
the cell's engine adapter through the harness.

Tolerances, and why:

* on integer-valued rows (a 16-centre mixture with integer centres and
  integer noise) every f32 sum of the build and the walk is exact, so the
  port's adjacency equals the reference's row for row and the walk's
  distances and ids equal the reference's bit for bit (the exact engine
  keeps the reference's order of equal distances; the kernel engine
  orders its new candidates by sub-chunk, so its ids are equal up to
  ties);
* on Gaussian rows the port scores in f32 and the reference in f64: a
  squared distance may differ by the f32 summation bound of the gram
  form, 2 d 2^-24 (‖q‖² + ‖y‖² + 2 ‖q‖ ‖y‖), plus the rounding of the
  root and its square (4 · 2^-24 of the distance); ids are equal up to
  ties within that bound;
* the device patch is bitwise its plain version: the same comparisons of
  the same f32 difference-form distances.
"""

import json

import numpy as np
import pytest
import torch

from benchmark import data, judge, run
from benchmark.engines import graph as engine
from benchmark.reference import graph_walk as ref
from benchmark.spec import Bench
from benchmark.tests.conftest import make_tiny_root
from raft_tpu_torch.core.annotate import set_profiling
from raft_tpu_torch.obs.metrics import default_registry
from raft_tpu_torch.spatial.ann import GraphParams, graph_build, graph_search
from raft_tpu_torch.spatial.ann import graph as tgraph
from raft_tpu_torch.spatial.ann import search_obs
from raft_tpu_torch.spatial.selection import SELECT_K_MAX_ROW

torch.set_num_threads(1)

CPU = torch.device("cpu")
N, D, NQ, K = 3000, 32, 64, 10


def _integer_mixture(seed, n=N, d=D, centres=16):
    """Distinct integer-valued rows around integer centres, and integer
    queries from the same mixture."""
    rng = np.random.default_rng(seed)
    cen = rng.integers(-8, 9, (centres, d))
    rows = np.unique(cen[rng.integers(0, centres, 2 * n)]
                     + rng.integers(-3, 4, (2 * n, d)), axis=0)
    rows = rows[rng.permutation(rows.shape[0])[:n]].astype(np.float32)
    q = (cen[rng.integers(0, centres, NQ)]
         + rng.integers(-3, 4, (NQ, d))).astype(np.float32)
    return rows, q


def _gaussian_mixture(seed, n=N, d=D, centres=16):
    rng = np.random.default_rng(seed)
    cen = 2.0 * rng.standard_normal((centres, d))
    x = (cen[rng.integers(0, centres, n)] + rng.standard_normal((n, d))).astype(np.float32)
    q = (cen[rng.integers(0, centres, NQ)] + rng.standard_normal((NQ, d))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module", params=[(16, 32), (64, 128)], ids=["deg16", "deg64"])
def integer_build(request):
    deg, idg = request.param
    x, q = _integer_mixture(5)
    index = graph_build(x, GraphParams(degree=deg, intermediate_degree=idg, seed=0,
                                       n_entry=4), metric="l2", device=CPU)
    want = ref.build(x, deg, idg, 0, 4)
    return x, q, index, want


def _walk_ref(x, index, q, beam, iters):
    adj = index.storage.adjacency.numpy()[:-1].astype(np.int64)
    entries = index.storage.entries.numpy()
    return [ref.walk(x, adj, entries, q[r], K, beam, iters) for r in range(q.shape[0])]


def _tie_groups_agree(dists, got, want, tol):
    """ids equal up to ties: within each run of reference distances closer
    than ``tol``, the same set of ids; the run cut by the k-th place is
    left to the distance check."""
    start = 0
    for end in range(1, K + 1):
        if end == K or dists[end] - dists[start] > tol[start]:
            if end < K or start == 0:
                if set(got[start:end]) != set(want[start:end]):
                    return False
            start = end
    return True


def test_build_equals_the_reference_row_for_row(integer_build):
    x, _, index, (adj, entries, counts) = integer_build
    np.testing.assert_array_equal(index.storage.entries.numpy(), entries)
    np.testing.assert_array_equal(index.storage.adjacency.numpy()[:-1], adj)
    assert (index.storage.adjacency.numpy()[-1] == -1).all()
    st = index.build_stats
    assert {k: st[k] for k in counts} == counts
    assert counts["patch_edges"] > 0 and len(counts["patch_misses"]) >= 1


@pytest.mark.parametrize("beam", [16, 32])
def test_walk_equals_the_reference_on_integer_rows(integer_build, beam):
    x, q, index, _ = integer_build
    iters = index.warmup(NQ, k=K, beam=beam)
    assert iters == tgraph._auto_iters(N)
    d, i = graph_search(index, q, K, beam=beam, iters=iters)
    dk, ik = graph_search(index, q, K, beam=beam, iters=iters, use_kernel=True)
    want = _walk_ref(x, index, q, beam, iters)
    ref_d = np.stack([np.sqrt(w[0]) for w in want]).astype(np.float32)
    ref_i = np.stack([w[1] for w in want])
    np.testing.assert_array_equal(d.numpy(), ref_d)
    np.testing.assert_array_equal(i.numpy(), ref_i)
    np.testing.assert_array_equal(dk.numpy(), ref_d)
    zero = np.zeros(K)
    assert all(_tie_groups_agree(ref_d[r], ik.numpy()[r], ref_i[r], zero)
               for r in range(NQ))


def test_walk_agrees_with_the_reference_on_gaussian_rows():
    x, q = _gaussian_mixture(6)
    index = graph_build(x, GraphParams(degree=16, intermediate_degree=32, seed=0,
                                       n_entry=4), metric="l2", device=CPU)
    iters = index.warmup(NQ, k=K, beam=32)
    d, i = graph_search(index, q, K, beam=32, iters=iters)
    want = _walk_ref(x, index, q, 32, iters)
    got2 = d.double().numpy() ** 2
    for r, (wd, wi) in enumerate(want):
        y = x[wi].astype(np.float64)
        qn, yn = float((q[r].astype(np.float64) ** 2).sum()), (y * y).sum(1)
        tol = (2 * D * 2.0**-24 * (qn + yn + 2 * np.sqrt(qn * yn))
               + 4 * 2.0**-24 * wd)
        assert (np.abs(got2[r] - wd) <= tol).all(), r
        assert _tie_groups_agree(wd, i.numpy()[r], wi, tol), r


# -- the device form of the patch against the plain one ----------------------

def _both_patches(adj, entries, x, top=64):
    want = tgraph._patch_reachability_plain(adj, entries, x)
    got = tgraph._patch_reachability(adj, entries, x, top=top)
    assert torch.equal(got[0], want[0])
    assert got[1] == want[1]
    return want


@pytest.mark.parametrize("top,tile", [(64, None), (4, 9), (1, 1)])
def test_device_patch_cascades_like_the_plain_one(top, tile, monkeypatch):
    """A 16-centre Gaussian mixture cut into one component a cluster by a
    cluster-local graph of degree 4, two entries: the patch fills slots,
    cuts rows off by overwriting and cascades over several rounds; with
    the selection's row cap patched to ``tile`` the candidates are
    chosen a tile at a time and merged."""
    if tile:
        monkeypatch.setattr(tgraph, "SELECT_K_MAX_ROW", tile)
    rng = np.random.default_rng(8)
    n, d, c = 2000, 16, 16
    lab = rng.integers(0, c, n)
    x = (3.0 * rng.standard_normal((c, d)))[lab] + rng.standard_normal((n, d))
    adj = np.full((n, 4), -1, np.int32)
    for ci in range(c):
        members = np.flatnonzero(lab == ci)
        adj[members] = members[rng.integers(0, members.size, (members.size, 4))]
    entries = np.array([3, 77], np.int32)
    want = _both_patches(torch.as_tensor(adj), entries,
                         torch.as_tensor(x.astype(np.float32)), top=top)
    assert len(want[1]["patch_misses"]) >= 2


def test_device_patch_selects_over_tiles_past_the_row_cap():
    """51,000 reached rows with free slots (a binary tree from row 0),
    past the selection kernel's row cap, so the candidates are chosen a
    tile at a time and merged; 1,000 unreached rows."""
    rng = np.random.default_rng(9)
    n, reach = 52_000, 51_000
    assert reach > SELECT_K_MAX_ROW
    x = torch.as_tensor(rng.standard_normal((n, 4)).astype(np.float32))
    adj = np.full((n, 3), -1, np.int32)
    child = np.arange(reach)[:, None] * 2 + np.array([1, 2])
    adj[:reach, :2] = np.where(child < reach, child, -1)
    want = _both_patches(torch.as_tensor(adj), np.array([0], np.int32), x)
    assert want[1]["patch_misses"][0] == n - reach


def test_device_patch_leaves_rows_when_every_slot_is_claimed():
    """Degree 1: each claim overwrites the only edge of its row and cuts
    off what lay behind it, until every reached row is fully claimed with
    rows still unreached (five rounds); both versions stop there."""
    x = torch.tensor([[12.0], [10.0], [5.0], [6.0], [0.0], [1.0], [0.0], [3.0]])
    adj = torch.tensor([[6], [4], [7], [3], [4], [7], [5], [4]], dtype=torch.int32)
    want = _both_patches(adj, np.array([0], np.int32), x)
    final = tgraph._reached(want[0].numpy(), np.array([0]))
    assert final.tolist() == [True] * 5 + [False] * 3
    assert want[1]["patch_misses"] == [3, 5, 4, 4, 3]


# -- the walk's ranges and counters -------------------------------------------

def _slots():
    return {c.labels["kind"]: c.value
            for c in default_registry().series(search_obs.GRAPH_SLOTS)}


def _calls(engine_name):
    return sum(c.value for c in default_registry().series("graph_search_calls_total")
               if c.labels.get("engine") == engine_name)


@pytest.fixture(scope="module")
def small_index():
    x, q = _gaussian_mixture(7, n=1500, d=16)
    return graph_build(x, GraphParams(degree=16, intermediate_degree=32), device=CPU), q


def test_ranges_nest_in_the_search(small_index):
    index, q = small_index
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        graph_search(index, q, K, beam=16, iters=5)
    ev = [e for e in prof.events() if e.name.startswith("graph.")]
    names = [e.name for e in ev]
    assert names.count("graph.search") == 1
    for phase in ("graph.frontier", "graph.scan", "graph.merge"):
        assert names.count(phase) == 5
    assert names.count("graph.rerank") == 1
    (entry,) = [e for e in ev if e.name == "graph.search"]
    for e in ev:
        assert entry.time_range.start <= e.time_range.start
        assert e.time_range.end <= entry.time_range.end


def test_slot_counts_cover_every_slot_and_skip_warmups(small_index):
    index, q = small_index
    degree = index.storage.degree
    prev = set_profiling(True)
    try:
        before = _slots()
        index.warmup(NQ, k=K, beam=16, iters=6)
        assert _slots() == before
        graph_search(index, q, K, beam=16, iters=6)
        after = _slots()
    finally:
        set_profiling(prev)
    delta = {k: after[k] - before.get(k, 0) for k in after}
    assert set(delta) == {"new", "dup", "visited", "sentinel"}
    assert sum(delta.values()) == 16 * degree * 6 * NQ
    assert min(delta.values()) >= 0 and delta["new"] > 0
    # without ranges nothing is counted
    graph_search(index, q, K, beam=16, iters=6)
    assert _slots() == after


def test_engine_counters_and_fallbacks(small_index):
    index, q = small_index
    fallbacks = tgraph.ENGINE_FALLBACKS
    exact, kernel = _calls("exact"), _calls("kernel")
    host = search_obs.graph_engines("exact", "host")
    graph_search(index, q, K)
    graph_search(index, q, K, use_kernel=True)
    assert _calls("exact") == exact + 1 and _calls("kernel") == kernel + 1
    assert search_obs.graph_engines("exact", "host") == host + 1
    assert tgraph.ENGINE_FALLBACKS == fallbacks
    # a CUDA index the kernel cannot serve: a fallback, read from the
    # counter's exact/fallback series
    assert tgraph._resolve_beam_engine(None, 100_000, 512, torch.device("cuda")) is False
    assert tgraph.ENGINE_FALLBACKS == fallbacks + 1
    assert search_obs.graph_engines("exact", "fallback") == tgraph.ENGINE_FALLBACKS


# -- the cell's adapter through the harness -----------------------------------

CFG = {"n_rows": 4000, "dim": 32, "n_queries": 256, "k": K,
       "data": {"kind": "gaussian_mixture", "n_centres": 64, "centre_spread": 2.0,
                "noise": 1.0, "seed": 19},
       "index": {"degree": 16, "intermediate_degree": 32, "seed": 0, "n_entry": 4},
       "search": {"beam": 32}}


def test_engine_adapter_agrees_with_the_direct_calls_and_the_judge():
    x, q = data.make(CFG, 2**31 + 7, CPU)
    index = engine.build(x, CFG, 0, CPU)
    direct = graph_build(x, GraphParams(degree=16, intermediate_degree=32, seed=0,
                                        n_entry=4), metric="l2", device=CPU)
    assert torch.equal(index.storage.adjacency, direct.storage.adjacency)
    d, i = engine.search_fn(index, CFG, 256)(q)
    want_d, want_i = graph_search(direct, q, K, beam=32,
                                  iters=tgraph._auto_iters(CFG["n_rows"]))
    assert torch.equal(d, want_d) and torch.equal(i, want_i)
    verdict = judge.judge(x, q, [((torch.arange(256), d, i), 1)], k=K,
                          distance=engine.DISTANCE, limits={"dist_gap": 1e-4})
    assert verdict["correct"] and verdict["checks"]["dist_gap"]["value"] <= 1e-6
    assert verdict["recall"] >= 0.9
    ys = engine.yardstick(index, CFG)
    assert set(ys["build_stats"]) >= {"knn_graph_s", "prune_s", "patch_s"}


def test_the_cell_runs_through_the_harness(tmp_path):
    """A tiny copy of the cell, run by ``benchmark.run`` on the CPU: the
    end-to-end metrics untraced; traced, the per-layer metrics that read
    the program's counters and the build (the span readers need device
    activity, which the CPU has none of)."""
    root = make_tiny_root(tmp_path, dim=16, n_rows=2000)
    cfgs = root / "benchmark" / "configs"
    cfg = json.loads((cfgs / "sift1m-graph.json").read_text())
    cfg.update(n_rows=3000, dim=32, n_queries=256,
               index=dict(cfg["index"], degree=16, intermediate_degree=32))
    (cfgs / "tiny-graph.json").write_text(json.dumps(cfg))
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "tiny-graph", "source": "tests", "reduced": [],
                           "why": "tests", "file": "benchmark/configs/tiny-graph.json"})
    doc["workloads"].append({"name": "tiny-graph.batch", "config": "tiny-graph",
                             "traffic": "tiny_batch", "chips": 1, "why": "tests"})
    for m in doc["end_to_end"] + doc["per_layer"]:
        if "sift1m-graph.batch" in m.get("workloads", []):
            m["workloads"].append("tiny-graph.batch")
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    bench = Bench(root)
    out = run.run_cell(bench, "tiny-graph.batch", seed=2**31 + 3, seconds=0.5,
                       trace_on=False, device=CPU)
    assert out["correct"] and set(out["metrics"]) == {"qps", "recall_at_10", "build_s",
                                                      "setup_s"}
    out = run.run_cell(bench, "tiny-graph.batch", seed=2**31 + 3, seconds=0.5,
                       trace_on=True, device=CPU)
    assert out["correct"]
    assert set(out["metrics"]) == {"graph.new_slots_pct", "build.graph_patch_s"}
    assert 0 < out["metrics"]["graph.new_slots_pct"]["value"] < 100
