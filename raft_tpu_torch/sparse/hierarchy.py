"""Single-linkage hierarchical clustering of the port — the counterpart of
``raft_tpu/sparse/hierarchy.py`` (analog of
``raft::hierarchy::single_linkage``,
cpp/include/raft/sparse/hierarchy/detail/single_linkage.cuh:54-119:
get_distance_graph -> build_sorted_mst (+ connect_components fixup,
detail/mst.cuh) -> build_dendrogram_host (detail/agglomerative.cuh, a
host union-find) -> extract_flattened_clusters).

The kNN graph, the MST and the cross-component stitching run on the
call's device; the dendrogram walk and the cut run on the host, through
the port's native library (:mod:`raft_tpu_torch.native`) or, when it is
unavailable, the numpy union-find (counted in
``native.NATIVE_FALLBACKS``), the boundary the JAX package draws.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from raft_tpu_torch import errors, native
from raft_tpu_torch.core.device import as_tensor, call_device
from raft_tpu_torch.sparse.connect import connect_components, get_n_components
from raft_tpu_torch.sparse.coo import COO
from raft_tpu_torch.sparse.knn_graph import knn_graph
from raft_tpu_torch.sparse.mst import boruvka_mst
from raft_tpu_torch.sparse.op import sum_duplicates

__all__ = [
    "LinkageResult",
    "build_sorted_mst",
    "build_dendrogram_host",
    "extract_flattened_clusters",
    "single_linkage",
]


class LinkageResult(NamedTuple):
    """Analog of raft::hierarchy::linkage_output (hierarchy/common.h)."""

    labels: torch.Tensor   # (n,) int32 flat labels, on the call's device
    children: np.ndarray   # (n-1, 2) merge tree (scipy convention)
    deltas: np.ndarray     # (n-1,) merge distances
    sizes: np.ndarray      # (n-1,) merged cluster sizes
    n_clusters: int


def _clock(dev: torch.device, timed: bool) -> float:
    """The host clock, after the device's queued work when ``timed``."""
    if timed and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def build_sorted_mst(x, graph: COO, *, max_iter: int = 32,
                     stats: Optional[dict] = None):
    """The MST with the connect-components fixup loop (reference
    hierarchy/detail/mst.cuh build_sorted_mst: solve; while the forest
    has more than one component, add each component's nearest
    cross-component edge, mirrored, and solve again). Returns numpy
    (src, dst, weight), stably sorted by weight.

    As in the JAX package the added edges go through ``sum_duplicates``,
    so an edge that two components both pick (and that is therefore
    added twice in each direction) carries twice its distance.

    ``stats``, a dict, receives ``mst`` (each solve's
    :func:`~raft_tpu_torch.sparse.mst.boruvka_mst` stats and seconds),
    ``connect_s`` (each round's ``connect_components`` seconds; with
    ``stats`` the device is synchronized around each step),
    ``connect_rounds`` and ``component_syncs`` (the host reads of the
    component count, one a round), and ``forest_edges`` /
    ``forest_weight``, the first solve's forest: the graph's own edges,
    without the stitching ones."""
    dev = graph.rows.device
    x = as_tensor(x, dev)
    solves, connect_s = [], []

    def clock():
        return _clock(dev, stats is not None)

    def solve(g):
        s = {}
        t0 = clock()
        out = boruvka_mst(g, stats=s)
        s["seconds"] = clock() - t0
        solves.append(s)
        return out

    mst = solve(graph)
    if stats is not None:
        # the graph's own spanning forest, before any stitching edge
        n_forest = int(mst.n_edges)
        stats.update(forest_edges=n_forest, forest_weight=float(
            mst.weight[:n_forest].double().sum()))
    it = 0
    count_syncs = 1
    while int(get_n_components(mst.color)) > 1 and it < max_iter:
        t0 = clock()
        extra = connect_components(x, mst.color)
        connect_s.append(clock() - t0)
        # the extra edges and their mirrors into the graph
        valid = torch.cat([graph.valid_mask(), extra.valid_mask(),
                           extra.valid_mask()])
        order = torch.sort((~valid).to(torch.uint8), stable=True)[1]

        def merged(*parts):
            cat = torch.cat(parts)
            return torch.where(valid, cat, torch.zeros_like(cat))[order]

        graph = sum_duplicates(COO(
            merged(graph.rows, extra.rows, extra.cols),
            merged(graph.cols, extra.cols, extra.rows),
            merged(graph.vals, extra.vals, extra.vals),
            (graph.nnz + 2 * extra.nnz).to(torch.int32), graph.shape))
        mst = solve(graph)
        it += 1
        count_syncs += 1

    k = int(mst.n_edges)
    src = mst.src[:k].cpu().numpy()
    dst = mst.dst[:k].cpu().numpy()
    w = mst.weight[:k].cpu().numpy()
    order = np.argsort(w, kind="stable")
    if stats is not None:
        stats.update(mst=solves, connect_s=connect_s, connect_rounds=it,
                     component_syncs=count_syncs)
    return src[order], dst[order], w[order]


def _fallback() -> None:
    native.NATIVE_FALLBACKS += 1


def build_dendrogram_host(src, dst, weights, n: int):
    """Agglomerative merge of weight-sorted MST edges on the host
    (reference detail/agglomerative.cuh build_dendrogram_host). Returns
    (children (n-1, 2), deltas, sizes) in the scipy convention: the
    i-th merge makes cluster n + i."""
    if native.available():
        return native.dendrogram(np.ascontiguousarray(src, np.int32),
                                 np.ascontiguousarray(dst, np.int32),
                                 np.ascontiguousarray(weights, np.float32),
                                 n)
    _fallback()
    parent = np.arange(2 * n - 1, dtype=np.int64)

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    children = np.zeros((n - 1, 2), np.int64)
    deltas = np.zeros(n - 1, np.float64)
    sizes = np.zeros(n - 1, np.int64)
    cluster_size = np.ones(2 * n - 1, np.int64)
    nxt = n
    for e in range(len(src)):
        a = find(src[e])
        b = find(dst[e])
        if a == b:
            continue
        children[nxt - n] = (a, b)
        deltas[nxt - n] = weights[e]
        cluster_size[nxt] = cluster_size[a] + cluster_size[b]
        sizes[nxt - n] = cluster_size[nxt]
        parent[a] = nxt
        parent[b] = nxt
        nxt += 1
    return children[: nxt - n], deltas[: nxt - n], sizes[: nxt - n]


def extract_flattened_clusters(children, n: int,
                               n_clusters: int) -> np.ndarray:
    """Cut the dendrogram into ``n_clusters`` flat labels (reference
    detail/agglomerative.cuh extract_flattened_clusters): undo the last
    n_clusters - 1 merges, label the remaining trees, relabel by first
    occurrence. Returns int32 labels."""
    if native.available():
        return native.extract_flat(np.ascontiguousarray(children, np.int64),
                                   n, n_clusters)
    _fallback()
    n_merges = len(children) - (n_clusters - 1)
    parent = np.arange(2 * n - 1, dtype=np.int64)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for e in range(max(n_merges, 0)):
        a, b = children[e]
        parent[find(a)] = find(n + e)
        parent[find(b)] = find(n + e)
    roots = np.array([find(i) for i in range(n)])
    # monotonic relabel (reference label/classlabels.cuh make_monotonic)
    _, labels = np.unique(roots, return_inverse=True)
    order = np.zeros(labels.max() + 1, np.int64) - 1
    out = np.zeros(n, np.int32)
    nxt = 0
    for i in range(n):
        if order[labels[i]] < 0:
            order[labels[i]] = nxt
            nxt += 1
        out[i] = order[labels[i]]
    return out


def single_linkage(x, n_clusters: int = 2, *, graph: Optional[COO] = None,
                   k: int = 16, metric="l2_sqrt_expanded",
                   stats: Optional[dict] = None,
                   device=None) -> LinkageResult:
    """The pipeline (reference single_linkage.cuh:54): kNN distance graph
    -> sorted MST (+ stitching) -> host dendrogram -> flat labels.

    ``graph`` replaces the kNN graph. Runs on
    ``device`` when given, else on ``x``'s device if it is a tensor,
    else on CUDA (raising without it). ``stats``, a dict, receives the
    seconds of each stage (``knn_graph_s``, ``mst_s``, ``dendrogram_s``,
    ``total_s``; the device is synchronized at each boundary) and
    :func:`build_sorted_mst`'s stats."""
    dev = call_device(x, device=device)
    x = as_tensor(x, dev)
    errors.check_matrix(x, "x", min_rows=2)
    n = x.shape[0]
    errors.check_k(n_clusters, n, "n_clusters vs n rows")

    timed = stats is not None
    t0 = _clock(dev, timed)
    if graph is None:
        graph = knn_graph(x, min(k, n - 1), metric=metric)
    t1 = _clock(dev, timed)
    src, dst, w = build_sorted_mst(x, graph, stats=stats)
    t2 = time.perf_counter()
    children, deltas, sizes = build_dendrogram_host(src, dst, w, n)
    labels = extract_flattened_clusters(children, n, n_clusters)
    t3 = time.perf_counter()
    if stats is not None:
        stats.update(knn_graph_s=t1 - t0, mst_s=t2 - t1,
                     dendrogram_s=t3 - t2, total_s=t3 - t0)
    return LinkageResult(
        torch.as_tensor(labels, device=dev), np.asarray(children),
        np.asarray(deltas), np.asarray(sizes), n_clusters,
    )
