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
from raft_tpu_torch.distance.distance_type import DistanceType, resolve_metric
from raft_tpu_torch.distance.pairwise import pairwise_distance, sqrt_f64
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


# the squared and the rooted L2 metrics, whose stitching weights come
# straight from connect_components' squared distances
_L2_SQUARED = (DistanceType.L2Expanded, DistanceType.L2Unexpanded)
_L2_ROOTED = (DistanceType.L2SqrtExpanded, DistanceType.L2SqrtUnexpanded)
# pairs a block of the non-L2 stitching weights carries
_PAIR_BLOCK = 256


def stitch_weights(x, rows, cols, sq_dist, metric):
    """The stitching edges' weights in the graph's metric: the squared
    L2 distance ``sq_dist`` as it is for the squared metrics, its root
    (taken in f64, as ``fused_l2_nn(sqrt=True)`` takes it) for the
    rooted ones, else ``metric`` on each pair's two rows through
    :func:`~raft_tpu_torch.distance.pairwise.pairwise_distance` (the
    diagonals of blocks of pairs)."""
    metric = resolve_metric(metric)
    if metric in _L2_SQUARED:
        return sq_dist
    if metric in _L2_ROOTED:
        return sqrt_f64(torch.clamp_min(sq_dist, 0.0))
    a, b = x[rows.long()], x[cols.long()]
    return torch.cat([
        torch.diagonal(pairwise_distance(a[s:s + _PAIR_BLOCK],
                                         b[s:s + _PAIR_BLOCK], metric))
        for s in range(0, rows.shape[0], _PAIR_BLOCK)]).to(sq_dist.dtype)


def first_of_pairs(rows, cols, valid, n: int):
    """Which entries are the first of their undirected (min, max) pair
    among the valid ones: a stable sort of the pair keys and a mask of
    repeats, on the device (no host sync)."""
    r, c = rows.long(), cols.long()
    key = torch.where(valid, torch.minimum(r, c) * n + torch.maximum(r, c),
                      torch.full_like(r, -1))
    skey, order = torch.sort(key, stable=True)
    first = torch.ones_like(skey, dtype=torch.bool)
    first[1:] = skey[1:] != skey[:-1]
    keep = torch.zeros_like(first)
    keep[order] = first
    return keep & valid


def build_sorted_mst(x, graph: COO, *, metric="l2_sqrt_expanded",
                     max_iter: int = 32, stats: Optional[dict] = None):
    """The MST with the connect-components fixup loop (reference
    hierarchy/detail/mst.cuh build_sorted_mst: solve; while the forest
    has more than one component, add each component's nearest
    cross-component edge, mirrored, and solve again). Returns numpy
    (src, dst, weight), stably sorted by weight.

    The stitching edges are weighted in ``metric``, the graph's (see
    :func:`stitch_weights`), and an undirected edge that two components
    both pick enters the graph once in each direction, so the merge
    order is scipy's single-linkage order. (The JAX package adds
    ``connect_components``' squared distances and sums a twice-picked
    edge with its mirror.) The edges themselves are
    ``connect_components``', unchanged.

    ``stats``, a dict, receives ``mst`` (each solve's
    :func:`~raft_tpu_torch.sparse.mst.boruvka_mst` stats and seconds),
    ``connect_s`` (each round's ``connect_components`` seconds; with
    ``stats`` the device is synchronized around each step),
    ``connect_rounds`` and ``component_syncs`` (the host reads of the
    component count, one a round), ``forest_edges`` /
    ``forest_weight`` / ``forest_color``, the first solve's forest: the
    graph's own edges, without the stitching ones, ``stitches``, each
    round's edges as numpy ``(rows, cols, weights, repeats)``: the edges
    entered, and how many entries picked a pair again, and
    ``mst_edges``, the returned (src, dst, weight)."""
    dev = graph.rows.device
    x = as_tensor(x, dev)
    n = graph.shape[0]
    solves, connect_s, stitches = [], [], []

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
            mst.weight[:n_forest].double().sum()),
            forest_color=mst.color.cpu().numpy())
    it = 0
    count_syncs = 1
    n_comp = int(get_n_components(mst.color))
    while n_comp > 1 and it < max_iter:
        t0 = clock()
        extra = connect_components(x, mst.color)
        connect_s.append(clock() - t0)
        # one edge a colour: the first n_comp entries hold them all
        e_rows, e_cols = extra.rows[:n_comp], extra.cols[:n_comp]
        keep = first_of_pairs(e_rows, e_cols,
                              extra.valid_mask()[:n_comp], n)
        w = stitch_weights(x, e_rows, e_cols, extra.vals[:n_comp], metric)
        if stats is not None:
            k = keep.cpu().numpy()
            stitches.append((e_rows.cpu().numpy()[k], e_cols.cpu().numpy()[k],
                             w.cpu().numpy()[k],
                             int(extra.nnz) - int(k.sum())))
        # the kept edges and their mirrors into the graph
        valid = torch.cat([graph.valid_mask(), keep, keep])
        order = torch.sort((~valid).to(torch.uint8), stable=True)[1]

        def merged(*parts):
            cat = torch.cat(parts)
            return torch.where(valid, cat, torch.zeros_like(cat))[order]

        graph = sum_duplicates(COO(
            merged(graph.rows, e_rows, e_cols),
            merged(graph.cols, e_cols, e_rows),
            merged(graph.vals, w, w),
            (graph.nnz + 2 * keep.sum()).to(torch.int32), graph.shape))
        mst = solve(graph)
        it += 1
        count_syncs += 1
        n_comp = int(get_n_components(mst.color))

    k = int(mst.n_edges)
    src = mst.src[:k].cpu().numpy()
    dst = mst.dst[:k].cpu().numpy()
    w = mst.weight[:k].cpu().numpy()
    order = np.argsort(w, kind="stable")
    out = src[order], dst[order], w[order]
    if stats is not None:
        stats.update(mst=solves, connect_s=connect_s, connect_rounds=it,
                     component_syncs=count_syncs, stitches=stitches,
                     mst_edges=out)
    return out


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
    -> sorted MST (+ stitching in ``metric``) -> host dendrogram -> flat
    labels, merged in scipy's single-linkage order.

    ``graph`` replaces the kNN graph; its values are distances in
    ``metric``. Runs on
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
    src, dst, w = build_sorted_mst(x, graph, metric=metric, stats=stats)
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
