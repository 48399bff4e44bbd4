"""Brute-force k-nearest-neighbours of the port — the counterpart of
``raft_tpu/spatial/knn.py`` (the analog of the reference kNN layer,
cpp/include/raft/spatial/knn/knn.cuh:195+ ``brute_force_knn``,
detail/knn_brute_force_faiss.cuh:220-395, detail/haversine_distance.cuh,
detail/epsilon_neighborhood.cuh).

Two paths per index partition:

* the **fused path** (:func:`~raft_tpu_torch.spatial.fused_knn.fused_l2_knn`,
  the CUDA chunk-min and rescore kernels) for large L2-family searches of
  a CUDA partition on a capability-9.0 card;
* the **scan path** (:func:`_knn_single_part`) for every metric: blocks
  of index rows, each block's distances, an exact per-block top-k, and a
  running merge, so the (m, n) distance matrix never exists.

Partitions are searched one by one and merged with their id
translations (:func:`knn_merge_parts`).
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple, Union

import torch

from raft_tpu_torch import errors
from raft_tpu_torch.core.device import as_tensor, call_device, hopper_device
from raft_tpu_torch.distance.distance_type import (
    EXPANDED_METRICS, DistanceType, resolve_metric,
)
from raft_tpu_torch.distance.pairwise import (
    _expanded_impl, _unexpanded_impl, haversine_distance,
)
from raft_tpu_torch.spatial.fused_knn import (
    fused_grid_ok, fused_knn_supported, fused_l2_knn,
)
from raft_tpu_torch.spatial.selection import (
    chunk_min_select_k, merge_topk, select_k,
)

__all__ = [
    "brute_force_knn",
    "knn_merge_parts",
    "haversine_knn",
    "epsilon_neighborhood",
]

logger = logging.getLogger("raft_tpu_torch")

# CUDA partitions that use_fused=None would have sent to the fused kernels
# but that fused_grid_ok sent to the scan path (the phase-1 grid is past
# the launch limit)
SCAN_FALLBACKS = 0
_scan_fallback_warned = False

# the fused path pays off from this many index rows (the JAX rule)
_FUSED_MIN_ROWS = 65536


def _block_dist(queries, yblk, metric, p):
    if metric == DistanceType.Haversine:
        return haversine_distance(queries, yblk)
    if metric in EXPANDED_METRICS:
        return _expanded_impl(metric, queries, yblk, None)
    return _unexpanded_impl(metric, queries, yblk, p, None)


def _knn_single_part(queries, index, k: int, metric: DistanceType,
                     p: float, block_n: int, block_q: Optional[int]):
    """Streaming kNN against one index partition: ``block_n`` rows at a
    time (the last block zero-padded, its padded columns +inf), an exact
    per-block top-k (``chunk_min_select_k``), merged into the running
    list. The JAX package's ``exact=False`` (``lax.approx_min_k``) is
    exact off the TPU, so this one path serves both."""
    m, d = queries.shape
    n = index.shape[0]
    bn = max(k, min(block_n, n))
    inf = float("inf")  # a Python scalar: no host-to-device copy

    def one_query_block(qblk):
        rv = torch.full((qblk.shape[0], k), float("inf"),
                        device=qblk.device)
        ri = torch.zeros((qblk.shape[0], k), dtype=torch.int32,
                         device=qblk.device)
        cols = torch.arange(bn, device=qblk.device)
        for j0 in range(0, n, bn):
            yb = index[j0:j0 + bn]
            if yb.shape[0] < bn:
                yb = torch.nn.functional.pad(yb, (0, 0, 0, bn - yb.shape[0]))
            dmat = _block_dist(qblk, yb, metric, p)
            dmat = torch.where(j0 + cols[None, :] < n, dmat, inf)
            bv, bi = chunk_min_select_k(dmat, k)
            rv, ri = merge_topk(rv, ri, bv, bi + j0, select_min=True)
        return rv, ri

    if block_q is None or block_q >= m:
        return one_query_block(queries)
    outs = [one_query_block(queries[s:s + block_q])
            for s in range(0, m, block_q)]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def knn_merge_parts(part_dists, part_indices, *,
                    translations: Optional[Sequence[int]] = None,
                    select_min: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge P per-partition sorted k-lists per query into one (reference
    knn.cuh ``knn_merge_parts``): offset each partition's indices by its
    translation, then re-select the top k of the (m, P*k) union."""
    dev = call_device(part_dists, part_indices)
    part_dists = as_tensor(part_dists, dev)
    part_indices = as_tensor(part_indices, dev)
    P, m, k = part_dists.shape
    if translations is not None:
        offs = torch.as_tensor(list(translations), dtype=torch.int32,
                               device=dev).reshape(P, 1, 1)
        part_indices = part_indices + offs
    flat_d = part_dists.permute(1, 0, 2).reshape(m, P * k)
    flat_i = part_indices.permute(1, 0, 2).reshape(m, P * k)
    return select_k(flat_d, k, select_min=select_min, indices=flat_i)


def _fused_device_ok(dev: torch.device) -> bool:
    return hopper_device(dev)


def _note_scan_fallback(m: int, n: int, d: int) -> None:
    global SCAN_FALLBACKS, _scan_fallback_warned
    SCAN_FALLBACKS += 1
    if not _scan_fallback_warned:
        _scan_fallback_warned = True
        logger.warning(
            "brute_force_knn: a CUDA partition (m=%d n=%d d=%d) that the "
            "fused kernels serve runs the scan path, because its phase-1 "
            "grid is past the launch limit; split the index into smaller "
            "partitions", m, n, d)


def brute_force_knn(index: Union[torch.Tensor, List], queries, k: int, *,
                    metric="l2_sqrt_expanded", p: float = 2.0,
                    translations: Optional[Sequence[int]] = None,
                    block_n: int = 4096, block_q: Optional[int] = None,
                    exact: bool = True, use_fused: Optional[bool] = None,
                    compute_dtype=None, extra_chunks: Optional[int] = None,
                    index_norms: Optional[Sequence] = None, device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force kNN over one or more index partitions.

    Mirrors ``raft::spatial::knn::brute_force_knn``: ``index`` may be a
    list of row partitions; results carry global row ids via
    ``translations`` (default: running offsets).

    ``use_fused=None`` routes a partition to the fused CUDA kernels
    (:mod:`raft_tpu_torch.spatial.fused_knn`) when it is a CUDA tensor
    on a capability-9.0 card, the metric is L2-family, ``exact`` holds,
    the shape is supported and has at least 65,536 rows; a partition
    that qualifies but whose phase-1 grid is past the launch limit
    (``fused_grid_ok``) takes the scan path, counted in
    ``SCAN_FALLBACKS`` and warned about once. ``use_fused=True`` forces
    the fused path and raises where it is unsupported (on CPU tensors it
    runs the kernels' plain versions); ``False`` pins the scan path.
    ``compute_dtype``/``extra_chunks``/``index_norms`` (one norms vector
    per partition) tune the fused path only. ``exact=False`` selects
    exactly here (the JAX package's ``lax.approx_min_k`` is exact off the
    TPU too).

    The call runs on ``device`` when given, else on the device of the
    first tensor among the partitions and the queries (the queries move
    to the index, not the index to the queries), else on CUDA (raising
    without it). Returns (distances (m, k), int32 indices (m, k)),
    best-first."""
    metric = resolve_metric(metric)
    parts = index if isinstance(index, (list, tuple)) else [index]
    errors.expects(len(parts) > 0, "index: need at least one partition")
    dev = call_device(*parts, queries, device=device)
    queries = as_tensor(queries, dev)
    errors.check_matrix(queries, "queries")
    parts = [as_tensor(pt, dev) for pt in parts]
    for i, pt in enumerate(parts):
        errors.check_matrix(pt, f"index[{i}]")
        errors.check_same_cols(queries, pt, "queries", f"index[{i}]")
    total_rows = sum(pt.shape[0] for pt in parts)
    errors.check_k(k, total_rows, "total index size")
    errors.expects(
        translations is None or len(translations) == len(parts),
        "translations: %d offsets for %d partitions",
        0 if translations is None else len(translations), len(parts),
    )
    if translations is None:
        offs, acc = [], 0
        for pt in parts:
            offs.append(acc)
            acc += pt.shape[0]
    else:
        offs = list(translations)

    def _routes_fused(pt) -> bool:
        m, d = queries.shape
        n = pt.shape[0]
        fused_ok = exact and fused_knn_supported(metric, m, n, d, k)
        if use_fused:
            if not fused_ok:
                raise ValueError(
                    f"use_fused=True but fused path unsupported for "
                    f"metric={metric} m={m} n={n} d={d} k={k} exact={exact}")
            return True
        if (use_fused is None and fused_ok and n >= _FUSED_MIN_ROWS
                and _fused_device_ok(pt.device)):
            if fused_grid_ok(m, n, d):
                return True
            _note_scan_fallback(m, n, d)
        return False

    routes = [_routes_fused(pt) for pt in parts]
    # the fused tuning args must not be dropped silently: an error when no
    # partition takes the fused path, checked before any search runs
    errors.expects(
        (compute_dtype is None and extra_chunks is None
         and index_norms is None) or any(routes),
        "compute_dtype/extra_chunks/index_norms tune the fused path, but "
        "every partition routed to the scan path; pass use_fused=True to "
        "force fused, or drop the tuning args",
    )
    if index_norms is not None and not isinstance(index_norms,
                                                  (list, tuple)):
        index_norms = [index_norms]
    errors.expects(
        index_norms is None or len(index_norms) == len(parts),
        "index_norms: %d norm vectors for %d partitions",
        0 if index_norms is None else len(index_norms), len(parts),
    )
    norms_list = (list(index_norms) if index_norms is not None
                  else [None] * len(parts))
    for pi, (routed, nv) in enumerate(zip(routes, norms_list)):
        if not routed and nv is not None:
            logger.warning(
                "brute_force_knn: index_norms[%d] ignored — partition %d "
                "routes to the scan path (norms tune only the fused "
                "kernel)", pi, pi)

    def _search_part(pt, fused, norms):
        if fused:
            kw = {}
            if compute_dtype is not None:
                kw["compute_dtype"] = compute_dtype
            if extra_chunks is not None:
                kw["extra_chunks"] = extra_chunks
            return fused_l2_knn(queries, pt, k, metric=metric,
                                index_norms=norms, **kw)
        return _knn_single_part(queries, pt, k, metric, p, block_n,
                                block_q)

    results = [_search_part(pt, f, nr)
               for pt, f, nr in zip(parts, routes, norms_list)]
    if len(parts) == 1:
        d0, i0 = results[0]
        return d0, (i0 + offs[0]).to(torch.int32)
    pd = torch.stack([r[0] for r in results])
    pi = torch.stack([r[1].to(torch.int32) for r in results])
    return knn_merge_parts(pd, pi, translations=offs)


def haversine_knn(index, queries, k: int, *, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN under the haversine metric on (lat, lon) radian pairs
    (reference detail/haversine_distance.cuh:61-152 ``haversine_knn``)."""
    return brute_force_knn(index, queries, k, metric=DistanceType.Haversine,
                           device=device)


def epsilon_neighborhood(x, y, eps: float, *, device=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Boolean adjacency of pairs within L2 distance ``eps`` (compared on
    squared distances) and each row's degree, int32 (reference
    spatial/knn/epsilon_neighborhood.cuh ``epsUnexpL2SqNeighborhood``)."""
    dev = call_device(x, y, device=device)
    x = as_tensor(x, dev)
    y = as_tensor(y, dev)
    d2 = _unexpanded_impl(DistanceType.L2Unexpanded, x, y, 2.0, None)
    adj = d2 <= torch.tensor(eps, dtype=torch.float32, device=dev) ** 2
    return adj, torch.sum(adj, dim=1, dtype=torch.int32)
