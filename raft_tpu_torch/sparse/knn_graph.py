"""The kNN graph of the port — the counterpart of
``raft_tpu/sparse/knn_graph.py`` (reference
cpp/include/raft/sparse/selection/knn_graph.cuh:48 ``knn_graph``):
dense rows -> the COO graph of k-nearest-neighbour edges, symmetrized.

The neighbours come from the port's ``brute_force_knn`` (on a Hopper
card, over 65,536 rows and more, the fused kNN kernels). The queries are
the rows themselves, searched in blocks of :data:`BLOCK_Q` rows so that
the per-call candidate tensors stay bounded (at 500,000 rows one call
would hold tens of GB of chunk minima and rescored candidates); each
row's neighbours do not depend on the block it is searched in.
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core.device import as_tensor, call_device
from raft_tpu_torch.sparse.coo import COO
from raft_tpu_torch.sparse.linalg import coo_symmetrize
from raft_tpu_torch.sparse.op import coo_sort
from raft_tpu_torch.spatial.knn import brute_force_knn

__all__ = ["knn_graph"]

BLOCK_Q = 16384


def knn_graph(x, k: int, *, metric="l2_sqrt_expanded",
              symmetrize: bool = True, use_fused: Optional[bool] = None,
              device=None) -> COO:
    """The kNN graph of dense rows ``x`` (n, d): edges (i -> j) for each
    of i's k nearest neighbours other than itself, row-sorted.
    ``symmetrize`` mirrors the edges (A ∪ Aᵀ, values combined by max).

    Column 0 of each row's k+1 neighbours is dropped on the assumption
    that a row's nearest neighbour is itself, as the JAX package does: a
    row whose nearest is another (a duplicate row) keeps an edge to
    itself. ``use_fused`` is ``brute_force_knn``'s (None: its routing
    rule; False pins the scan path). Runs on ``device`` when given, else
    on ``x``'s device if it is a tensor, else on CUDA (raising without
    it)."""
    dev = call_device(x, device=device)
    x = as_tensor(x, dev)
    n = x.shape[0]
    parts = [brute_force_knn(x, x[s:s + BLOCK_Q], k + 1, metric=metric,
                             use_fused=use_fused)
             for s in range(0, n, BLOCK_Q)]
    dists = torch.cat([p[0] for p in parts])[:, 1:]
    idxs = torch.cat([p[1] for p in parts])[:, 1:]
    rows = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(k)
    g = COO(rows, idxs.reshape(-1).to(torch.int32), dists.reshape(-1),
            torch.tensor(n * k, dtype=torch.int32, device=dev), (n, n))
    if symmetrize:
        g = coo_symmetrize(g, combine="max")
    return coo_sort(g)
