"""pylibraft.cluster facade — the port of ``raft_tpu/pylibraft/cluster.py``:
k-means entry points shaped like the reference's Python kmeans API
(pylibraft 22.08 cluster.kmeans; the 22.06 tree exposes kmeans via C++
only, cpp/include/raft/cluster/kmeans.cuh:49).
"""

from __future__ import annotations

import torch

from raft_tpu_torch.cluster import KMeansParams, kmeans_fit, kmeans_predict
from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn
from raft_tpu_torch.pylibraft.common import _place

__all__ = ["fit", "predict", "cluster_cost", "KMeansParams"]


def fit(X, n_clusters: int, max_iter: int = 300, tol: float = 1e-4,
        seed: int = 0, handle=None):
    """Returns (centroids, labels, inertia, n_iter)."""
    out = kmeans_fit(
        _place(X, handle),
        KMeansParams(n_clusters=n_clusters, max_iter=max_iter, tol=tol,
                     seed=seed),
    )
    return out.centroids, out.labels, out.inertia, out.n_iter


def predict(X, centroids, handle=None):
    return kmeans_predict(_place(X, handle), _place(centroids, handle))


def cluster_cost(X, centroids, handle=None):
    """Sum of squared distances to the nearest centroid."""
    minv, _ = fused_l2_nn(_place(X, handle), _place(centroids, handle))
    return torch.sum(minv)
