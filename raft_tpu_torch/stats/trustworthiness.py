"""Trustworthiness of an embedding in the port — the counterpart of
``raft_tpu/stats/trustworthiness.py`` (reference
cpp/include/raft/stats/trustworthiness_score.cuh:39: the kNN in the
embedded space, ranks in the original space).

T = 1 - 2 / (n k (2n - 3k - 1)) * sum_i sum_{j in kNN_emb(i)}
max(0, rank_orig(i, j) - k)

Ranks come from a stable ``argsort`` (as ``jnp.argsort``), the embedded
neighbours from :func:`~raft_tpu_torch.spatial.selection.top_k_smallest`
(``lax.top_k``'s order). Both distance matrices are n x n, over the
port's ``distance.pairwise``.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.device import as_tensor, call_device
from raft_tpu_torch.distance.pairwise import pairwise_distance
from raft_tpu_torch.spatial.selection import top_k_smallest

__all__ = ["trustworthiness_score"]


def trustworthiness_score(x, x_embedded, n_neighbors: int = 5,
                          metric="l2_sqrt_expanded", *, device=None):
    """The trustworthiness of ``x_embedded`` as an embedding of ``x``
    (a 0-d f32 tensor on the call's device: ``device`` when given, else
    the first tensor argument's, else CUDA)."""
    dev = call_device(x, x_embedded, device=device)
    x, x_embedded = as_tensor(x, dev), as_tensor(x_embedded, dev)
    n = x.shape[0]
    k = n_neighbors
    # ranks in the original space: rank[i, j] = the position of j in i's
    # distance-sorted neighbour list
    order = torch.argsort(pairwise_distance(x, x, metric), dim=1,
                          stable=True)
    ranks = torch.empty((n, n), dtype=torch.int32, device=dev)
    ranks.scatter_(1, order, torch.arange(n, dtype=torch.int32,
                                          device=dev).expand(n, n))
    del order
    # the kNN in the embedded space (itself excluded: k + 1, column 0
    # dropped)
    _, nn_emb = top_k_smallest(pairwise_distance(x_embedded, x_embedded,
                                                 metric), k + 1)
    r = torch.gather(ranks, 1, nn_emb[:, 1:])
    penalty = torch.sum(torch.clamp_min(r - k, 0).long())
    coef = torch.tensor(2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0)),
                        dtype=torch.float32, device=dev)
    # 1 - coef * penalty with one rounding, as the reference's fused
    # multiply-add gives it (the f32 product is exact in f64)
    return (1.0 - coef.double() * penalty.float().double()).float()
