"""External and internal clustering metrics of the port — the
counterpart of ``raft_tpu/stats/clustering_metrics.py`` (reference
cpp/include/raft/stats/: contingency_matrix.cuh,
adjusted_rand_index.cuh, rand_index.cuh, mutual_info_score.cuh,
entropy.cuh, homogeneity_score.cuh, completeness_score.cuh,
v_measure.cuh, silhouette_score.cuh (+ batched), dispersion.cuh,
kl_divergence.cuh).

Every pair-counting metric derives from one contingency matrix, a
one-hot product in full f32 (TF32 off, exact for counts below 2**24);
the silhouette sums are one more such product over the port's
``distance.pairwise``. Results are 0-d tensors on the call's device:
``device`` when given, else the first tensor argument's, else CUDA.
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core.device import as_tensor, call_device, full_f32
from raft_tpu_torch.distance.pairwise import pairwise_distance

__all__ = [
    "contingency_matrix",
    "adjusted_rand_index",
    "rand_index",
    "mutual_info_score",
    "entropy",
    "homogeneity_score",
    "completeness_score",
    "v_measure",
    "silhouette_score",
    "silhouette_samples",
    "batched_silhouette_score",
    "dispersion",
    "kl_divergence",
]


def _labels(y, dev) -> torch.Tensor:
    return as_tensor(y, dev).long()


def _one_hot(y, n_classes: int) -> torch.Tensor:
    """f32 one-hot rows; labels outside [0, n_classes) give zero rows (as
    ``jax.nn.one_hot``)."""
    cls = torch.arange(n_classes, device=y.device)
    return (y[:, None] == cls[None, :]).float()


@full_f32
def contingency_matrix(y_true, y_pred, n_classes_true: int,
                       n_classes_pred: Optional[int] = None, *,
                       device=None):
    """C[i, j] = #{samples with true label i and predicted label j}
    (reference stats/contingency_matrix.cuh), int32. Labels must lie in
    [0, n_classes)."""
    dev = call_device(y_true, y_pred, device=device)
    if n_classes_pred is None:
        n_classes_pred = n_classes_true
    a = _one_hot(_labels(y_true, dev), n_classes_true)
    b = _one_hot(_labels(y_pred, dev), n_classes_pred)
    return (a.T @ b).to(torch.int32)


def _comb2(x):
    x = x.float()
    return x * (x - 1.0) / 2.0


def adjusted_rand_index(y_true, y_pred, n_classes: int, *, device=None):
    """ARI from the contingency matrix (reference
    stats/adjusted_rand_index.cuh)."""
    c = contingency_matrix(y_true, y_pred, n_classes,
                           device=device).float()
    n = torch.sum(c)
    sum_comb_c = torch.sum(_comb2(c))
    sum_comb_a = torch.sum(_comb2(torch.sum(c, dim=1)))
    sum_comb_b = torch.sum(_comb2(torch.sum(c, dim=0)))
    exp = sum_comb_a * sum_comb_b / _comb2(n)
    mx = 0.5 * (sum_comb_a + sum_comb_b)
    den = mx - exp
    return (sum_comb_c - exp) / torch.where(den == 0, 1.0, den)


def rand_index(y_true, y_pred, *, device=None):
    """Unadjusted Rand index by direct pair counting over all n² pairs
    (reference stats/rand_index.cuh)."""
    dev = call_device(y_true, y_pred, device=device)
    y_true, y_pred = _labels(y_true, dev), _labels(y_pred, dev)
    n = y_true.shape[0]
    same_t = y_true[:, None] == y_true[None, :]
    same_p = y_pred[:, None] == y_pred[None, :]
    agree = (same_t == same_p).float()
    return torch.sum(torch.triu(agree, diagonal=1)) / (n * (n - 1) / 2.0)


def entropy(labels, n_classes: int, *, device=None):
    """Shannon entropy (nats) of a label vector (reference
    stats/entropy.cuh)."""
    dev = call_device(labels, device=device)
    oh = _one_hot(_labels(labels, dev), n_classes)
    p = torch.sum(oh, dim=0) / oh.shape[0]
    return -torch.sum(torch.where(p > 0, p * torch.log(p), 0.0))


def mutual_info_score(y_true, y_pred, n_classes: int, *, device=None):
    """MI (nats) from the contingency matrix (reference
    stats/mutual_info_score.cuh)."""
    c = contingency_matrix(y_true, y_pred, n_classes,
                           device=device).float()
    pij = c / torch.sum(c)
    pi = torch.sum(pij, dim=1, keepdim=True)
    pj = torch.sum(pij, dim=0, keepdim=True)
    terms = torch.where(
        pij > 0,
        pij * (torch.log(torch.where(pij > 0, pij, 1.0))
               - torch.log(pi * pj + 1e-30)),
        0.0)
    return torch.sum(terms)


def homogeneity_score(y_true, y_pred, n_classes: int, *, device=None):
    """1 - H(C|K) / H(C) (reference stats/homogeneity_score.cuh)."""
    h_c = entropy(y_true, n_classes, device=device)
    mi = mutual_info_score(y_true, y_pred, n_classes, device=device)
    return torch.where(h_c == 0, 1.0, mi / h_c)


def completeness_score(y_true, y_pred, n_classes: int, *, device=None):
    """The symmetric counterpart (reference stats/completeness_score.cuh)."""
    return homogeneity_score(y_pred, y_true, n_classes, device=device)


def v_measure(y_true, y_pred, n_classes: int, beta: float = 1.0, *,
              device=None):
    """Harmonic mean of homogeneity and completeness
    (stats/v_measure.cuh)."""
    h = homogeneity_score(y_true, y_pred, n_classes, device=device)
    c = completeness_score(y_true, y_pred, n_classes, device=device)
    denom = beta * h + c
    return torch.where(denom == 0, 0.0, (1 + beta) * h * c / denom)


def _silhouette_of(sums, lb, counts, n_clusters):
    """Per-sample silhouette from each sample's distance sums to every
    cluster: s = (b - a) / max(a, b), a the mean distance to its own
    cluster (without itself), b the least mean distance to another."""
    own = counts[lb]
    a = torch.where(
        own > 1,
        torch.gather(sums, 1, lb[:, None])[:, 0] / torch.clamp_min(
            own - 1, 1),
        0.0)
    mean_other = sums / torch.clamp_min(counts, 1.0)[None, :]
    cls = torch.arange(n_clusters, device=sums.device)
    mean_other = torch.where(
        (cls[None, :] == lb[:, None]) | (counts[None, :] == 0),
        float("inf"), mean_other)
    b = torch.amin(mean_other, dim=1)
    return torch.where(
        own > 1, (b - a) / torch.clamp_min(torch.maximum(a, b), 1e-30), 0.0)


@full_f32
def silhouette_samples(x, labels, n_clusters: int,
                       metric="l2_sqrt_expanded", *, device=None):
    """Per-sample silhouette (reference stats/silhouette_score.cuh): one
    n x n distance matrix and a one-hot product give every sample's
    distance sums by cluster."""
    dev = call_device(x, labels, device=device)
    x = as_tensor(x, dev)
    labels = _labels(labels, dev)
    d = pairwise_distance(x, x, metric)
    oh = _one_hot(labels, n_clusters)
    return _silhouette_of(d @ oh, labels, torch.sum(oh, dim=0), n_clusters)


def silhouette_score(x, labels, n_clusters: int, metric="l2_sqrt_expanded",
                     *, device=None):
    return torch.mean(silhouette_samples(x, labels, n_clusters, metric,
                                         device=device))


@full_f32
def batched_silhouette_score(x, labels, n_clusters: int,
                             metric="l2_sqrt_expanded",
                             batch_size: int = 4096, *, device=None):
    """The mean silhouette in query batches against the whole dataset
    (reference stats/detail/batched/silhouette_score.cuh): only
    (batch_size, n) distance tiles exist at once."""
    dev = call_device(x, labels, device=device)
    x = as_tensor(x, dev)
    labels = _labels(labels, dev)
    n = x.shape[0]
    oh = _one_hot(labels, n_clusters)
    counts = torch.sum(oh, dim=0)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for s0 in range(0, n, batch_size):
        sums = pairwise_distance(x[s0:s0 + batch_size], x, metric) @ oh
        total = total + torch.sum(_silhouette_of(
            sums, labels[s0:s0 + batch_size], counts, n_clusters))
    return total / n


def dispersion(centroids, cluster_sizes, global_centroid=None, *,
               device=None):
    """Between-cluster dispersion sqrt(sum_k n_k ||mu_k - mu||²)
    (reference stats/dispersion.cuh). Returns (dispersion, global
    centroid)."""
    dev = call_device(centroids, cluster_sizes, global_centroid,
                      device=device)
    centroids = as_tensor(centroids, dev)
    sizes = as_tensor(cluster_sizes, dev).float()
    if global_centroid is None:
        global_centroid = (torch.sum(centroids * sizes[:, None], dim=0)
                           / torch.sum(sizes))
    else:
        global_centroid = as_tensor(global_centroid, dev)
    diff = centroids - global_centroid[None, :]
    disp = torch.sqrt(torch.sum(sizes * torch.sum(diff * diff, dim=1)))
    return disp, global_centroid


def kl_divergence(p, q, *, device=None):
    """sum p log(p / q) over the flattened inputs (reference
    stats/kl_divergence.cuh)."""
    dev = call_device(p, q, device=device)
    p, q = as_tensor(p, dev), as_tensor(q, dev)
    ratio = torch.where((p > 0) & (q > 0), p / torch.where(q > 0, q, 1.0),
                        1.0)
    return torch.sum(torch.where(p > 0, p * torch.log(ratio), 0.0))
