"""Clustering of the port — the counterpart of ``raft_tpu/cluster``:
k-means (the IVF coarse quantizer's trainer, and the public entry points
over it)."""

from raft_tpu_torch.cluster.kmeans import (
    KMeans,
    KMeansOutput,
    KMeansParams,
    kmeans,
    kmeans_fit,
    kmeans_plus_plus_init,
    kmeans_predict,
    kmeans_transform,
)

__all__ = [
    "KMeans",
    "KMeansOutput",
    "KMeansParams",
    "kmeans",
    "kmeans_fit",
    "kmeans_plus_plus_init",
    "kmeans_predict",
    "kmeans_transform",
]
