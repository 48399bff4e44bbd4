"""make_blobs of the port — the counterpart of
``raft_tpu/random/make_blobs.py`` (reference
cpp/include/raft/random/make_blobs.cuh:63,126 and detail/make_blobs.cuh:
isotropic Gaussian blobs around uniform or given centres, per-blob or
global std, optional shuffle; data and integer labels).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch import errors
from raft_tpu_torch.core.device import as_tensor
from raft_tpu_torch.random.rng import RngState, _resolve

__all__ = ["make_blobs"]


def make_blobs(n_samples: int, n_features: int, n_clusters: int = 5,
               state: Optional[RngState] = None, centers=None,
               cluster_std=1.0,
               center_box: Tuple[float, float] = (-10.0, 10.0),
               shuffle: bool = True, dtype=torch.float32, *,
               generator: Optional[torch.Generator] = None, device=None):
    """Generate (data (n_samples, n_features), labels (n_samples,) int32).

    The reference's semantics: centres drawn uniform in ``center_box``
    when not given; ``cluster_std`` a scalar or one value a cluster;
    labels assigned round-robin (``i % n_clusters``), then shuffled. The
    draws come from ``generator``, else from ``state`` (default
    ``RngState(0)``), on the call's device."""
    errors.expects(n_samples >= 1, "n_samples must be >= 1, got %d",
                   n_samples)
    errors.expects(n_features >= 1, "n_features must be >= 1, got %d",
                   n_features)
    errors.expects(n_clusters >= 1, "n_clusters must be >= 1, got %d",
                   n_clusters)
    gen, dev = _resolve(state, generator, device, centers, cluster_std)

    if centers is None:
        lo, hi = center_box
        centers = lo + (hi - lo) * torch.rand(
            (n_clusters, n_features), generator=gen, dtype=dtype, device=dev)
    else:
        centers = as_tensor(centers, dev).to(dtype)
        n_clusters = centers.shape[0]
    std = torch.broadcast_to(as_tensor(cluster_std, dev).to(dtype),
                             (n_clusters,))

    # round-robin labels, as the reference partitions evenly
    labels = torch.arange(n_samples, dtype=torch.int32,
                          device=dev) % n_clusters
    if shuffle:
        labels = labels[torch.randperm(n_samples, generator=gen,
                                       device=dev)]
    lab = labels.long()
    noise = torch.randn((n_samples, n_features), generator=gen, dtype=dtype,
                        device=dev)
    data = centers[lab] + noise * std[lab][:, None]
    return data, labels
