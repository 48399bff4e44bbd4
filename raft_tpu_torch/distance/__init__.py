"""Distances of the port: the metric taxonomy, pairwise distances and the
fused L2 nearest neighbour (the public names of ``raft_tpu.distance``
that are ported)."""

from raft_tpu_torch.distance.distance_type import (
    DISTANCE_NAMES,
    EXPANDED_METRICS,
    UNEXPANDED_METRICS,
    DistanceType,
    resolve_metric,
)
from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn, fused_l2_nn_argmin
from raft_tpu_torch.distance.pairwise import (
    distance,
    haversine_distance,
    pairwise_distance,
    row_norm_sq,
)

__all__ = [
    "DistanceType",
    "DISTANCE_NAMES",
    "EXPANDED_METRICS",
    "UNEXPANDED_METRICS",
    "resolve_metric",
    "pairwise_distance",
    "distance",
    "haversine_distance",
    "row_norm_sq",
    "fused_l2_nn",
    "fused_l2_nn_argmin",
]
