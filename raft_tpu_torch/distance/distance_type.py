"""Distance metric taxonomy of the port — a copy of
``raft_tpu/distance/distance_type.py`` (the analog of the reference enum
``raft::distance::DistanceType``,
cpp/include/raft/distance/distance_type.hpp:26-66), kept as the port's
own so that importing it never imports the JAX package.

Every enum member of the reference is present; the subset implemented for
dense inputs matches (and extends) the reference's 15 dense metrics
(cpp/include/raft/distance/detail/distance.cuh:94-573).
"""

from __future__ import annotations

import enum


class DistanceType(enum.IntEnum):
    """Mirror of the reference enum, same ordinal values
    (reference distance_type.hpp:26-66)."""

    L2Expanded = 0
    L2SqrtExpanded = 1
    CosineExpanded = 2
    L1 = 3
    L2Unexpanded = 4
    L2SqrtUnexpanded = 5
    InnerProduct = 6
    Linf = 7
    Canberra = 8
    LpUnexpanded = 9
    CorrelationExpanded = 10
    JaccardExpanded = 11
    HellingerExpanded = 12
    Haversine = 13
    BrayCurtis = 14
    JensenShannon = 15
    HammingUnexpanded = 16
    KLDivergence = 17
    RusselRaoExpanded = 18
    DiceExpanded = 19
    Precomputed = 100


# String names accepted by the Python API, mirroring
# python/pylibraft/pylibraft/distance/pairwise_distance.pyx:35-60 plus
# common aliases.
DISTANCE_NAMES = {
    "l2": DistanceType.L2SqrtUnexpanded,
    "euclidean": DistanceType.L2SqrtUnexpanded,
    "sqeuclidean": DistanceType.L2Unexpanded,
    "l2_expanded": DistanceType.L2Expanded,
    "l2_sqrt_expanded": DistanceType.L2SqrtExpanded,
    "cosine": DistanceType.CosineExpanded,
    "l1": DistanceType.L1,
    "cityblock": DistanceType.L1,
    "manhattan": DistanceType.L1,
    "taxicab": DistanceType.L1,
    "inner_product": DistanceType.InnerProduct,
    "linf": DistanceType.Linf,
    "chebyshev": DistanceType.Linf,
    "canberra": DistanceType.Canberra,
    "minkowski": DistanceType.LpUnexpanded,
    "lp": DistanceType.LpUnexpanded,
    "correlation": DistanceType.CorrelationExpanded,
    "jaccard": DistanceType.JaccardExpanded,
    "hellinger": DistanceType.HellingerExpanded,
    "haversine": DistanceType.Haversine,
    "braycurtis": DistanceType.BrayCurtis,
    "jensenshannon": DistanceType.JensenShannon,
    "hamming": DistanceType.HammingUnexpanded,
    "kl_divergence": DistanceType.KLDivergence,
    "kldivergence": DistanceType.KLDivergence,
    "russellrao": DistanceType.RusselRaoExpanded,
    "dice": DistanceType.DiceExpanded,
}

#: Metrics whose pairwise form is a gram matrix plus an epilogue ("expanded"
#: norm-trick form, reference detail/distance.cuh `DistanceImpl` specializations
#: with `expanded=true`).
EXPANDED_METRICS = frozenset(
    {
        DistanceType.L2Expanded,
        DistanceType.L2SqrtExpanded,
        DistanceType.CosineExpanded,
        DistanceType.InnerProduct,
        DistanceType.CorrelationExpanded,
        DistanceType.HellingerExpanded,
        DistanceType.RusselRaoExpanded,
        DistanceType.JaccardExpanded,
        DistanceType.DiceExpanded,
    }
)

#: Metrics computed by per-feature accumulation (reference
#: "unexpanded" kernels built on Contractions_NT).
UNEXPANDED_METRICS = frozenset(
    {
        DistanceType.L1,
        DistanceType.L2Unexpanded,
        DistanceType.L2SqrtUnexpanded,
        DistanceType.Linf,
        DistanceType.Canberra,
        DistanceType.LpUnexpanded,
        DistanceType.BrayCurtis,
        DistanceType.JensenShannon,
        DistanceType.HammingUnexpanded,
        DistanceType.KLDivergence,
    }
)


def resolve_metric(metric) -> DistanceType:
    """Accept a DistanceType, its integer value, or a string alias."""
    if isinstance(metric, DistanceType):
        return metric
    if isinstance(metric, str):
        key = metric.lower().replace("-", "_")
        if key not in DISTANCE_NAMES:
            raise ValueError(
                f"unknown metric {metric!r}; known: {sorted(DISTANCE_NAMES)}"
            )
        return DISTANCE_NAMES[key]
    return DistanceType(metric)
