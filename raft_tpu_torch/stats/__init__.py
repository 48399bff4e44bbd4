"""Statistics of the port — the counterpart of ``raft_tpu.stats``
(analog of raft/stats): summary statistics, clustering metrics
(pair counting, information, silhouette, dispersion), regression
metrics, information criteria and trustworthiness.
"""

from raft_tpu_torch.stats.summary import (
    mean,
    mean_center,
    mean_add,
    stddev,
    vars_,
    meanvar,
    minmax,
    sum_,
    cov,
    histogram,
    weighted_mean,
    row_weighted_mean,
    col_weighted_mean,
)
from raft_tpu_torch.stats.clustering_metrics import (
    contingency_matrix,
    adjusted_rand_index,
    rand_index,
    mutual_info_score,
    entropy,
    homogeneity_score,
    completeness_score,
    v_measure,
    silhouette_score,
    silhouette_samples,
    batched_silhouette_score,
    dispersion,
    kl_divergence,
)
from raft_tpu_torch.stats.regression_metrics import (
    accuracy,
    r2_score,
    RegressionMetrics,
    regression_metrics,
    mean_squared_error,
    CriterionType,
    information_criterion,
)
from raft_tpu_torch.stats.trustworthiness import trustworthiness_score

__all__ = [
    "mean", "stddev", "vars_", "meanvar", "minmax", "sum_", "cov",
    "histogram", "weighted_mean", "row_weighted_mean", "col_weighted_mean",
    "mean_center", "mean_add",
    "contingency_matrix", "adjusted_rand_index", "rand_index",
    "mutual_info_score", "entropy", "homogeneity_score",
    "completeness_score", "v_measure", "silhouette_score",
    "silhouette_samples", "batched_silhouette_score", "dispersion",
    "kl_divergence",
    "accuracy", "r2_score", "RegressionMetrics", "regression_metrics",
    "mean_squared_error", "CriterionType", "information_criterion",
    "trustworthiness_score",
]
