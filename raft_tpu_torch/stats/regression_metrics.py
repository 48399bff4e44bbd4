"""Regression and classification metrics and information criteria of
the port — the counterpart of ``raft_tpu/stats/regression_metrics.py``
(reference cpp/include/raft/stats/: accuracy.cuh, r2_score.cuh,
regression_metrics.cuh, information_criterion.cuh,
linalg/mean_squared_error.cuh). Results are tensors on the call's
device: ``device`` when given, else the first tensor argument's, else
CUDA.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import torch

from raft_tpu_torch.core.device import as_tensor, call_device

__all__ = [
    "accuracy",
    "r2_score",
    "RegressionMetrics",
    "regression_metrics",
    "mean_squared_error",
    "CriterionType",
    "information_criterion",
]


def _pair(a, b, device):
    dev = call_device(a, b, device=device)
    return as_tensor(a, dev), as_tensor(b, dev)


def accuracy(predictions, ref_predictions, *, device=None):
    """Fraction of exact matches (reference stats/accuracy.cuh)."""
    p, r = _pair(predictions, ref_predictions, device)
    # the count times the f32 reciprocal of n, as the reference's mean
    inv = torch.tensor(1.0 / p.numel(), dtype=torch.float32, device=p.device)
    return torch.sum((p == r).float()) * inv


def r2_score(y, y_hat, *, device=None):
    """Coefficient of determination (reference stats/r2_score.cuh)."""
    y, y_hat = _pair(y, y_hat, device)
    ss_res = torch.sum((y - y_hat) ** 2)
    ss_tot = torch.sum((y - torch.mean(y)) ** 2)
    return 1.0 - ss_res / torch.where(ss_tot == 0, 1.0, ss_tot)


class RegressionMetrics(NamedTuple):
    mean_abs_error: torch.Tensor
    mean_squared_error: torch.Tensor
    median_abs_error: torch.Tensor


def _median(v):
    """The mean of the two middle values for an even count, as
    ``jnp.median`` (``torch.median`` takes the lower one)."""
    s = torch.sort(v.reshape(-1)).values
    n = s.shape[0]
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def regression_metrics(predictions, ref_predictions, *,
                       device=None) -> RegressionMetrics:
    """MAE / MSE / MedAE (reference stats/regression_metrics.cuh)."""
    p, r = _pair(predictions, ref_predictions, device)
    err = p.float() - r.float()
    return RegressionMetrics(torch.mean(torch.abs(err)),
                             torch.mean(err * err), _median(torch.abs(err)))


def mean_squared_error(a, b, weight: float = 1.0, *, device=None):
    """Weighted MSE (reference linalg/mean_squared_error.cuh)."""
    a, b = _pair(a, b, device)
    return torch.mean((a - b) ** 2) * weight


class CriterionType(enum.IntEnum):
    """Mirror of the reference's IC_Type (stats/information_criterion.cuh)."""

    AIC = 0
    AICc = 1
    BIC = 2


def information_criterion(log_likelihood, ic_type: CriterionType,
                          n_params: int, n_samples: int, *, device=None):
    """Batched information criteria from log-likelihoods (reference
    stats/information_criterion.cuh): AIC = -2 ll + 2p; AICc adds the
    small-sample correction; BIC uses p ln n."""
    ll = as_tensor(log_likelihood, call_device(log_likelihood,
                                               device=device))
    ic_type = CriterionType(ic_type)
    if ic_type == CriterionType.AIC:
        pen = 2.0 * n_params
    elif ic_type == CriterionType.AICc:
        pen = 2.0 * n_params + (2.0 * n_params * (n_params + 1.0)
                                / max(n_samples - n_params - 1.0, 1.0))
    else:
        pen = float(n_params * torch.log(torch.tensor(
            float(n_samples), dtype=torch.float32)))
    return -2.0 * ll + pen
