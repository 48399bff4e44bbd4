"""Summary statistics of the port — the counterpart of
``raft_tpu/stats/summary.py`` (the reference's per-column stats prims,
cpp/include/raft/stats/: mean.cuh, stddev.cuh, meanvar.cuh, minmax.cuh,
sum.cuh, cov.cuh, histogram.cuh, weighted_mean.cuh, mean_center.cuh).

Reductions and products in torch; the covariance's gram runs in full
f32 (TF32 off), and never narrows a wider input. Column-wise semantics
(``axis=0``) as in the reference's row-major sample x feature layout.
Tensors stay on their device; other inputs go to ``device`` (default
CUDA, raising without it).
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.device import as_tensor, call_device, full_f32

__all__ = [
    "mean",
    "mean_center",
    "mean_add",
    "stddev",
    "vars_",
    "meanvar",
    "minmax",
    "sum_",
    "cov",
    "histogram",
    "weighted_mean",
    "row_weighted_mean",
    "col_weighted_mean",
]


def _t(x, *others, device=None) -> torch.Tensor:
    """``x`` as a tensor on the call's device (``device``, else the
    first tensor's among ``x`` and ``others``, else CUDA); a tensor
    keeps its type (f64 stays f64), other f64 input becomes f32."""
    dev = call_device(x, *others, device=device)
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return as_tensor(x, dev)


def mean(x, axis: int = 0, sample: bool = False, *, device=None):
    """Column means (reference stats/mean.cuh; ``sample`` divides by
    n - 1)."""
    x = _t(x, device=device)
    n = x.shape[axis]
    return torch.sum(x, dim=axis) / (n - 1 if sample else n)


def vars_(x, mu=None, axis: int = 0, sample: bool = True, *, device=None):
    """Column variances (reference stats/stddev.cuh vars)."""
    x = _t(x, mu, device=device)
    mu = mean(x, axis=axis) if mu is None else as_tensor(mu, x.device)
    n = x.shape[axis]
    d = x - torch.unsqueeze(mu, axis)
    return torch.sum(d * d, dim=axis) / (n - 1 if sample else n)


def stddev(x, mu=None, axis: int = 0, sample: bool = True, *, device=None):
    """Column standard deviations (reference stats/stddev.cuh)."""
    return torch.sqrt(vars_(x, mu=mu, axis=axis, sample=sample,
                            device=device))


def meanvar(x, axis: int = 0, sample: bool = True, *, device=None):
    """Mean and variance (reference stats/meanvar.cuh)."""
    x = _t(x, device=device)
    mu = mean(x, axis=axis)
    return mu, vars_(x, mu=mu, axis=axis, sample=sample)


def minmax(x, axis: int = 0, *, device=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Column minima and maxima (reference stats/minmax.cuh)."""
    x = _t(x, device=device)
    return torch.amin(x, dim=axis), torch.amax(x, dim=axis)


def sum_(x, axis: int = 0, *, device=None):
    """Column sums (reference stats/sum.cuh)."""
    return torch.sum(_t(x, device=device), dim=axis)


@full_f32
def cov(x, mu=None, *, sample: bool = True, stable: bool = True,
        device=None):
    """Covariance matrix (d, d) of row-sample data (reference
    stats/cov.cuh). ``stable`` subtracts the mean before the gram (the
    reference's stable=true path); otherwise E[x xT] - mu muT. The gram
    accumulates in at least f32 and keeps a wider input's type."""
    x = _t(x, mu, device=device)
    n = x.shape[0]
    denom = n - 1 if sample else n
    mu = mean(x, axis=0) if mu is None else as_tensor(mu, x.device)
    acc = torch.promote_types(x.dtype, torch.float32)
    if stable:
        xc = (x - mu[None, :]).to(acc)
        return (xc.T @ xc) / denom
    xa = x.to(acc)
    return (xa.T @ xa) / denom - torch.outer(mu, mu) * (n / denom)


def histogram(x, n_bins: int, lower=None, upper=None, *, device=None):
    """Per-column histogram: out[b, c] counts the rows of column c in bin
    b (int32; reference stats/detail/histogram.cuh). Bins split
    [lower, upper) (default the data's range) evenly; values outside
    fall in the end bins."""
    x = _t(x, device=device)
    if x.dim() == 1:
        x = x[:, None]
    lo = torch.amin(x) if lower is None else torch.as_tensor(
        lower, dtype=x.dtype, device=x.device)
    hi = torch.amax(x) if upper is None else torch.as_tensor(
        upper, dtype=x.dtype, device=x.device)
    width = torch.clamp_min((hi - lo) / n_bins,
                            torch.finfo(torch.float32).tiny)
    bins = torch.clamp(((x - lo) / width).to(torch.int32), 0, n_bins - 1)
    c = x.shape[1]
    flat = (bins.long() * c + torch.arange(c, device=x.device)).reshape(-1)
    counts = torch.zeros(n_bins * c, dtype=torch.int32, device=x.device)
    counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return counts.reshape(n_bins, c)


def weighted_mean(x, weights, axis: int = 0, *, device=None):
    """Weighted mean along ``axis`` (reference stats/weighted_mean.cuh)."""
    x = _t(x, weights, device=device)
    w = as_tensor(weights, x.device).to(x.dtype)
    return torch.tensordot(w, x, dims=([0], [axis])) / torch.sum(w)


def row_weighted_mean(x, weights, *, device=None):
    """Per-row mean weighted across columns (rowWeightedMean)."""
    return weighted_mean(x, weights, axis=1, device=device)


def col_weighted_mean(x, weights, *, device=None):
    """Per-column mean weighted across rows (colWeightedMean)."""
    return weighted_mean(x, weights, axis=0, device=device)


def mean_center(x, mu=None, *, axis: int = 0, device=None):
    """Subtract per-axis means (reference stats/mean_center.cuh:42
    ``meanCenter``; ``axis=0`` centers columns). ``mu`` defaults to
    ``mean(x, axis)``."""
    x = _t(x, mu, device=device)
    mu = mean(x, axis=axis) if mu is None else as_tensor(mu, x.device)
    return x - torch.unsqueeze(mu, axis)


def mean_add(x, mu, *, axis: int = 0, device=None):
    """Add per-axis means back (reference stats/mean_center.cuh:69
    ``meanAdd``, the inverse of :func:`mean_center`)."""
    x = _t(x, mu, device=device)
    return x + torch.unsqueeze(as_tensor(mu, x.device), axis)
