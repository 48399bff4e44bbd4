"""Pairwise distances of the port — the counterpart of
``raft_tpu/distance/pairwise.py`` (the analog of the reference distance
layer, cpp/include/raft/distance/distance.cuh:293-450).

Plain PyTorch, as the JAX package computes all of it outside Pallas:

* **Expanded metrics** (L2, cosine, correlation, inner product,
  Hellinger, Russell-Rao, Jaccard, Dice) are one f32 gram matrix
  (``torch.matmul`` with TF32 off: the JAX package asks for HIGHEST
  precision, which is IEEE f32 on its CPU reference) plus an elementwise
  epilogue with the row norms, in the JAX package's formula order.
* **Unexpanded metrics** (L1, Linf, Canberra, Lp, Hamming, KL,
  Jensen-Shannon, Bray-Curtis, unexpanded L2) accumulate a per-feature
  core over the feature axis. XLA fuses that broadcast so (m, n, d) never
  exists; here it is evaluated in (rows, cols, d) tiles of bounded size.
* L2 roots are taken through f64, so they are correctly rounded on every
  device (f32 ``sqrt`` on the CPU is not, in XLA or in PyTorch).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from raft_tpu_torch import errors
from raft_tpu_torch.core.device import as_tensor, call_device, full_f32
from raft_tpu_torch.distance.distance_type import (
    DistanceType,
    EXPANDED_METRICS,
    resolve_metric,
)

__all__ = ["pairwise_distance", "distance", "row_norm_sq",
           "haversine_distance"]

# elements of one (rows, cols, d) broadcast tile of an unexpanded metric
_TILE_ELEMS = 1 << 24


def _f32(dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def sqrt_f64(x):
    """``sqrt`` rounded correctly in ``x``'s type (computed in f64)."""
    return torch.sqrt(x.double()).to(x.dtype)


def relu0(x):
    """``max(x, 0)`` as ``jnp.maximum(x, 0.0)`` gives it: ``-0.0``
    becomes ``0.0`` (``torch.clamp_min`` would keep the sign)."""
    return torch.clamp_min(x, 0.0) + 0.0


def row_norm_sq(x):
    """Squared L2 row norms, accumulated in f32, returned in ``x``'s
    type."""
    x = torch.as_tensor(x)
    return torch.sum(x.to(_f32(x.dtype)) ** 2, dim=-1).to(x.dtype)


@full_f32
def _gram(x, y, precision=None):
    """``x @ y.T`` in full f32 (bf16 operands are exact in f32, so this
    is also what the JAX package's bf16 dot with f32 accumulation gives).
    ``precision`` is accepted for the JAX signature; every setting runs
    IEEE f32 products, as on the JAX package's CPU reference."""
    out_t = _f32(x.dtype)
    return torch.matmul(x.to(out_t), y.to(out_t).T)


# ---------------------------------------------------------------------------
# Expanded metrics: gram + epilogue
# ---------------------------------------------------------------------------


def _nonzero(den):
    return torch.where(den == 0, torch.ones_like(den), den)


def _expanded_impl(metric: DistanceType, x, y, precision):
    f32 = _f32(x.dtype)
    xf = x.to(f32)
    yf = y.to(f32)

    if metric == DistanceType.InnerProduct:
        return _gram(x, y, precision)

    if metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded):
        g = _gram(x, y, precision)
        xn = torch.sum(xf * xf, dim=-1)
        yn = torch.sum(yf * yf, dim=-1)
        d2 = relu0(xn[:, None] + yn[None, :] - 2.0 * g)
        if metric == DistanceType.L2SqrtExpanded:
            return sqrt_f64(d2)
        return d2

    if metric == DistanceType.CosineExpanded:
        g = _gram(x, y, precision)
        xn = torch.sqrt(torch.sum(xf * xf, dim=-1))
        yn = torch.sqrt(torch.sum(yf * yf, dim=-1))
        denom = xn[:, None] * yn[None, :]
        return 1.0 - g / _nonzero(denom)

    if metric == DistanceType.CorrelationExpanded:
        xc = xf - torch.mean(xf, dim=-1, keepdim=True)
        yc = yf - torch.mean(yf, dim=-1, keepdim=True)
        g = _gram(xc, yc, precision)
        xn = torch.sqrt(torch.sum(xc * xc, dim=-1))
        yn = torch.sqrt(torch.sum(yc * yc, dim=-1))
        denom = xn[:, None] * yn[None, :]
        return 1.0 - g / _nonzero(denom)

    if metric == DistanceType.HellingerExpanded:
        # 1 - sum_k sqrt(x_k y_k) on nonnegative (probability) rows
        g = _gram(torch.sqrt(torch.clamp_min(x, 0)),
                  torch.sqrt(torch.clamp_min(y, 0)), precision)
        return torch.sqrt(relu0(1.0 - g))

    if metric == DistanceType.RusselRaoExpanded:
        d = x.shape[-1]
        g = _gram(x, y, precision)
        return (d - g) / d

    if metric == DistanceType.JaccardExpanded:
        g = _gram(x, y, precision)
        xs = torch.sum(xf, dim=-1)
        ys = torch.sum(yf, dim=-1)
        denom = xs[:, None] + ys[None, :] - g
        return 1.0 - g / _nonzero(denom)

    if metric == DistanceType.DiceExpanded:
        g = _gram(x, y, precision)
        xs = torch.sum(xf, dim=-1)
        ys = torch.sum(yf, dim=-1)
        denom = xs[:, None] + ys[None, :]
        return 1.0 - 2.0 * g / _nonzero(denom)

    raise NotImplementedError(metric)


# ---------------------------------------------------------------------------
# Unexpanded metrics: accumulate core(x_k, y_k) over features
# ---------------------------------------------------------------------------

# Each entry: core(xc, yc) -> tuple of per-feature terms, reduced over the
# last axis by ``reducer``, then fin(accs, d, p) -> distance.


def _safe_div(num, den):
    return num / _nonzero(den)


def _core_l1(xc, yc):
    return (torch.abs(xc - yc),)


def _core_l2(xc, yc):
    d = xc - yc
    return (d * d,)


def _core_canberra(xc, yc):
    num = torch.abs(xc - yc)
    den = torch.abs(xc) + torch.abs(yc)
    return (_safe_div(num, den) * (den != 0),)


def _core_hamming(xc, yc):
    return ((xc != yc).to(torch.float32),)


def _core_kl(xc, yc):
    # sum x log(x/y); zero where x == 0 (reference detail/kl_divergence.cuh)
    ratio = _safe_div(xc, yc)
    one = torch.ones_like(ratio)
    return (torch.where(xc > 0, xc * torch.log(torch.where(ratio > 0, ratio,
                                                           one)),
                        torch.zeros_like(ratio)),)


def _core_js(xc, yc):
    m = 0.5 * (xc + yc)
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    t1 = torch.where(xc > 0, xc * torch.log(_safe_div(xc, m)), zero)
    t2 = torch.where(yc > 0, yc * torch.log(_safe_div(yc, m)), zero)
    return (0.5 * (t1 + t2),)


def _core_braycurtis(xc, yc):
    return (torch.abs(xc - yc), torch.abs(xc + yc))


_UNEXPANDED_TABLE = {
    DistanceType.L1: dict(core=_core_l1, reducer="sum",
                          fin=lambda a, d, p: a[0]),
    DistanceType.L2Unexpanded: dict(core=_core_l2, reducer="sum",
                                    fin=lambda a, d, p: a[0]),
    DistanceType.L2SqrtUnexpanded: dict(
        core=_core_l2, reducer="sum", fin=lambda a, d, p: sqrt_f64(a[0])),
    DistanceType.Linf: dict(core=_core_l1, reducer="max",
                            fin=lambda a, d, p: a[0]),
    DistanceType.Canberra: dict(core=_core_canberra, reducer="sum",
                                fin=lambda a, d, p: a[0]),
    DistanceType.HammingUnexpanded: dict(
        core=_core_hamming, reducer="sum", fin=lambda a, d, p: a[0] / d),
    DistanceType.KLDivergence: dict(core=_core_kl, reducer="sum",
                                    fin=lambda a, d, p: a[0]),
    DistanceType.JensenShannon: dict(
        core=_core_js, reducer="sum",
        fin=lambda a, d, p: torch.sqrt(relu0(a[0]))),
    DistanceType.BrayCurtis: dict(
        core=_core_braycurtis, reducer="sum",
        fin=lambda a, d, p: _safe_div(a[0], a[1])),
}


def _lp_table(p):
    return dict(
        core=lambda xc, yc: (torch.abs(xc - yc) ** p,),
        reducer="sum",
        fin=lambda a, d, _p: a[0] ** (1.0 / p),
    )


def _unexpanded_block(x, y, spec):
    """One (rows, cols) block through the (rows, cols, d) broadcast."""
    terms = spec["core"](x[:, None, :], y[None, :, :])
    if spec["reducer"] == "sum":
        accs = tuple(torch.sum(t, dim=-1) for t in terms)
    else:
        accs = tuple(torch.amax(t, dim=-1) for t in terms)
    return spec["fin"](accs, x.shape[-1], None)


def _unexpanded_impl(metric, x, y, p, block_m):
    """The (m, n) distances in (rows, cols) blocks: ``block_m`` rows when
    given, else as many as keep a broadcast tile under ``_TILE_ELEMS``
    elements. Each entry's reduction sees its whole feature row, so the
    blocking never changes a result."""
    f32 = _f32(x.dtype)
    xf = x.to(f32)
    yf = y.to(f32)
    spec = (_lp_table(p) if metric == DistanceType.LpUnexpanded
            else _UNEXPANDED_TABLE[metric])
    m, d = xf.shape
    n = yf.shape[0]
    bn = max(1, min(n, _TILE_ELEMS // max(d, 1)))
    bm = block_m or max(1, _TILE_ELEMS // (bn * max(d, 1)))
    if bm >= m and bn >= n:
        return _unexpanded_block(xf, yf, spec)
    out = torch.empty((m, n), dtype=f32, device=xf.device)
    for i in range(0, m, bm):
        for j in range(0, n, bn):
            out[i:i + bm, j:j + bn] = _unexpanded_block(
                xf[i:i + bm], yf[j:j + bn], spec)
    return out


# ---------------------------------------------------------------------------
# Haversine (2-d lat/lon rows, reference detail/haversine_distance.cuh:35-57)
# ---------------------------------------------------------------------------


def haversine_core(lat1, lon1, lat2, lon2):
    """Elementwise great-circle distance on the unit sphere from radian
    coordinates (broadcasting). Reference haversine_distance.cuh:40-50."""
    sin_lat = torch.sin(0.5 * (lat1 - lat2))
    sin_lon = torch.sin(0.5 * (lon1 - lon2))
    a = sin_lat ** 2 + torch.cos(lat1) * torch.cos(lat2) * sin_lon ** 2
    return 2.0 * torch.asin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))


def haversine_distance(x, y):
    """Pairwise haversine on (lat, lon) radian rows: the great-circle
    distance on the unit sphere."""
    return haversine_core(x[:, 0][:, None], x[:, 1][:, None],
                          y[:, 0][None, :], y[:, 1][None, :])


# ---------------------------------------------------------------------------
# Public dispatch (reference distance.cuh:293-369 runtime-metric switch)
# ---------------------------------------------------------------------------


def pairwise_distance(x, y, metric="euclidean", *, p: float = 2.0,
                      fin_op: Optional[Callable] = None,
                      block_m: Optional[int] = None, method: str = "auto",
                      precision=None, device=None):
    """The full (m, n) distance matrix, ``fin_op`` applied last.

    Parameters mirror the JAX package's (``method`` is accepted for its
    API; there is one engine). Tensors stay on their device; other
    inputs go to ``device`` (default CUDA, raising without it)."""
    dev = call_device(x, y, device=device)
    x = as_tensor(x, dev)
    y = as_tensor(y, dev)
    errors.check_matrix(x, "x")
    errors.check_matrix(y, "y")
    errors.check_same_cols(x, y)
    metric = resolve_metric(metric)
    if metric == DistanceType.LpUnexpanded:
        errors.expects(p > 0, "LpUnexpanded needs p > 0, got %s", p)

    if metric == DistanceType.Haversine:
        out = haversine_distance(x, y)
    elif metric in EXPANDED_METRICS:
        out = _expanded_impl(metric, x, y, precision)
    else:
        out = _unexpanded_impl(metric, x, y, p, block_m)
    if fin_op is not None:
        out = fin_op(out)
    return out


def distance(x, y, metric="euclidean", **kw):
    """Alias matching ``raft::distance::distance``."""
    return pairwise_distance(x, y, metric, **kw)
