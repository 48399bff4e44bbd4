"""k-means — the port of ``raft_tpu/cluster/kmeans.py`` (analog of
``raft::cluster::kmeans``): the Lloyd loop that trains IVF-Flat's coarse
quantizer.

* **assign** — :func:`~raft_tpu_torch.distance.fused_l2_nn.fused_l2_nn`
  (nearest centroid and its squared distance per row);
* **update** — blocked one-hot matmul, ``onehot(labels)ᵀ @ x`` per row
  block with f32 sums (deterministic, unlike a float scatter-add);
  ``compute_dtype="bfloat16"`` rounds the operands to bf16 first and
  still multiplies and sums in f32;
* **init** — k-means++ (inverse-CDF sampling on the running min
  distance) or ``"random"`` (distinct rows), from a ``torch.Generator``
  seeded with ``params.seed``. The JAX package draws from JAX's PRNG, so
  the two packages pick different initial centroids from one seed;
  :func:`kmeans_fit` takes ``centroids=`` to start both from the same.
* the loop stops after ``max_iter`` iterations or once
  ``|Δresidual| / n <= tol``; empty clusters are reseeded onto the rows
  farthest from their centroid.

:func:`kmeans_fit_batched` fits B independent problems of one shape (the
IVF-PQ codebooks, one per subspace) as a loop of the same Lloyd runs;
:func:`kmeans_predict` assigns rows to their nearest centroid, and
:func:`canonical_lists` maps each centroid to the lowest index holding the
same row, the routing table of the mutation tier (below).
:func:`kmeans_transform` gives every row's distance to every centroid,
:func:`kmeans` is the reference's signature (codes, residual, n_iter), and
:class:`KMeans` a small estimator over them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from raft_tpu_torch import errors
from raft_tpu_torch.core.device import full_f32, resolve_device
from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn

__all__ = [
    "KMeansParams", "KMeansOutput", "kmeans_plus_plus_init", "kmeans_fit",
    "kmeans_fit_batched", "kmeans_predict", "canonical_lists",
    "kmeans_transform", "kmeans", "KMeans",
]


@dataclasses.dataclass(frozen=True)
class KMeansParams:
    """Solver knobs, as in the JAX package."""

    n_clusters: int = 8
    max_iter: int = 300
    tol: float = 1e-4
    seed: int = 0
    init: str = "k-means++"  # "k-means++" | "random"
    block_rows: int = 1 << 16
    # operand dtype of the centroid update: None keeps the input dtype,
    # "bfloat16" rounds operands to bf16 (sums stay f32)
    compute_dtype: Optional[str] = None


class KMeansOutput(NamedTuple):
    centroids: torch.Tensor   # (k, d)
    labels: torch.Tensor      # (m,) int32
    inertia: torch.Tensor     # scalar f32
    n_iter: int


@full_f32
def _update_centroids(x, labels, k: int, block_rows: int,
                      compute_dtype=None):
    """Blocked one-hot matmul centroid update; returns (sums (k, d) f32,
    counts (k,) f32)."""
    m, d = x.shape
    sums = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    for r0 in range(0, m, block_rows):
        xb = x[r0:r0 + block_rows]
        if compute_dtype is not None:
            xb = xb.to(getattr(torch, compute_dtype))
        lab = labels[r0:r0 + block_rows].long()
        oh = torch.zeros((lab.shape[0], k), device=x.device).scatter_(
            1, lab[:, None], 1.0)                        # (bm, k) one-hot
        sums = sums + oh.T @ xb.float()
    counts = torch.bincount(labels.long(), minlength=k).float()
    return sums, counts


def _generator(seed: int) -> torch.Generator:
    # host generator: the same draws on every device
    return torch.Generator().manual_seed(int(seed))


def kmeans_plus_plus_init(x, k: int, gen: torch.Generator):
    """k-means++ seeding: first seed uniform, each next one drawn with
    probability proportional to the current min squared distance."""
    m = x.shape[0]
    cents = torch.empty((k, x.shape[1]), dtype=x.dtype, device=x.device)
    first = int(torch.randint(0, m, (1,), generator=gen))
    cents[0] = x[first]
    d2 = torch.sum((x - x[first]) ** 2, dim=1).float()
    u = torch.rand(k, generator=gen).to(x.device)
    for i in range(1, k):
        cdf = torch.cumsum(d2, dim=0)
        nxt = torch.searchsorted(cdf, (u[i] * cdf[-1])[None])
        nxt = torch.clamp(nxt, max=m - 1)[0]
        cents[i] = x[nxt]
        d2 = torch.minimum(d2, torch.sum((x - x[nxt]) ** 2, dim=1).float())
    return cents


def _lloyd(x, cents0, k: int, max_iter: int, tol: float, block_rows: int,
           compute_dtype=None) -> KMeansOutput:
    m = x.shape[0]

    def assign(cents):
        minv, mini = fused_l2_nn(x, cents, precision="default")
        return mini, minv

    def reseed_empty(cents, counts, minv):
        # move empty centroids onto the rows farthest from their assigned
        # centroid (minv reused from this iteration's assignment)
        far = torch.argsort(-minv, stable=True)
        empty = counts == 0
        rank = torch.cumsum(empty.long(), dim=0) - 1
        take = torch.where(empty, far[torch.clamp(rank, 0, m - 1)], 0)
        return torch.where(empty[:, None], x[take].to(cents.dtype), cents)

    it = 0
    cents = cents0
    prev_res = torch.tensor(float("-inf"))
    res = torch.tensor(float("inf"))
    while it < max_iter and bool(torch.abs(prev_res - res) / m > tol):
        labels, minv = assign(cents)
        sums, counts = _update_centroids(x, labels, k, block_rows,
                                         compute_dtype)
        new = (sums / torch.clamp_min(counts, 1.0)[:, None]).to(x.dtype)
        cents = reseed_empty(new, counts, minv)
        prev_res, res = res, torch.sum(minv).cpu()
        it += 1
    labels, minv = assign(cents)
    return KMeansOutput(cents, labels.to(torch.int32), torch.sum(minv), it)


def kmeans_fit(x, params: Optional[KMeansParams] = None, *,
               centroids=None, device=None, **kw) -> KMeansOutput:
    """Fit k-means. ``x``: a tensor (runs on its device) or an array
    (placed on ``device``, CUDA by default). ``centroids``: optional
    (n_clusters, d) initial centroids, replacing the seeded init."""
    if params is None:
        params = KMeansParams(**kw)
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, device=resolve_device(device))
    errors.check_matrix(x, "x")
    errors.check_k(params.n_clusters, x.shape[0], "n_clusters vs n rows")
    errors.expects(params.max_iter >= 1, "max_iter must be >= 1, got %d",
                   params.max_iter)
    errors.expects(
        centroids is None
        or tuple(centroids.shape) == (params.n_clusters, x.shape[1]),
        "centroids: expected shape %s, got %s",
        (params.n_clusters, x.shape[1]),
        None if centroids is None else tuple(centroids.shape),
    )
    _check_init(params)
    gen = _generator(params.seed)
    if centroids is not None:
        cents0 = torch.as_tensor(centroids, dtype=x.dtype, device=x.device)
    else:
        cents0 = _seed_centroids(x, params, gen)
    return _lloyd(x, cents0, params.n_clusters, params.max_iter,
                  params.tol, params.block_rows, params.compute_dtype)


def _check_init(params: KMeansParams) -> None:
    errors.expects(params.init in ("k-means++", "random"),
                   "init must be 'k-means++' or 'random', got %r",
                   params.init)


def _seed_centroids(x, params: KMeansParams, gen: torch.Generator):
    if params.init == "random":
        idx = torch.randperm(x.shape[0], generator=gen)[:params.n_clusters]
        return x[idx.to(x.device)]
    return kmeans_plus_plus_init(x, params.n_clusters, gen)


def kmeans_fit_batched(xs, params: Optional[KMeansParams] = None, *,
                       centroids=None, device=None, **kw) -> KMeansOutput:
    """Fit B independent k-means problems of one shape: ``xs`` (B, n, d).
    Returns a :class:`KMeansOutput` whose leaves carry a leading batch
    axis (``n_iter`` a (B,) int32 tensor). Each problem runs the same
    Lloyd loop as :func:`kmeans_fit` — a loop over the batch, so problem
    b equals ``kmeans_fit(xs[b], centroids=centroids[b])``. Without
    ``centroids`` the initial centroids of problem 0, 1, ... are drawn in
    turn from one generator seeded with ``params.seed`` (the JAX package
    splits its PRNG key instead, so the draws differ)."""
    if params is None:
        params = KMeansParams(**kw)
    if not isinstance(xs, torch.Tensor):
        xs = torch.as_tensor(xs, device=resolve_device(device))
    errors.check_matrix(xs, "xs", ndim=3)
    b, n, d = xs.shape
    errors.check_k(params.n_clusters, n, "n_clusters vs n rows")
    errors.expects(params.max_iter >= 1, "max_iter must be >= 1, got %d",
                   params.max_iter)
    errors.expects(
        centroids is None
        or tuple(centroids.shape) == (b, params.n_clusters, d),
        "centroids: expected shape %s, got %s", (b, params.n_clusters, d),
        None if centroids is None else tuple(centroids.shape),
    )
    _check_init(params)
    gen = _generator(params.seed)
    outs = []
    for i in range(b):
        if centroids is not None:
            c0 = torch.as_tensor(centroids[i], dtype=xs.dtype,
                                 device=xs.device)
        else:
            c0 = _seed_centroids(xs[i], params, gen)
        outs.append(_lloyd(xs[i], c0, params.n_clusters, params.max_iter,
                           params.tol, params.block_rows,
                           params.compute_dtype))
    return KMeansOutput(
        torch.stack([o.centroids for o in outs]),
        torch.stack([o.labels for o in outs]),
        torch.stack([o.inertia for o in outs]),
        torch.tensor([o.n_iter for o in outs], dtype=torch.int32),
    )


def kmeans_predict(x, centroids):
    """Nearest centroid of each row of ``x``: (m,) int32 labels, ties to
    the lowest centroid index (:func:`fused_l2_nn`, full f32)."""
    _, labels = fused_l2_nn(x, centroids)
    return labels


def canonical_lists(centroids) -> torch.Tensor:
    """(n_lists,) int64 on the centroids' device: for each centroid row,
    the lowest index holding a bitwise identical f32 row.

    A list split past its cap keeps its parent's centroid for every
    piece (``common.split_oversized_lists``), and the reference routes a
    row to the nearest centroid with ties to the lowest index. Identical
    centroid rows tie exactly on the CPU, but a GEMM on the card may
    round their distances a few ulp apart, differently at different
    batch sizes. Routing as ``canonical_lists(c)[kmeans_predict(x, c)]``
    gives the reference's list whatever the rounding. One host copy of
    the centroids: compute it once per index, not per write."""
    c = torch.as_tensor(centroids)
    rows = np.ascontiguousarray(
        c.detach().float().cpu().numpy()).view(np.uint32)
    _, first, inverse = np.unique(rows, axis=0, return_index=True,
                                  return_inverse=True)
    return torch.as_tensor(first[inverse.reshape(-1)].astype(np.int64),
                           device=c.device)


def kmeans_transform(x, centroids, *, sqrt: bool = True):
    """Distances to every centroid (reference computeDistances:86): the
    ``l2_sqrt_expanded`` (``sqrt``) or ``l2_expanded`` pairwise matrix."""
    from raft_tpu_torch.distance.pairwise import pairwise_distance

    metric = "l2_sqrt_expanded" if sqrt else "l2_expanded"
    return pairwise_distance(x, centroids, metric)


def kmeans(x, k: int, tol: float = 1e-4, max_iter: int = 300, seed: int = 0,
           *, device=None):
    """The reference's spectral-flavour entry
    ``raft::cluster::kmeans(handle, n, d, k, tol, maxiter, obs, ...)``
    (cluster/kmeans.cuh:49): returns (codes, residual, n_iter)."""
    out = kmeans_fit(
        x, KMeansParams(n_clusters=k, tol=tol, max_iter=max_iter, seed=seed),
        device=device,
    )
    return out.labels, out.inertia, out.n_iter


class KMeans:
    """Small estimator facade over the functional API. ``device``: where
    array (not tensor) input to :meth:`fit` goes (CUDA by default)."""

    def __init__(self, n_clusters: int = 8, *, device=None, **kw):
        self.params = KMeansParams(n_clusters=n_clusters, **kw)
        self.device = device
        self.output: Optional[KMeansOutput] = None

    def fit(self, x):
        self.output = kmeans_fit(x, self.params, device=self.device)
        return self

    @property
    def cluster_centers_(self):
        return self.output.centroids

    @property
    def labels_(self):
        return self.output.labels

    @property
    def inertia_(self):
        return self.output.inertia

    def predict(self, x):
        return kmeans_predict(x, self.output.centroids)

    def transform(self, x):
        return kmeans_transform(x, self.output.centroids)
