"""Spectral partitioning and modularity maximization of the port — the
counterpart of ``raft_tpu/spectral/partition.py`` (analog of
cpp/include/raft/spectral/detail/partition.hpp:64-133, detail/
modularity_maximization.hpp, the matrix wrappers of
detail/matrix_wrappers.hpp:130-305, and the solver configs of
eigen_solvers.hpp:35-51 / cluster_solvers.hpp:38-49).

The pipeline (reference partition.hpp:64): the CSR graph as a Laplacian
(or modularity) operator over ``spmv``, its smallest (largest)
eigenvectors by the port's thick-restart Lanczos, the rows of the
embedding normalized, then the port's k-means on the n x k embedding.

k-means seeds from a ``torch.Generator`` seeded with the config's
``seed`` and Lanczos draws ``v0`` from another, where the JAX package
uses PRNG keys: the packages agree on the eigenvalues and on the labels
up to a permutation of the cluster ids, not on the draws.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from raft_tpu_torch.cluster.kmeans import KMeansParams, kmeans_fit
from raft_tpu_torch.linalg.lanczos import lanczos_solver
from raft_tpu_torch.sparse.coo import CSR, scatter_rows
from raft_tpu_torch.sparse.linalg import spmv

__all__ = [
    "EigenSolverConfig",
    "ClusterSolverConfig",
    "LaplacianMatrix",
    "ModularityMatrix",
    "SpectralResult",
    "partition",
    "analyze_partition",
    "modularity_maximization",
    "analyze_modularity",
]


@dataclasses.dataclass(frozen=True)
class EigenSolverConfig:
    """Analog of eigen_solver_config_t (spectral/eigen_solvers.hpp:35)."""

    n_eig_vecs: int
    max_iter: int = 4000
    restart_iter: int = 0   # ncv; 0 -> auto
    tol: float = 1e-6
    seed: int = 1234567


@dataclasses.dataclass(frozen=True)
class ClusterSolverConfig:
    """Analog of cluster_solver_config_t (spectral/cluster_solvers.hpp:38)."""

    n_clusters: int
    max_iter: int = 100
    tol: float = 1e-4
    seed: int = 123456


class LaplacianMatrix:
    """L = D - A as a matvec (reference matrix_wrappers.hpp:305
    laplacian_matrix_t: spmv and a diagonal scaling)."""

    def __init__(self, csr: CSR):
        self.csr = csr
        self.degree = scatter_rows(csr, csr.data)

    def matvec(self, v):
        return self.degree * v - spmv(self.csr, v)


class ModularityMatrix:
    """B = A - d dᵀ / (2m) as a matvec (reference matrix_wrappers.hpp
    modularity_matrix_t)."""

    def __init__(self, csr: CSR):
        self.csr = csr
        self.degree = scatter_rows(csr, csr.data)
        valid = csr.valid_mask()
        self.edge_sum = torch.sum(torch.where(   # = 2m for symmetric A
            valid, csr.data, torch.zeros_like(csr.data)))

    def matvec(self, v):
        return spmv(self.csr, v) - self.degree * (
            torch.dot(self.degree, v) / self.edge_sum)


def _normalize_rows(e):
    """transform_eigen_matrix analog (reference
    detail/spectral_util.cuh: scale the embedding before clustering)."""
    nrm = torch.linalg.vector_norm(e, dim=1, keepdim=True)
    return e / torch.where(nrm == 0, torch.ones_like(nrm), nrm)


class SpectralResult(NamedTuple):
    labels: torch.Tensor
    eigenvalues: torch.Tensor
    eigenvectors: torch.Tensor
    kmeans_iters: int


def _solve(matvec, csr: CSR, eig_cfg: EigenSolverConfig,
           cluster_cfg: ClusterSolverConfig, smallest: bool,
           info: Optional[dict]) -> SpectralResult:
    vals, vecs, res, restarts = lanczos_solver(
        matvec, csr.shape[0], eig_cfg.n_eig_vecs,
        ncv=eig_cfg.restart_iter or None, seed=eig_cfg.seed,
        smallest=smallest, return_info=True, device=csr.data.device,
    )
    if info is not None:
        info.update(residuals=res, restarts=restarts)
    out = kmeans_fit(_normalize_rows(vecs), KMeansParams(
        n_clusters=cluster_cfg.n_clusters, max_iter=cluster_cfg.max_iter,
        tol=cluster_cfg.tol, seed=cluster_cfg.seed))
    return SpectralResult(out.labels, vals, vecs, out.n_iter)


def partition(csr: CSR, eig_cfg: EigenSolverConfig,
              cluster_cfg: ClusterSolverConfig, *,
              info: Optional[dict] = None) -> SpectralResult:
    """Balanced-cut spectral partition (reference partition.hpp:64-112):
    the ``n_eig_vecs`` smallest Laplacian eigenvectors (the constant one
    kept, as in the reference), row-normalized, clustered by k-means.
    ``info``, a dict, receives the Ritz ``residuals`` and the
    ``restarts``. Runs on the CSR's device."""
    return _solve(LaplacianMatrix(csr).matvec, csr, eig_cfg, cluster_cfg,
                  True, info)


def analyze_partition(csr: CSR, labels, n_clusters: int):
    """The edge cut and the size-balance cost (reference
    partition.hpp:133 analyzePartition)."""
    labels = torch.as_tensor(labels, device=csr.data.device).long()
    valid = csr.valid_mask()
    rows = torch.where(valid, csr.row_ids(), 0).long()
    cross = valid & (labels[rows] != labels[csr.indices.long()])
    edge_cut = torch.sum(torch.where(cross, csr.data,
                                     torch.zeros_like(csr.data))) / 2.0
    sizes = torch.zeros(n_clusters, device=labels.device).index_add_(
        0, labels, torch.ones(labels.shape[0], device=labels.device))
    cost = torch.sum(torch.where(sizes > 0, 1.0 / torch.clamp_min(sizes, 1.0),
                                 torch.zeros_like(sizes)))
    return edge_cut, cost


def modularity_maximization(csr: CSR, eig_cfg: EigenSolverConfig,
                            cluster_cfg: ClusterSolverConfig, *,
                            info: Optional[dict] = None) -> SpectralResult:
    """Clusters from the LARGEST eigenvectors of the modularity matrix
    (reference detail/modularity_maximization.hpp); ``info`` as for
    :func:`partition`."""
    return _solve(ModularityMatrix(csr).matvec, csr, eig_cfg, cluster_cfg,
                  False, info)


def analyze_modularity(csr: CSR, labels) -> torch.Tensor:
    """Modularity Q = Σ_c (e_c / 2m - (d_c / 2m)²) (reference
    detail/modularity_maximization.hpp analyzeModularity)."""
    labels = torch.as_tensor(labels, device=csr.data.device).long()
    valid = csr.valid_mask()
    rows = torch.where(valid, csr.row_ids(), 0).long()
    w = torch.where(valid, csr.data, torch.zeros_like(csr.data))
    two_m = torch.sum(w)
    intra = torch.sum(torch.where(labels[rows] == labels[csr.indices.long()],
                                  w, torch.zeros_like(w)))
    deg = scatter_rows(csr, w)
    dc = torch.zeros_like(deg).index_add_(0, labels, deg)
    return intra / two_m - torch.sum((dc / two_m) ** 2)
