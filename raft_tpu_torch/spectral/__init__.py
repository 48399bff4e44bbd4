"""Spectral graph methods of the port — the counterpart of
``raft_tpu/spectral`` (analog of raft/spectral: partition.hpp,
modularity_maximization.hpp, matrix_wrappers.hpp, eigen_solvers.hpp,
cluster_solvers.hpp)."""

from raft_tpu_torch.spectral.partition import (
    EigenSolverConfig,
    ClusterSolverConfig,
    LaplacianMatrix,
    ModularityMatrix,
    partition,
    analyze_partition,
    modularity_maximization,
    analyze_modularity,
)

__all__ = [
    "EigenSolverConfig",
    "ClusterSolverConfig",
    "LaplacianMatrix",
    "ModularityMatrix",
    "partition",
    "analyze_partition",
    "modularity_maximization",
    "analyze_modularity",
]
