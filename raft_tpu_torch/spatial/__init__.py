"""Nearest-neighbour search of the port: brute-force kNN, k-selection,
haversine kNN, epsilon neighbourhood (the public names of
``raft_tpu.spatial``), and the ANN indexes under :mod:`.ann`."""

from raft_tpu_torch.spatial import knn
from raft_tpu_torch.spatial.knn import (
    brute_force_knn,
    epsilon_neighborhood,
    haversine_knn,
    knn_merge_parts,
)
from raft_tpu_torch.spatial.selection import (
    SelectKAlgo,
    merge_topk,
    select_k,
    select_k_blocked,
)

__all__ = [
    "knn",
    "SelectKAlgo",
    "select_k",
    "select_k_blocked",
    "merge_topk",
    "brute_force_knn",
    "knn_merge_parts",
    "haversine_knn",
    "epsilon_neighborhood",
]
