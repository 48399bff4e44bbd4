"""Sparse suite of the port — the part of ``raft_tpu.sparse`` that the
graph-ANN build runs: the ``COO`` container, ``coo_sort`` and the
duplicate reductions, ``coo_symmetrize`` / ``coo_degree``, and
``knn_graph``. ``CSR``, the converters, sparse distances and the rest
are not ported yet."""

from raft_tpu_torch.sparse import linalg, op
from raft_tpu_torch.sparse.coo import COO
from raft_tpu_torch.sparse.knn_graph import knn_graph

__all__ = ["COO", "knn_graph", "linalg", "op"]
