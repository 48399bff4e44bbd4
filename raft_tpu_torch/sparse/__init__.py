"""Sparse suite of the port — the counterpart of ``raft_tpu.sparse``
(analog of raft/sparse): the ``COO`` / ``CSR`` containers and their
converters, the structural ops (``op``), sparse linear algebra
(``linalg``: degrees, norms, symmetrize, transpose, add, ``spmv`` /
``spmm``, ``fit_embedding``), ``knn_graph``, the Borůvka MST (``mst``),
the connected-components fixup (``connect``), single-linkage
clustering (``hierarchy``), and sparse pairwise distances and sparse
brute-force kNN (``distance``: the dense and column-blocked strategies
and the prebuilt :class:`SparseColBlockIndex`)."""

from raft_tpu_torch.sparse.coo import (
    COO, CSR, coo_from_arrays, coo_from_csr, coo_from_dense, csr_from_arrays,
    csr_from_coo, csr_from_scipy,
)
from raft_tpu_torch.sparse import connect, distance, hierarchy, linalg, mst, op
from raft_tpu_torch.sparse.distance import (
    SparseColBlockIndex, densify_rows, sparse_brute_force_knn,
    sparse_colblock_index_build, sparse_pairwise_distance,
)
from raft_tpu_torch.sparse.knn_graph import knn_graph

__all__ = [
    "COO",
    "CSR",
    "coo_from_dense",
    "csr_from_coo",
    "coo_from_csr",
    "csr_from_scipy",
    "coo_from_arrays",
    "csr_from_arrays",
    "op",
    "linalg",
    "knn_graph",
    "mst",
    "connect",
    "hierarchy",
    "distance",
    "densify_rows",
    "sparse_pairwise_distance",
    "sparse_brute_force_knn",
    "SparseColBlockIndex",
    "sparse_colblock_index_build",
]
