"""Sparse suite of the port — the counterpart of ``raft_tpu.sparse``
(analog of raft/sparse): the ``COO`` / ``CSR`` containers and their
converters, the structural ops (``op``), sparse linear algebra
(``linalg``: degrees, norms, symmetrize, transpose, add, ``spmv`` /
``spmm``, ``fit_embedding``), ``knn_graph``, the Borůvka MST (``mst``),
the connected-components fixup (``connect``) and single-linkage
clustering (``hierarchy``). Sparse distances (``distance.py``) are not
ported yet."""

from raft_tpu_torch.sparse.coo import (
    COO, CSR, coo_from_arrays, coo_from_csr, coo_from_dense, csr_from_arrays,
    csr_from_coo, csr_from_scipy,
)
from raft_tpu_torch.sparse import connect, hierarchy, linalg, mst, op
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
]
