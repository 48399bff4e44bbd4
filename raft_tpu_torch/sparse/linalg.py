"""Sparse linear algebra of the port — the counterpart of
``raft_tpu/sparse/linalg.py`` (reference cpp/include/raft/sparse/linalg/:
add.cuh, degree.cuh, norm.cuh, symmetrize.cuh, transpose.cuh,
spectral.cuh, and the cuSPARSE spmv / spmm wrappers).

``spmv`` / ``spmm`` are the JAX package's segment sums: each entry's
product gathered, then each row's products added in their order
(``scatter_rows``), so a call gives the same bits every time, as the
reference's cuSPARSE CSR product does.
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.sparse.coo import (
    COO, CSR, coo_from_csr, csr_from_coo, scatter_rows,
)
from raft_tpu_torch.sparse.op import coo_sort, max_duplicates, sum_duplicates

__all__ = [
    "coo_degree", "csr_row_normalize_l1", "csr_row_normalize_max",
    "rows_norm", "coo_symmetrize", "transpose", "csr_add", "spmv", "spmm",
    "fit_embedding",
]


def coo_degree(coo: COO) -> torch.Tensor:
    """Row degrees (reference sparse/linalg/degree.cuh coo_degree)."""
    return coo.degree()


def _where0(mask, x):
    return torch.where(mask, x, torch.zeros_like(x))


def rows_norm(csr: CSR, norm: str = "l2") -> torch.Tensor:
    """Per-row norms (reference sparse/linalg/norm.cuh rowNormCsr)."""
    if norm == "l1":
        return scatter_rows(csr, torch.abs(csr.data))
    if norm == "l2":
        return torch.sqrt(scatter_rows(csr, csr.data * csr.data))
    if norm == "linf":
        return scatter_rows(csr, torch.abs(csr.data), "amax")
    raise ValueError(norm)


def _scale_rows(csr: CSR, norms) -> CSR:
    valid = csr.valid_mask()
    rows = torch.where(valid, csr.row_ids(), 0).long()
    scale = torch.where(norms == 0, torch.ones_like(norms), norms)[rows]
    return CSR(csr.indptr, csr.indices, _where0(valid, csr.data / scale),
               csr.nnz, csr.shape)


def csr_row_normalize_l1(csr: CSR) -> CSR:
    """Scale the rows to unit L1 norm; empty rows stay 0 (reference
    sparse/linalg/norm.cuh csr_row_normalize_l1)."""
    return _scale_rows(csr, scatter_rows(csr, torch.abs(csr.data)))


def csr_row_normalize_max(csr: CSR) -> CSR:
    """Scale the rows to unit max-magnitude."""
    return _scale_rows(csr, scatter_rows(csr, torch.abs(csr.data), "amax"))


def transpose(coo: COO) -> COO:
    """Swap rows and columns and re-sort (reference
    sparse/linalg/transpose.cuh)."""
    m, n = coo.shape
    return coo_sort(COO(coo.cols, coo.rows, coo.vals, coo.nnz, (n, m)))


def coo_symmetrize(coo: COO, combine: str = "sum") -> COO:
    """A + Aᵀ with duplicates combined (reference
    sparse/linalg/symmetrize.cuh coo_symmetrize): ``"sum"`` adds mirrored
    edges, ``"max"`` keeps the larger (the kNN-graph symmetrization).
    The capacity doubles."""
    valid = coo.valid_mask()
    both_valid = torch.cat([valid, valid])

    def mirrored(a, b):
        x = torch.cat([a, b])
        return torch.where(both_valid, x, torch.zeros_like(x))

    rows = mirrored(coo.rows, coo.cols)
    cols = mirrored(coo.cols, coo.rows)
    vals = mirrored(coo.vals, coo.vals)
    # all valid entries first (the two halves interleave valid and padding)
    order = torch.sort((~both_valid).to(torch.uint8), stable=True)[1]
    both = COO(rows[order], cols[order], vals[order],
               (2 * coo.nnz).to(torch.int32), coo.shape)
    if combine == "sum":
        return sum_duplicates(both)
    return max_duplicates(both)


def csr_add(a: CSR, b: CSR) -> CSR:
    """C = A + B over the union of the structures (reference
    sparse/linalg/add.cuh csr_add_calc_inds / csr_add_finalize). The
    capacity grows to cap_a + cap_b."""
    assert a.shape == b.shape
    ca = coo_from_csr(a)
    cb = coo_from_csr(b)
    valid = torch.cat([ca.valid_mask(), cb.valid_mask()])
    order = torch.sort((~valid).to(torch.uint8), stable=True)[1]

    def merged(x, y):
        return _where0(valid, torch.cat([x, y]))[order]

    return csr_from_coo(sum_duplicates(COO(
        merged(ca.rows, cb.rows), merged(ca.cols, cb.cols),
        merged(ca.vals, cb.vals), (a.nnz + b.nnz).to(torch.int32), a.shape)))


def spmv(csr: CSR, x) -> torch.Tensor:
    """y = A @ x (reference cusparse spmv wrapper): gather, then a
    segment sum by row."""
    x = torch.as_tensor(x, device=csr.data.device)
    return scatter_rows(csr, csr.data * x[csr.indices.long()])


def spmm(csr: CSR, x) -> torch.Tensor:
    """Y = A @ X for a dense X (n, d) (reference cusparse spmm wrapper)."""
    x = torch.as_tensor(x, device=csr.data.device)
    return scatter_rows(csr, x[csr.indices.long()] * csr.data[:, None])


def fit_embedding(csr: CSR, n_components: int, *, seed: int = 42,
                  ncv: Optional[int] = None, info: Optional[dict] = None):
    """Spectral embedding of a symmetric non-negative adjacency CSR (the
    analog of ``raft::sparse::spectral::fit_embedding``,
    sparse/linalg/spectral.cuh): the smallest eigenvectors of the graph
    Laplacian L = D - A by Lanczos, the trivial constant one dropped.
    Returns the (n, n_components) embedding. ``info``, a dict, receives
    the Lanczos ``eigenvalues``, Ritz ``residuals`` and ``restarts``."""
    from raft_tpu_torch.linalg.lanczos import lanczos_solver

    n = csr.shape[0]
    deg = scatter_rows(csr, csr.data)

    def lap_matvec(v):
        return deg * v - spmv(csr, v)

    vals, vecs, res, restarts = lanczos_solver(
        lap_matvec, n, n_components + 1, ncv=ncv, seed=seed, smallest=True,
        return_info=True, device=csr.data.device)
    if info is not None:
        info.update(eigenvalues=vals, residuals=res, restarts=restarts)
    return vecs[:, 1:n_components + 1]
