"""Sparse linear algebra of the port — the part of
``raft_tpu/sparse/linalg.py`` that the kNN-graph build uses:
``coo_degree`` and ``coo_symmetrize`` (reference
sparse/linalg/degree.cuh, sparse/linalg/symmetrize.cuh)."""

from __future__ import annotations

import torch

from raft_tpu_torch.sparse.coo import COO
from raft_tpu_torch.sparse.op import max_duplicates, sum_duplicates

__all__ = ["coo_degree", "coo_symmetrize"]


def coo_degree(coo: COO) -> torch.Tensor:
    """Row degrees (reference sparse/linalg/degree.cuh coo_degree)."""
    return coo.degree()


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
