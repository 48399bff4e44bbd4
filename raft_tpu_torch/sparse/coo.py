"""Sparse COO container of the port — the counterpart of the ``COO`` of
``raft_tpu/sparse/coo.py`` (the analog of the reference sparse core,
cpp/include/raft/sparse/coo.hpp ``class COO``).

The JAX package carries a static capacity plus a ``nnz`` count, because
XLA needs static shapes; the port keeps that contract so that parity
tests compare arrays entry for entry: ``rows``/``cols``/``vals`` have
``capacity >= nnz`` entries, the ones past ``nnz`` are padding (row =
col = 0, val = 0), and ``nnz`` is a 0-d int32 tensor on the entries'
device (reading it as a Python int waits for the device). ``CSR`` and
the converters are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = ["COO"]


@dataclasses.dataclass
class COO:
    """Coordinate-format sparse matrix (reference sparse/coo.hpp:29
    COO<T>): entries past ``nnz`` are padding (row = col = 0, val = 0)."""

    rows: torch.Tensor          # (cap,) int32
    cols: torch.Tensor          # (cap,) int32
    vals: torch.Tensor          # (cap,) T
    nnz: torch.Tensor           # () int32, the count of valid entries
    shape: Tuple[int, int]

    @property
    def capacity(self) -> int:
        return self.rows.shape[0]

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.rows.device) < self.nnz

    def to_dense(self) -> torch.Tensor:
        m, n = self.shape
        v = torch.where(self.valid_mask(), self.vals,
                        torch.zeros_like(self.vals))
        out = torch.zeros((m, n), dtype=self.vals.dtype,
                          device=self.vals.device)
        return out.index_put_((self.rows.long(), self.cols.long()), v,
                              accumulate=True)

    def degree(self) -> torch.Tensor:
        """Row counts (reference sparse/linalg/degree.cuh coo_degree)."""
        ones = self.valid_mask().to(torch.int32)
        return torch.zeros(self.shape[0], dtype=torch.int32,
                           device=self.rows.device).index_add_(
            0, self.rows.long(), ones)
