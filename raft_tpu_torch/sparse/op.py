"""Sparse structural ops of the port — the counterpart of
``raft_tpu/sparse/op.py`` (reference cpp/include/raft/sparse/op/:
sort.cuh coo_sort:41, filter.cuh coo_remove_scalar:46, reduce.cuh
max_duplicates:72, slice.cuh csr_row_slice_*:40-65, row_op.cuh
csr_row_op:39).

Every op keeps the static capacity; dropped entries move to the padded
tail (a stable sort on the drop flag, as the JAX package compacts).
"""

from __future__ import annotations

from typing import Callable

import torch

from raft_tpu_torch.sparse.coo import COO, CSR

__all__ = ["coo_sort", "coo_remove_scalar", "coo_remove_zeros",
           "max_duplicates", "sum_duplicates", "csr_row_slice", "csr_row_op"]


def _reorder(coo: COO, order) -> COO:
    return COO(coo.rows[order], coo.cols[order], coo.vals[order], coo.nnz,
               coo.shape)


def _stable_argsort(key):
    return torch.sort(key, stable=True)[1]


def coo_sort(coo: COO) -> COO:
    """Sort by (row, col), padding last: a stable sort on the column,
    then a stable sort on the row with padding keyed past every valid
    row (the JAX package's two stable argsorts)."""
    valid = coo.valid_mask()
    order1 = _stable_argsort(coo.cols)
    rowkey = torch.where(valid[order1], coo.rows[order1],
                         torch.full_like(coo.rows[order1], coo.shape[0]))
    order2 = _stable_argsort(rowkey)
    return _reorder(coo, order1[order2])


def _where0(mask, x):
    return torch.where(mask, x, torch.zeros_like(x))


def _compact(coo: COO, keep) -> COO:
    """Stable-partition the kept entries to the front; recount nnz."""
    keep = keep & coo.valid_mask()
    order = _stable_argsort((~keep).to(torch.uint8))
    out = _reorder(coo, order)
    nnz = keep.sum().to(torch.int32)
    mask = torch.arange(coo.capacity, device=keep.device) < nnz
    return COO(_where0(mask, out.rows), _where0(mask, out.cols),
               _where0(mask, out.vals), nnz, coo.shape)


def coo_remove_scalar(coo: COO, scalar) -> COO:
    """Drop the entries equal to ``scalar`` (reference op/filter.cuh:46)."""
    return _compact(coo, coo.vals != scalar)


def coo_remove_zeros(coo: COO) -> COO:
    return coo_remove_scalar(coo, 0)


def _lowest(dtype):
    if dtype.is_floating_point:
        return torch.finfo(dtype).min
    return torch.iinfo(dtype).min


def _dedupe(coo: COO, combine: str) -> COO:
    """Collapse duplicate (row, col) entries (reference op/reduce.cuh:72
    max_duplicates): sort, flag group heads, reduce each group's values.
    With ``combine="max"`` a combined value equal to the dtype's lowest
    becomes 0, as in the JAX package."""
    s = coo_sort(coo)
    cap = s.capacity
    dev = s.rows.device
    valid = s.valid_mask()
    pos = torch.arange(cap, device=dev)
    prev_same = ((s.rows == torch.roll(s.rows, 1))
                 & (s.cols == torch.roll(s.cols, 1)) & (pos > 0))
    head = valid & ~prev_same
    seg = torch.cumsum(head.to(torch.int32), 0) - 1     # group id per entry
    seg = torch.where(valid, seg, torch.full_like(seg, cap - 1)).long()
    if combine == "max":
        lowest = _lowest(s.vals.dtype)
        init = torch.full((cap,), lowest, dtype=s.vals.dtype, device=dev)
        combined = init.scatter_reduce(
            0, seg, torch.where(valid, s.vals, init), "amax")
        combined = torch.where(combined == lowest,
                               torch.zeros_like(combined), combined)
    else:
        combined = torch.zeros_like(s.vals).index_add_(
            0, seg, _where0(valid, s.vals))
    n_groups = head.sum().to(torch.int32)
    # representative row/col of each group: its head's
    zeros = torch.zeros(cap, dtype=torch.int32, device=dev)
    rows = zeros.scatter_reduce(0, seg, _where0(head, s.rows), "amax")
    cols = zeros.scatter_reduce(0, seg, _where0(head, s.cols), "amax")
    mask = pos < n_groups
    return COO(_where0(mask, rows), _where0(mask, cols),
               _where0(mask, combined), n_groups, coo.shape)


def max_duplicates(coo: COO) -> COO:
    """Keep the max value among duplicates (reference op/reduce.cuh:72)."""
    return _dedupe(coo, "max")


def sum_duplicates(coo: COO) -> COO:
    """Sum duplicates (the canonicalisation of ``coo_symmetrize``'s
    ``"sum"`` mode)."""
    return _dedupe(coo, "sum")


def csr_row_slice(csr: CSR, start: int, stop: int) -> CSR:
    """Rows [start, stop) (reference op/slice.cuh:40-65
    csr_row_slice_indptr + csr_row_slice_populate). The capacity stays;
    entries outside the slice move to the padded tail."""
    lo = csr.indptr[start]
    hi = csr.indptr[stop]
    pos = torch.arange(csr.capacity, device=csr.indices.device)
    keep = (pos >= lo) & (pos < hi)
    order = _stable_argsort((~keep).to(torch.uint8))
    nnz = (hi - lo).to(torch.int32)
    mask = pos < nnz
    return CSR((csr.indptr[start:stop + 1] - lo).to(torch.int32),
               _where0(mask, csr.indices[order]),
               _where0(mask, csr.data[order]), nnz,
               (stop - start, csr.shape[1]))


def csr_row_op(csr: CSR, fn: Callable) -> CSR:
    """``fn(row_ids, data) -> data`` over the entries (reference
    op/row_op.cuh:39 csr_row_op); padding entries come out 0. The
    padding's row ids are clamped to m - 1 here (the JAX package passes
    m, which its gathers clamp), so ``fn`` may index per-row tensors."""
    rows = torch.clamp_max(csr.row_ids(), csr.shape[0] - 1)
    return CSR(csr.indptr, csr.indices,
               _where0(csr.valid_mask(), fn(rows, csr.data)), csr.nnz,
               csr.shape)
