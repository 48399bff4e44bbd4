"""Matrix utilities of the port — the counterpart of
``raft_tpu/matrix/__init__.py`` (analog of raft/matrix, reference
cpp/include/raft/matrix/{matrix,math,col_wise_sort}.cuh).

Slicing, gathers, reversals, arg-extrema, diagonals and triangles as
torch compositions. ``sort_cols_per_row`` sorts stably; ``argmax`` /
``argmin`` return the first index among ties. Functions return new
tensors (the JAX package's are functional too). Tensors stay on their
device; other inputs go to ``device`` (default CUDA, raising without
it).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.device import as_tensor, call_device

__all__ = [
    "copy_rows", "slice_matrix", "truncate_zero_origin", "col_reverse",
    "row_reverse", "get_diagonal", "set_diagonal", "invert_diagonal",
    "argmax", "argmin", "copy_upper_triangular", "ratio", "seq_root",
    "zero_small_values", "sort_cols_per_row",
]


def _t(x, *others, device=None) -> torch.Tensor:
    return as_tensor(x, call_device(x, *others, device=device))


def copy_rows(x, indices, *, device=None):
    """Gather rows (reference matrix.cuh:copyRows)."""
    x = _t(x, indices, device=device)
    return torch.index_select(x, 0, as_tensor(indices, x.device).long())


def slice_matrix(x, x1: int, y1: int, x2: int, y2: int, *, device=None):
    """out = x[x1:x2, y1:y2] (reference matrix.cuh:sliceMatrix)."""
    return _t(x, device=device)[x1:x2, y1:y2].clone()


def truncate_zero_origin(x, n_rows: int, n_cols: int, *, device=None):
    return _t(x, device=device)[:n_rows, :n_cols].clone()


def col_reverse(x, *, device=None):
    """Reverse the column order (reference matrix.cuh:colReverse)."""
    return torch.flip(_t(x, device=device), (1,))


def row_reverse(x, *, device=None):
    """Reverse the row order (reference matrix.cuh:rowReverse)."""
    return torch.flip(_t(x, device=device), (0,))


def get_diagonal(x, *, device=None):
    """The diagonal (reference matrix.cuh:getDiagonalMatrix)."""
    return torch.diagonal(_t(x, device=device)).clone()


def set_diagonal(x, vec, *, device=None):
    x = _t(x, vec, device=device).clone()
    n = min(x.shape)
    idx = torch.arange(n, device=x.device)
    x[idx, idx] = as_tensor(vec, x.device)[:n].to(x.dtype)
    return x


def invert_diagonal(x, *, device=None):
    """1 / the diagonal (reference matrix.cuh:invertDiagonalMatrix)."""
    x = _t(x, device=device).clone()
    n = min(x.shape)
    idx = torch.arange(n, device=x.device)
    x[idx, idx] = 1.0 / x[idx, idx]
    return x


def argmax(x, axis: int = 1, *, device=None):
    """Arg-max per row (axis=1) or per column (axis=0), the first index
    among ties (reference matrix.cuh:argmax)."""
    return torch.argmax(_t(x, device=device), dim=axis)


def argmin(x, axis: int = 1, *, device=None):
    """Arg-min per row (axis=1) or per column (axis=0), the first index
    among ties."""
    return torch.argmin(_t(x, device=device), dim=axis)


def copy_upper_triangular(x, *, device=None):
    """The upper triangle, the rest zero (reference
    matrix.cuh:copyUpperTriangular)."""
    return torch.triu(_t(x, device=device))


def ratio(x, axis: Optional[int] = None, *, device=None):
    """x / sum(x) (reference math.cuh:ratio)."""
    x = _t(x, device=device)
    if axis is None:
        return x / torch.sum(x)
    return x / torch.sum(x, dim=axis, keepdim=True)


def seq_root(x, scalar: float = 1.0, set_neg_zero: bool = False, *,
             device=None):
    """sqrt(scalar * x), negatives clamped to 0 first when
    ``set_neg_zero`` (reference math.cuh:seqRoot)."""
    x = _t(x, device=device) * scalar
    if set_neg_zero:
        x = torch.clamp_min(x, 0)
    return torch.sqrt(x)


def zero_small_values(x, thres: float = 1e-15, *, device=None):
    """|x| <= thres set to zero (reference math.cuh:setSmallValuesZero)."""
    x = _t(x, device=device)
    return torch.where(torch.abs(x) <= thres, torch.zeros_like(x), x)


def sort_cols_per_row(x, ascending: bool = True, *, device=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's values sorted, stably, with their source columns
    (reference matrix/col_wise_sort.cuh:sort_cols_per_row)."""
    x = _t(x, device=device)
    key = x if ascending else -x
    idx = torch.argsort(key, dim=1, stable=True)
    return torch.gather(x, 1, idx), idx
