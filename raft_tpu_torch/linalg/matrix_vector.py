"""Matrix-vector broadcasting ops of the port — the counterpart of
``raft_tpu/linalg/matrix_vector.py`` (reference
linalg/detail/matrix_vector_op.cuh, matrix/detail/linewise_op.cuh).

``along_rows=True``: the vector spans the columns (length n_cols) and is
broadcast to every row, the reference's ``bcastAlongRows``.
"""

from __future__ import annotations

from typing import Callable

from raft_tpu_torch.core.device import as_tensor, call_device

__all__ = ["matrix_vector_op", "matrix_vector_binary", "matrix_vector_add",
           "matrix_vector_mul", "linewise_op"]


def _line(v, along_rows: bool):
    return v[None, :] if along_rows else v[:, None]


def matrix_vector_op(mat, vec, op: Callable, along_rows: bool = True, *,
                     device=None):
    """out[i,j] = op(mat[i,j], vec[j]) if ``along_rows`` else
    op(mat[i,j], vec[i]) (reference linalg/matrix_vector_op.cuh)."""
    dev = call_device(mat, vec, device=device)
    return op(as_tensor(mat, dev), _line(as_tensor(vec, dev), along_rows))


def matrix_vector_binary(mat, vec1, vec2, op: Callable,
                         along_rows: bool = True, *, device=None):
    """The two-vector variant (mean / std normalization)."""
    dev = call_device(mat, vec1, vec2, device=device)
    return op(as_tensor(mat, dev), _line(as_tensor(vec1, dev), along_rows),
              _line(as_tensor(vec2, dev), along_rows))


def matrix_vector_add(mat, vec, along_rows: bool = True, *, device=None):
    return matrix_vector_op(mat, vec, lambda m, v: m + v, along_rows,
                            device=device)


def matrix_vector_mul(mat, vec, along_rows: bool = True, *, device=None):
    return matrix_vector_op(mat, vec, lambda m, v: m * v, along_rows,
                            device=device)


def linewise_op(mat, op: Callable, along_lines_rows: bool, *vecs,
                device=None):
    """op(mat_element, *vec_elements) line by line (reference
    matrix/detail/linewise_op.cuh:matrixLinewiseOp)."""
    dev = call_device(mat, *vecs, device=device)
    return op(as_tensor(mat, dev),
              *[_line(as_tensor(v, dev), along_lines_rows) for v in vecs])
