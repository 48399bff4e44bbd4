"""Reductions of the port — the counterpart of
``raft_tpu/linalg/reduction.py`` (reference
cpp/include/raft/linalg/detail/{reduce,coalesced_reduction,
strided_reduction,norm,reduce_rows_by_key,reduce_cols_by_key,
mean_squared_error,divide}.cuh).

Reductions take ``dim=`` reduction callables (``torch.sum``,
``torch.amax``, ...), where the JAX package's take ``axis=``. The
by-key reductions follow the JAX package's routes: a one-hot matmul in
f32 (TF32 off) up to 4,096 keys, a scatter-add (``index_add_``) above,
so integer-valued inputs give the same sums in both packages.
"""

from __future__ import annotations

from typing import Callable

import torch

from raft_tpu_torch.core.device import as_tensor, call_device, full_f32

__all__ = [
    "L1Norm", "L2Norm", "LinfNorm", "reduce", "coalesced_reduction",
    "strided_reduction", "norm", "row_norm", "col_norm",
    "reduce_rows_by_key", "reduce_cols_by_key", "mean_squared_error",
    "binary_div_skip_zero",
]

# norm type tags (reference linalg/norm.cuh NormType)
L1Norm = "l1"
L2Norm = "l2"
LinfNorm = "linf"

# the JAX package's one-hot route ends here (reduction.py:85)
_ONE_HOT_MAX_KEYS = 4096


def _identity(v):
    return v


def _t(x, device):
    return as_tensor(x, call_device(x, device=device))


def reduce(x, axis: int, main_op: Callable = _identity,
           reduce_op=torch.sum, final_op: Callable = _identity, init=None,
           *, device=None):
    """Generic fused reduce (reference linalg/reduce.cuh): ``main_op``
    per element, ``reduce_op(v, dim=axis)`` over ``axis``, ``final_op``
    on the result. ``init`` is accepted for parity."""
    x = _t(x, device)
    return final_op(reduce_op(main_op(x), dim=axis))


def coalesced_reduction(x, main_op=_identity, reduce_op=torch.sum,
                        final_op=_identity, *, device=None):
    """Reduce along the last (contiguous) axis (reference
    linalg/coalesced_reduction.cuh)."""
    return reduce(x, -1, main_op, reduce_op, final_op, device=device)


def strided_reduction(x, main_op=_identity, reduce_op=torch.sum,
                      final_op=_identity, *, device=None):
    """Reduce along the first (strided) axis (reference
    linalg/strided_reduction.cuh)."""
    return reduce(x, 0, main_op, reduce_op, final_op, device=device)


def norm(x, norm_type: str = L2Norm, axis: int = -1, do_sqrt: bool = False,
         *, device=None):
    """Row or column norms (reference linalg/norm.cuh rowNorm/colNorm).
    As in the reference, L2 without ``do_sqrt`` is the squared norm."""
    x = _t(x, device)
    if norm_type == L1Norm:
        return torch.sum(torch.abs(x), dim=axis)
    if norm_type == L2Norm:
        sq = torch.sum(x * x, dim=axis)
        return torch.sqrt(sq) if do_sqrt else sq
    if norm_type == LinfNorm:
        return torch.amax(torch.abs(x), dim=axis)
    raise ValueError(f"unknown norm type {norm_type}")


def row_norm(x, norm_type: str = L2Norm, do_sqrt: bool = False, *,
             device=None):
    return norm(x, norm_type, axis=-1, do_sqrt=do_sqrt, device=device)


def col_norm(x, norm_type: str = L2Norm, do_sqrt: bool = False, *,
             device=None):
    return norm(x, norm_type, axis=0, do_sqrt=do_sqrt, device=device)


def _one_hot(keys, n_keys: int, dtype):
    return torch.nn.functional.one_hot(keys.long(), n_keys).to(dtype)


@full_f32
def reduce_rows_by_key(x, keys, n_keys: int, weights=None, *, device=None):
    """sums[key, :] += w * x[row, :] (reference
    linalg/reduce_rows_by_key.cuh): ``onehotᵀ @ x`` in f32 for up to
    4,096 keys, else a scatter-add. The result has ``x``'s dtype."""
    dev = call_device(x, keys, weights, device=device)
    x = as_tensor(x, dev)
    keys = as_tensor(keys, dev)
    if weights is not None:
        x = x * as_tensor(weights, dev)[:, None]
    if n_keys <= _ONE_HOT_MAX_KEYS:
        acc = torch.promote_types(x.dtype, torch.float32)
        onehot = _one_hot(keys, n_keys, acc)
        return (onehot.T @ x.to(acc)).to(x.dtype)
    out = torch.zeros((n_keys,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=dev)
    return out.index_add_(0, keys.long(), x)


@full_f32
def reduce_cols_by_key(x, keys, n_keys: int, *, device=None):
    """out[i, key] += x[i, col] for each column's key (reference
    linalg/reduce_cols_by_key.cuh): ``x @ onehot`` in f32."""
    dev = call_device(x, keys, device=device)
    x = as_tensor(x, dev)
    keys = as_tensor(keys, dev)
    acc = torch.promote_types(x.dtype, torch.float32)
    return (x.to(acc) @ _one_hot(keys, n_keys, acc)).to(x.dtype)


def mean_squared_error(a, b, weight: float = 1.0, *, device=None):
    """weight * mean((a - b)²)  (reference linalg/mean_squared_error.cuh)."""
    dev = call_device(a, b, device=device)
    d = as_tensor(a, dev) - as_tensor(b, dev)
    return weight * torch.mean(d * d)


def binary_div_skip_zero(a, b, return_zero: bool = False, *, device=None):
    """a / b where b != 0; elsewhere 0 (``return_zero``) or a (reference
    linalg/divide.cuh)."""
    dev = call_device(a, b, device=device)
    a = as_tensor(a, dev)
    b = as_tensor(b, dev)
    zero = b == 0
    out = a / torch.where(zero, torch.ones_like(b), b)
    return torch.where(zero, torch.zeros_like(out) if return_zero else a,
                       out)
