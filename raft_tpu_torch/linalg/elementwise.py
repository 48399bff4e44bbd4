"""Elementwise primitives of the port — the counterpart of
``raft_tpu/linalg/elementwise.py`` (reference
cpp/include/raft/linalg/detail/{map,unary_op,binary_op,ternary_op,eltwise,
axpy}.cuh).

Each function is one PyTorch expression, kept as a named function so
callers of the reference API have the same surface. Inputs may be
tensors (the call runs on the first one's device) or arrays (placed on
``device``, CUDA by default; float64 becomes float32, as the JAX package
stores it).
"""

from __future__ import annotations

from typing import Callable

import torch

from raft_tpu_torch.core.device import as_tensor, call_device, full_f32

__all__ = [
    "unary_op", "binary_op", "ternary_op", "map_op", "map_then_reduce",
    "add", "add_scalar", "subtract", "subtract_scalar", "multiply_scalar",
    "divide_scalar", "scalar_multiply", "eltwise_multiply", "eltwise_divide",
    "power", "sqrt", "reciprocal", "sign_flip", "axpy", "dot",
]


def _tensors(*arrays, device=None):
    dev = call_device(*arrays, device=device)
    return [as_tensor(a, dev) for a in arrays]


def unary_op(x, op: Callable, *, device=None):
    """out[i] = op(x[i])  (reference linalg/unary_op.cuh:unaryOp)."""
    return op(*_tensors(x, device=device))


def binary_op(a, b, op: Callable, *, device=None):
    """out[i] = op(a[i], b[i])  (reference linalg/binary_op.cuh)."""
    return op(*_tensors(a, b, device=device))


def ternary_op(a, b, c, op: Callable, *, device=None):
    """out[i] = op(a[i], b[i], c[i])  (reference linalg/ternary_op.cuh)."""
    return op(*_tensors(a, b, c, device=device))


def map_op(op: Callable, *arrays, device=None):
    """out[i] = op(x1[i], ..., xn[i])  (reference linalg/map.cuh:map)."""
    return op(*_tensors(*arrays, device=device))


def map_then_reduce(map_fn: Callable, *arrays, reduce_fn=torch.sum,
                    neutral=None, device=None):
    """Map, then a full reduction (reference linalg/map_then_reduce.cuh).
    ``neutral`` is accepted for parity; ``reduce_fn`` supplies its own
    identity."""
    return reduce_fn(map_fn(*_tensors(*arrays, device=device)))


# -- arithmetic convenience (reference linalg/eltwise.cuh, add.cuh, ...) -----

def add(a, b, *, device=None):
    a, b = _tensors(a, b, device=device)
    return a + b


def add_scalar(x, scalar, *, device=None):
    return _tensors(x, device=device)[0] + scalar


def subtract(a, b, *, device=None):
    a, b = _tensors(a, b, device=device)
    return a - b


def subtract_scalar(x, scalar, *, device=None):
    return _tensors(x, device=device)[0] - scalar


def multiply_scalar(x, scalar, *, device=None):
    return _tensors(x, device=device)[0] * scalar


def divide_scalar(x, scalar, *, device=None):
    return _tensors(x, device=device)[0] / scalar


def scalar_multiply(x, scalar, *, device=None):
    return _tensors(x, device=device)[0] * scalar


def eltwise_multiply(a, b, *, device=None):
    a, b = _tensors(a, b, device=device)
    return a * b


def eltwise_divide(a, b, *, device=None):
    a, b = _tensors(a, b, device=device)
    return a / b


# -- matrix math ops (reference matrix/math.cuh:41-319) ----------------------

def power(x, scalar=None, *, device=None):
    """x * x, or x ** scalar."""
    x = _tensors(x, device=device)[0]
    return x * x if scalar is None else torch.pow(x, scalar)


def sqrt(x, *, device=None):
    return torch.sqrt(_tensors(x, device=device)[0])


def reciprocal(x, scalar=1.0, setzero: bool = False, thres: float = 1e-15,
               *, device=None):
    """out = scalar / x, optionally zeroing small denominators
    (reference matrix/math.cuh reciprocal with setzero)."""
    x = _tensors(x, device=device)[0]
    r = scalar / x
    if setzero:
        r = torch.where(torch.abs(x) <= thres, torch.zeros_like(r), r)
    return r


def sign_flip(x, *, device=None):
    """Flip the sign of each column so that its largest-magnitude entry
    (the first of ties) is positive (reference matrix/math.cuh:signFlip)."""
    x = _tensors(x, device=device)[0]
    idx = torch.argmax(torch.abs(x), dim=0)
    signs = torch.sign(x[idx, torch.arange(x.shape[1], device=x.device)])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return x * signs[None, :]


def axpy(alpha, x, y, *, device=None):
    """y + alpha * x  (reference linalg/axpy.cuh over cublas)."""
    x, y = _tensors(x, y, device=device)
    return y + alpha * x


@full_f32
def dot(x, y, precision="highest", *, device=None):
    """Vector dot product with f32 accumulation (cublasDot analog).
    ``precision`` is accepted for parity: the product is full f32."""
    x, y = _tensors(x, y, device=device)
    acc = torch.promote_types(x.dtype, torch.float32)
    return torch.dot(x.to(acc), y.to(acc))
