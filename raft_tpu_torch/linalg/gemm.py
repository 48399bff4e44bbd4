"""GEMM / GEMV of the port — the counterpart of ``raft_tpu/linalg/gemm.py``
(reference raft/linalg/{gemm,gemv}.cuh over cuBLAS).

``torch.matmul`` with f32 accumulation and TF32 off (the JAX package runs
these at HIGHEST precision, outside any Pallas kernel); the result takes
``a``'s dtype, as in the JAX package.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.device import as_tensor, call_device, full_f32

__all__ = ["gemm", "gemv", "transpose"]


def _acc_dtype(*xs):
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return torch.promote_types(dt, torch.float32)


@full_f32
def gemm(a, b, trans_a: bool = False, trans_b: bool = False,
         alpha=1.0, beta=0.0, c=None, precision="highest", *, device=None):
    """alpha * op(a) @ op(b) + beta * c  (reference linalg/gemm.cuh).
    ``precision`` is accepted for parity: products are full f32."""
    dev = call_device(a, b, c, device=device)
    a = as_tensor(a, dev)
    b = as_tensor(b, dev)
    if trans_a:
        a = a.T
    if trans_b:
        b = b.T
    acc = _acc_dtype(a, b)
    out = alpha * (a.to(acc) @ b.to(acc))
    if c is not None and beta != 0.0:
        out = out + beta * as_tensor(c, dev)
    return out.to(a.dtype)


@full_f32
def gemv(a, x, trans_a: bool = False, alpha=1.0, beta=0.0, y=None,
         precision="highest", *, device=None):
    """alpha * op(a) @ x + beta * y  (reference linalg/gemv.cuh)."""
    dev = call_device(a, x, y, device=device)
    a = as_tensor(a, dev)
    x = as_tensor(x, dev)
    if trans_a:
        a = a.T
    acc = _acc_dtype(a, x)
    out = alpha * (a.to(acc) @ x.to(acc))
    if y is not None and beta != 0.0:
        out = out + beta * as_tensor(y, dev)
    return out.to(a.dtype)


def transpose(a, *, device=None):
    """Out-of-place transpose (reference linalg/transpose.cuh): the axes
    reversed, as ``jnp`` ``.T`` does."""
    a = as_tensor(a, call_device(a, device=device))
    return a.permute(*reversed(range(a.ndim))).contiguous()
