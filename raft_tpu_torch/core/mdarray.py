"""mdarray/mdspan analog — the port of ``raft_tpu/core/mdarray.py``:
typed nd-array factories, host/device conversion and validation.

Reference: cpp/include/raft/core/mdarray.hpp (owning ``mdarray``,
non-owning ``mdspan`` with ``row_major`` / ``col_major`` layouts and
host/device accessor policies; factories ``make_device_matrix`` /
``_vector`` / ``_scalar``). A ``torch.Tensor`` already is an owning nd
array on a device, and numpy covers host arrays, so what remains is:

* layout tags, with :func:`as_layout` giving a column-major tensor its
  Fortran strides (``.T.contiguous().T``: same values, same shape);
* factories that allocate on the :class:`~.resources.Resources`'s device
  (``None`` -> the default resources: CUDA, raising without it);
* the validation helpers the algorithm layers use as static extents.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = [
    "ROW_MAJOR", "COL_MAJOR", "make_device_matrix", "make_device_vector",
    "make_device_scalar", "make_host_matrix", "make_host_vector",
    "to_device", "to_host", "expect_matrix", "expect_vector",
    "expect_same_dtype", "as_layout",
]

# layout tags (reference mdarray.hpp:45-56)
ROW_MAJOR = "row_major"
COL_MAJOR = "col_major"


def _device_of(res) -> torch.device:
    from raft_tpu_torch.core.resources import ensure_resources

    return ensure_resources(res).device


def _dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch, numpy or string dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


# -- owning factories (reference make_device_* / make_host_*) ----------------

def make_device_matrix(res, n_rows: int, n_cols: int,
                       dtype=torch.float32) -> torch.Tensor:
    return torch.zeros((n_rows, n_cols), dtype=_dtype(dtype),
                       device=_device_of(res))


def make_device_vector(res, n: int, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros((n,), dtype=_dtype(dtype), device=_device_of(res))


def make_device_scalar(res, value, dtype=None) -> torch.Tensor:
    return torch.as_tensor(value, dtype=None if dtype is None
                           else _dtype(dtype), device=_device_of(res))


def make_host_matrix(n_rows: int, n_cols: int, dtype=np.float32) -> np.ndarray:
    return np.zeros((n_rows, n_cols), dtype=dtype)


def make_host_vector(n: int, dtype=np.float32) -> np.ndarray:
    return np.zeros((n,), dtype=dtype)


# -- conversion (host_mdspan <-> device_mdspan analog) -----------------------

def to_device(res, x) -> torch.Tensor:
    return torch.as_tensor(x, device=_device_of(res))


def to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# -- validation helpers (static-extent checks) -------------------------------

def expect_matrix(x, name: str = "x") -> None:
    if x.ndim != 2:
        raise ValueError(f"{name}: expected a matrix (2d), got shape "
                         f"{tuple(x.shape)}")


def expect_vector(x, name: str = "x") -> None:
    if x.ndim != 1:
        raise ValueError(f"{name}: expected a vector (1d), got shape "
                         f"{tuple(x.shape)}")


def expect_same_dtype(*arrays) -> None:
    dts = {str(a.dtype).replace("torch.", "") for a in arrays}
    if len(dts) > 1:
        raise TypeError(f"dtype mismatch: {sorted(dts)}")


def as_layout(x: Any, layout: str) -> torch.Tensor:
    """``x`` as a tensor in the given memory order: row-major is
    C-contiguous, column-major has Fortran strides (``.T.contiguous().T``);
    values and shape are unchanged."""
    if layout not in (ROW_MAJOR, COL_MAJOR):
        raise ValueError(f"unknown layout {layout}")
    t = torch.as_tensor(x)
    if layout == ROW_MAJOR or t.dim() < 2:
        return t.contiguous()
    return t.mT.contiguous().mT
