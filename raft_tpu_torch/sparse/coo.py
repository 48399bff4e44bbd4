"""Sparse COO container of the port — the counterpart of the ``COO`` of
``raft_tpu/sparse/coo.py`` (the analog of the reference sparse core,
cpp/include/raft/sparse/coo.hpp ``class COO``).

The JAX package carries a static capacity plus a ``nnz`` count, because
XLA needs static shapes; the port keeps that contract so that parity
tests compare arrays entry for entry: ``rows``/``cols``/``vals`` have
``capacity >= nnz`` entries, the ones past ``nnz`` are padding (row =
col = 0, val = 0), and ``nnz`` is a 0-d int32 tensor on the entries'
device (reading it as a Python int waits for the device). ``CSR``
keeps an exact ``indptr`` (m + 1 entries) and pads ``indices`` / ``data``
to capacity the same way.

The JAX package's scatters drop out-of-range indices and its gathers
clamp them; PyTorch raises on both. A CSR's padding entries have row id
m (``CSR.row_ids``, as in the JAX package), so the port scatters by row
into m + 1 slots and drops the last (:func:`scatter_rows`), which is the
JAX package's drop.

:func:`coo_from_arrays` / :func:`csr_from_arrays` carry a JAX ``COO`` /
``CSR`` across as numpy arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.device import as_tensor, call_device

__all__ = [
    "COO", "CSR", "coo_from_dense", "csr_from_coo", "coo_from_csr",
    "csr_from_scipy", "coo_from_arrays", "csr_from_arrays", "scatter_rows",
]


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


@dataclasses.dataclass
class CSR:
    """Compressed-sparse-row matrix (reference sparse/csr.hpp): ``indptr``
    is exact (m + 1 entries); ``indices`` / ``data`` are padded to
    capacity (index 0, value 0)."""

    indptr: torch.Tensor        # (m+1,) int32
    indices: torch.Tensor       # (cap,) int32
    data: torch.Tensor          # (cap,) T
    nnz: torch.Tensor           # () int32
    shape: Tuple[int, int]

    @property
    def capacity(self) -> int:
        return self.indices.shape[0]

    def valid_mask(self) -> torch.Tensor:
        return (torch.arange(self.capacity, device=self.indices.device)
                < self.nnz)

    def row_ids(self) -> torch.Tensor:
        """Each entry's row (reference csr_to_coo, sparse/convert/coo.cuh):
        the number of rows whose range starts at or before it, minus 1.
        Padding entries get row m, as in the JAX package."""
        pos = torch.arange(self.capacity, device=self.indptr.device,
                           dtype=self.indptr.dtype)
        return (torch.searchsorted(self.indptr, pos, right=True) - 1).to(
            torch.int32)

    def to_dense(self) -> torch.Tensor:
        m, n = self.shape
        out = torch.zeros((m + 1, n), dtype=self.data.dtype,
                          device=self.data.device)
        out.index_put_((self.row_ids().long(), self.indices.long()),
                       self.data, accumulate=True)
        return out[:m]


def scatter_rows(csr: CSR, contrib, reduce: str = "sum"):
    """Reduce ``contrib`` (one value, or row, per entry) into the CSR's
    m rows; padding entries (row m) fall into an extra slot that is
    dropped, as the JAX package's scatter drops them, so they need no
    mask. ``reduce``: ``"sum"`` or ``"amax"`` (from 0).

    A floating-point sum adds each row's entries in their order
    (``segment_reduce`` over ``indptr`` with the padding as one more
    segment, no host sync), so the card gives the same bits on every
    call, and the CPU the JAX package's bits; integer sums and maxima
    are exact in any order and scatter by ``row_ids``."""
    m = csr.shape[0]
    if reduce == "sum" and contrib.is_floating_point():
        offsets = torch.nn.functional.pad(csr.indptr.long(), (0, 1),
                                          value=contrib.shape[0])
        return torch.segment_reduce(contrib, "sum", offsets=offsets,
                                    unsafe=True)[:m]
    rows = csr.row_ids().long()
    out = torch.zeros((m + 1,) + tuple(contrib.shape[1:]),
                      dtype=contrib.dtype, device=contrib.device)
    if reduce == "sum":
        return out.index_add_(0, rows, contrib)[:m]
    return out.scatter_reduce_(0, rows, contrib, reduce)[:m]


def _padded(a, cap: int, dtype):
    a = np.asarray(a)
    return np.concatenate([a, np.zeros(cap - len(a), a.dtype)]).astype(dtype)


def coo_from_dense(x, capacity: Optional[int] = None, *, device=None) -> COO:
    """A COO of a dense matrix's non-zeros, row-major, padded to
    ``capacity`` (host-side constructor, as in the JAX package). Runs on
    ``device`` when given, else on ``x``'s device if it is a tensor,
    else on CUDA."""
    dev = call_device(x, device=device)
    xn = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    r, c = np.nonzero(xn)
    v = xn[r, c]
    nnz = len(v)
    cap = capacity or max(nnz, 1)
    assert cap >= nnz
    return COO(
        torch.as_tensor(_padded(r, cap, np.int32), device=dev),
        torch.as_tensor(_padded(c, cap, np.int32), device=dev),
        as_tensor(_padded(v, cap, v.dtype), dev),
        torch.tensor(nnz, dtype=torch.int32, device=dev),
        tuple(xn.shape),
    )


def csr_from_coo(coo: COO, *, sorted_rows: bool = False) -> CSR:
    """COO -> CSR (reference sparse/convert/csr.cuh sorted_coo_to_csr):
    sorts by (row, col) unless ``sorted_rows``; padding stays at the
    tail."""
    from raft_tpu_torch.sparse.op import coo_sort

    if not sorted_rows:
        coo = coo_sort(coo)
    m = coo.shape[0]
    dev = coo.rows.device
    counts = torch.zeros(m, dtype=torch.int32, device=dev).index_add_(
        0, coo.rows.long(), coo.valid_mask().to(torch.int32))
    indptr = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                        torch.cumsum(counts, 0).to(torch.int32)])
    return CSR(indptr, coo.cols, coo.vals, coo.nnz, coo.shape)


def csr_from_scipy(sp, *, device=None) -> CSR:
    """A CSR of any scipy sparse matrix, duplicates summed, values f32
    (the host ingestion boundary, as in the JAX package)."""
    dev = call_device(device=device)
    sp = sp.tocsr()
    sp.sum_duplicates()
    return CSR(
        torch.as_tensor(sp.indptr.astype(np.int32), device=dev),
        torch.as_tensor(sp.indices.astype(np.int32), device=dev),
        torch.as_tensor(sp.data.astype(np.float32), device=dev),
        torch.tensor(sp.nnz, dtype=torch.int32, device=dev),
        tuple(sp.shape),
    )


def coo_from_csr(csr: CSR) -> COO:
    """CSR -> COO (reference sparse/convert/coo.cuh csr_to_coo)."""
    rows = torch.where(csr.valid_mask(), csr.row_ids(), 0).to(torch.int32)
    return COO(rows, csr.indices, csr.data, csr.nnz, csr.shape)


def coo_from_arrays(arrays: dict, *, device=None) -> COO:
    """A JAX ``COO`` carried across: ``arrays`` holds its ``rows``,
    ``cols``, ``vals``, ``nnz`` and ``shape`` as numpy values (e.g.
    ``{f: np.asarray(getattr(coo, f)) for f in ...}``)."""
    dev = call_device(device=device)
    return COO(
        torch.tensor(np.asarray(arrays["rows"], np.int32), device=dev),
        torch.tensor(np.asarray(arrays["cols"], np.int32), device=dev),
        as_tensor(np.array(arrays["vals"]), dev),
        torch.tensor(int(arrays["nnz"]), dtype=torch.int32, device=dev),
        tuple(int(v) for v in arrays["shape"]),
    )


def csr_from_arrays(arrays: dict, *, device=None) -> CSR:
    """A JAX ``CSR`` carried across: ``indptr``, ``indices``, ``data``,
    ``nnz`` and ``shape`` as numpy values."""
    dev = call_device(device=device)
    return CSR(
        torch.tensor(np.asarray(arrays["indptr"], np.int32), device=dev),
        torch.tensor(np.asarray(arrays["indices"], np.int32), device=dev),
        as_tensor(np.array(arrays["data"]), dev),
        torch.tensor(int(arrays["nnz"]), dtype=torch.int32, device=dev),
        tuple(int(v) for v in arrays["shape"]),
    )
