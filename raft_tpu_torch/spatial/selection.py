"""k-selection of the port — the counterpart of
``raft_tpu/spatial/selection.py`` (the analog of the reference top-k
family, cpp/include/raft/spatial/knn/knn.cuh:68-165 ``select_k`` +
``SelectKAlgo``).

Tie order is part of the result. ``lax.top_k`` returns equal values
lowest index first and orders floats totally: ``-0.0`` before ``0.0``,
a NaN by its sign bit. ``torch.topk`` promises neither, so every
selection here goes through :func:`top_k_smallest`, a stable sort on the
total-order integer key of each value. ``jnp.argsort`` (the ``SORT``
algorithm) is stable too but compares ``-0.0`` equal to ``0.0`` and puts
every NaN last, which is what ``torch.sort(stable=True)`` does, so
``SORT`` uses that. ``APPROX`` (``lax.approx_min_k``) is exact here, as
it is in the JAX package off the TPU.

On the card, :func:`top_k_smallest` runs a hand-written selection,
:func:`top_k_smallest_kernel` (``raft_tpu_torch/csrc/select_k.cu``; its
source note says what bounds it and what the design does about that),
wherever the input's shape allows: a CUDA float32 tensor with
``1 <= k <= min(n, SELECT_K_MAX_K)`` and rows of ``n <= SELECT_K_MAX_ROW``
entries (:func:`select_k_kernel_fits`; both limits are read from the
kernel's source). It returns the stable sort's result bit for bit.
Everything else (CPU tensors, other dtypes, larger k, longer rows) takes
the plain version, :func:`top_k_smallest_plain`. :data:`SELECT_K_LAUNCHES`
counts the kernel's launches, and the counter
``select_k_calls_total{route="kernel"|"sort"}`` of
:func:`raft_tpu_torch.obs.metrics.default_registry` counts the calls by
the route the same test chose (``RAFT_TPU_OBS`` gates it as it gates
every series).
"""

from __future__ import annotations

import ctypes
import enum
import functools
import re
from pathlib import Path
from typing import Tuple

import torch

from raft_tpu_torch import errors
from raft_tpu_torch.obs import metrics as _metrics

__all__ = [
    "SELECT_K_LAUNCHES", "SELECT_K_MAX_K", "SELECT_K_MAX_ROW", "SelectKAlgo",
    "chunk_min_select_k", "merge_parts_provenance_select_k",
    "merge_parts_select_k", "merge_topk", "select_k", "select_k_blocked",
    "select_k_kernel_fits", "top_k_smallest", "top_k_smallest_kernel",
    "top_k_smallest_plain",
]


def _kernel_limits():
    """(kMaxK, kMaxRow) as ``csrc/select_k.cu`` defines them: the
    survivors it sorts, and the keys of a row it holds in shared
    memory."""
    src = (Path(__file__).resolve().parents[1] / "csrc"
           / "select_k.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);",
                               src).group(1))
                 for name in ("kMaxK", "kMaxRow"))


SELECT_K_MAX_K, SELECT_K_MAX_ROW = _kernel_limits()
# kernel launches since import (or since a caller reset it to 0)
SELECT_K_LAUNCHES = 0
# the route counter's handles, by "the kernel is the route"
_ROUTES = {}

_INT_OF = {
    torch.float16: torch.int16, torch.bfloat16: torch.int16,
    torch.float32: torch.int32, torch.float64: torch.int64,
}


class SelectKAlgo(enum.IntEnum):
    """Mirror of the reference algo enum (knn.cuh:68-79), with the JAX
    package's values."""

    AUTO = -1
    TOPK = 0        # stable total-order selection (lax.top_k)
    SORT = 1        # full stable sort (jnp.argsort), for k close to n
    BLOCKED = 2     # streaming blocked top-k (select_k_blocked)
    CHUNK_MIN = 3   # exact two-stage: chunk extrema -> gather -> select
    APPROX = 4      # exact here (lax.approx_min_k is exact off the TPU)


def _total_order_key(x):
    """An integer tensor that sorts like ``x`` under IEEE total order
    (``-NaN < -inf < ... < -0.0 < 0.0 < ... < inf < NaN``)."""
    bits = x.contiguous().view(_INT_OF[x.dtype])
    mask = torch.iinfo(bits.dtype).max
    return bits ^ ((bits >> (8 * bits.element_size() - 1)) & mask)


def top_k_smallest_plain(x, k: int):
    """Plain version of :func:`top_k_smallest`: a stable sort of the
    total-order keys (of the values themselves for integer dtypes), its
    first ``k`` indices, and the values gathered at them."""
    if x.dtype in _INT_OF:
        _, idx = torch.sort(_total_order_key(x), dim=-1, stable=True)
        idx = idx[..., :k]
        return torch.gather(x, -1, idx), idx
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def select_k_kernel_fits(x, k: int) -> bool:
    """Does ``top_k_smallest(x, k)`` take the kernel? A CUDA float32
    tensor of at least one row, ``1 <= k <= min(n, SELECT_K_MAX_K)`` and
    ``n <= SELECT_K_MAX_ROW`` for its last-axis length ``n``."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.dim() < 1:
        return False
    n = x.shape[-1]
    rows = x.numel() // n if n else 0
    return (1 <= k <= min(n, SELECT_K_MAX_K) and n <= SELECT_K_MAX_ROW
            and 1 <= rows < 2 ** 31)


def top_k_smallest(x, k: int):
    """The ``k`` smallest values along the last axis and their int64
    indices, ascending, equal values lowest index first: what
    ``lax.top_k(-x, k)`` selects, with the sign undone. Leading axes are
    batch axes. The kernel where :func:`select_k_kernel_fits`, else
    :func:`top_k_smallest_plain`; both give the same bits."""
    kernel = select_k_kernel_fits(x, k)
    counter = _ROUTES.get(kernel)
    if counter is None:
        counter = _ROUTES[kernel] = _metrics.default_registry().counter(
            "select_k_calls_total", route="kernel" if kernel else "sort")
    counter.inc()
    if kernel:
        return top_k_smallest_kernel(x, k)
    return top_k_smallest_plain(x, k)


def top_k_smallest_kernel(x, k: int):
    """:func:`top_k_smallest` by one launch of the selection kernel, for
    an ``x`` that :func:`select_k_kernel_fits`; counts the launch in
    :data:`SELECT_K_LAUNCHES`."""
    n = x.shape[-1]
    xc = x.contiguous()
    vals = torch.empty(x.shape[:-1] + (k,), dtype=torch.float32,
                       device=x.device)
    idx = torch.empty(x.shape[:-1] + (k,), dtype=torch.int64,
                      device=x.device)
    lib = _select_k_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (xc.data_ptr(), vals.data_ptr(), idx.data_ptr(),
            xc.numel() // n, n, k, stream)
    if torch.cuda.current_device() == x.device.index:
        err = lib.raft_select_k(*args)
    else:
        with torch.cuda.device(x.device):
            err = lib.raft_select_k(*args)
    if err:
        raise RuntimeError(
            f"top_k_smallest: kernel launch failed: CUDA error {err} "
            f"({lib.raft_select_k_error_string(err).decode()})")
    global SELECT_K_LAUNCHES
    SELECT_K_LAUNCHES += 1
    return vals, idx


@functools.cache
def _select_k_lib():
    from raft_tpu_torch import _build

    lib = _build.load("select_k")
    fn = lib.raft_select_k
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, p]
        fn.restype = i
        lib.raft_select_k_error_string.argtypes = [i]
        lib.raft_select_k_error_string.restype = ctypes.c_char_p
    return lib


def _select(x, k: int, select_min: bool):
    if select_min:
        return top_k_smallest(x, k)
    vals, idx = top_k_smallest(-x, k)
    return -vals, idx


def _resolve(algo, n: int, k: int) -> SelectKAlgo:
    if algo in (SelectKAlgo.AUTO, None):
        return SelectKAlgo.SORT if k * 4 >= n else SelectKAlgo.TOPK
    return SelectKAlgo(algo)


def select_k(dists, k: int, *, select_min: bool = True, indices=None,
             algo: SelectKAlgo = SelectKAlgo.AUTO
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row k smallest (or largest) values and their indices.

    dists: (m, n); optional ``indices`` (m, n) carries source labels;
    defaults to column positions. Returns (values (m, k), int32 indices
    (m, k)), best-first."""
    errors.check_matrix(dists, "dists")
    m, n = dists.shape
    errors.check_k(k, n, "row length")
    errors.expects(
        indices is None or tuple(indices.shape) == (m, n),
        "indices: expected shape %s, got %s",
        (m, n), None if indices is None else tuple(indices.shape),
    )
    algo = _resolve(algo, n, k)
    if algo == SelectKAlgo.SORT:
        idxs = torch.sort(dists if select_min else -dists, dim=1,
                          stable=True)[1][:, :k]
        vals = torch.gather(dists, 1, idxs)
    elif algo == SelectKAlgo.CHUNK_MIN:
        vals, idxs = chunk_min_select_k(dists, k, select_min=select_min)
    else:
        vals, idxs = _select(dists, k, select_min)
    if indices is not None:
        idxs = torch.gather(torch.as_tensor(indices, device=dists.device),
                            1, idxs.long())
    return vals, idxs.to(torch.int32)


def chunk_min_select_k(dists, k: int, *, select_min: bool = True,
                       chunk: int = 128):
    """Exact two-stage selection: per-chunk extrema -> top-k chunks ->
    gather -> final top-k over k*chunk candidates (the true top-k values
    occupy at most k chunks, each of which ranks in the top-k chunks).
    Returns int64 indices."""
    q, n = dists.shape
    if n % chunk or n // chunk < k:
        return _select(dists, k, select_min)
    xr = dists.reshape(q, n // chunk, chunk)
    ext = torch.amin(xr, dim=2) if select_min else torch.amax(xr, dim=2)
    _, cidx = _select(ext, k, select_min)                    # (q, k)
    cand = torch.gather(xr, 1, cidx[:, :, None].expand(q, k, chunk))
    nv, p = _select(cand.reshape(q, k * chunk), k, select_min)
    which = torch.gather(cidx, 1, p // chunk)
    return nv, which * chunk + p % chunk


def merge_parts_select_k(part_vals, part_ids, k: int, *, ways=None,
                         select_min: bool = True):
    """k-way merge of per-part top-k payloads (P, nq, kk) in one
    :func:`select_k` call (the reference's ``knn_merge_parts``); ``ways``
    pads the part axis with worst-value / -1 absent parts."""
    n_parts, nq, kk = part_vals.shape
    if ways is not None and ways > n_parts:
        extra = ways - n_parts
        fill = float("inf") if select_min else float("-inf")
        part_vals = torch.cat([part_vals, torch.full(
            (extra, nq, kk), fill, dtype=part_vals.dtype,
            device=part_vals.device)])
        part_ids = torch.cat([part_ids, torch.full(
            (extra, nq, kk), -1, dtype=part_ids.dtype,
            device=part_ids.device)])
    flat_v = part_vals.permute(1, 0, 2).reshape(nq, -1)
    flat_i = part_ids.permute(1, 0, 2).reshape(nq, -1)
    return select_k(flat_v, k, select_min=select_min, indices=flat_i)


def merge_parts_provenance_select_k(part_vals, part_ids, k: int, *,
                                    select_min: bool = True):
    """:func:`merge_parts_select_k` that also reports the source part and
    the slot within that part's payload of each selected entry: returns
    ``(vals, ids, part, slot)``, each (nq, k)."""
    n_parts, nq, kk = part_vals.shape
    flat_v = part_vals.permute(1, 0, 2).reshape(nq, -1)
    flat_i = part_ids.permute(1, 0, 2).reshape(nq, -1)
    vals, pos = select_k(flat_v, k, select_min=select_min)
    pos = pos.long()
    ids = torch.gather(flat_i, 1, pos)
    return (vals, ids, (pos // kk).to(torch.int32),
            (pos % kk).to(torch.int32))


def merge_topk(vals_a, idx_a, vals_b, idx_b, *, select_min: bool = True):
    """Merge two best-first top-k lists per row into one (ties: list a,
    then list b, each in its own order)."""
    k = vals_a.shape[-1]
    vals = torch.cat([vals_a, vals_b], dim=-1)
    idxs = torch.cat([idx_a, idx_b.to(idx_a.dtype)], dim=-1)
    mvals, pos = _select(vals, k, select_min)
    return mvals, torch.gather(idxs, -1, pos)


def select_k_blocked(dists, k: int, *, select_min: bool = True,
                     block_n: int = 2048
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming top-k over (m, block_n) column slabs, folding each
    slab's local top-k into a running list (working set 2k per row)."""
    m, n = dists.shape
    if block_n >= n:
        return select_k(dists, k, select_min=select_min)
    fill = float("inf") if select_min else float("-inf")
    vals = idxs = None
    for j0 in range(0, n, block_n):
        blk = dists[:, j0:j0 + block_n]
        if blk.shape[1] < block_n:
            blk = torch.nn.functional.pad(blk, (0, block_n - blk.shape[1]),
                                          value=fill)
        bv, bi = _select(blk, k, select_min)
        if vals is None:
            vals, idxs = bv, bi
        else:
            vals, idxs = merge_topk(vals, idxs, bv, bi + j0,
                                    select_min=select_min)
    return vals, idxs.to(torch.int32)
