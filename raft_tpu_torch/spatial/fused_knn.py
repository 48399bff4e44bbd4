"""Fused distance + k-selection kNN of the port — the counterpart of
``raft_tpu/spatial/fused_knn.py`` (the analog of the reference's
``fusedL2kNN``, cpp/include/raft/spatial/knn/detail/fused_l2_knn.cuh:196).

Two phases, exact:

* **Phase 1** (:func:`chunk_mins`, CUDA kernel): for each query, the
  minimum of ``‖y‖² − 2 q·y`` over every 128-row index chunk. Only the
  (m, npad/128) minima leave the kernel.
* **Phase 2**: the top-c chunks by minimum hold every true top-k row (the
  chunk cover argument; ``extra_chunks`` adds margin for phase-1
  rounding), so their rows are rescored and the k best kept. With ``d`` a
  multiple of 128 the rescore is the CUDA kernel :func:`rescore_scores`,
  which reads each 128-row chunk straight from the index, once for up to
  32 of the queries that name it; otherwise (or
  with ``gather_rows`` pinned) a torch gather of the candidate rows, with
  the JAX package's other formula and chunk count.

The three TPU kernels of the JAX module are hand-written for Hopper in
``raft_tpu_torch/csrc/fused_knn.cu`` (its source note says what bounds
each on the H100). Each has a wrapper here that checks its operands,
runs the plain PyTorch version on CPU tensors and launches the kernel on
CUDA tensors (or raises), and counts its launches in :data:`LAUNCHES`.
The JAX ``interpret=`` knob has no counterpart: the tensors' device picks
the plain version or the kernel.

Shape rules kept so that results match the JAX package: ``_plan_blocks``
fixes ``npad`` and with it the chunk count, which gates ``c`` and the
rescore route; the rescore route is the JAX ``use_dma`` predicate
without its TPU-only terms. The index is never padded or copied:
phase 1 masks rows past ``n`` itself.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.device import (
    as_tensor, call_device, full_f32, resolve_device,
)
from raft_tpu_torch.distance.distance_type import DistanceType, resolve_metric
from raft_tpu_torch.distance.pairwise import relu0, sqrt_f64
from raft_tpu_torch.spatial.selection import merge_topk, top_k_smallest

__all__ = [
    "BIG", "LAUNCHES", "RESCORE_GATHER_CALLS", "chunk_mins",
    "chunk_mins_plain", "fused_grid_ok", "fused_knn_supported",
    "fused_l2_knn", "probe_grid_steps", "rescore_scores",
    "rescore_scores_plain",
]

_CHUNK = 128      # rows per chunk: one phase-1 minimum each
BIG = 1e30        # finite score of a row past the index (never +inf)

# the phase-1 kernel's queries per block (csrc/fused_knn.cu kQTile)
_QTILE = 128

# Largest 1-D grid (blocks) of a capability-9.0 card: the phase-1 launch
# is one block per (128-query tile, chunk) on a 1-D grid. See
# _max_grid_steps().
_MAX_GRID_STEPS_DEFAULT = 2**31 - 1

# kernel launches since import (or since a caller reset them to 0)
LAUNCHES = {"chunk_mins": 0, "rescore_scores": 0, "probe_grid_steps": 0}

# fused searches of CUDA tensors whose rescore took the torch gather path
# instead of the rescore kernel (d not a multiple of 128, gather_rows
# pinned, or more candidate slots than chunks)
RESCORE_GATHER_CALLS = 0

# elements of one f32 working tile of the plain versions
_PLAIN_TILE_ELEMS = 1 << 24


def _cdiv(a, b):
    return -(-a // b)


def _round_up(a, b):
    return _cdiv(a, b) * b


def _compute_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype, dtype)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"compute_dtype must be float32 or bfloat16, got {dtype!r}")
    return dtype


# ---------------------------------------------------------------------------
# Phase 1: chunk minima
# ---------------------------------------------------------------------------


@full_f32
def chunk_mins_plain(q, y, ynorm, npad: int,
                     compute_dtype=torch.float32):
    """Plain PyTorch version of :func:`chunk_mins`: the same rounding of
    the operands to the compute type, f32 products and sums, and formula
    order ``ynorm − 2·g``, blocked over index rows so that the (m, n)
    score matrix never exists."""
    cd = _compute_dtype(compute_dtype)
    m = q.shape[0]
    n = y.shape[0]
    qc = q.float().to(cd).float()
    out = torch.full((m, npad // _CHUNK), BIG, dtype=torch.float32,
                     device=q.device)
    rows = max(_CHUNK, _PLAIN_TILE_ELEMS // max(m, 1) // _CHUNK * _CHUNK)
    for s in range(0, n, rows):
        yb = y[s:s + rows].to(cd).float()
        sc = ynorm[s:s + rows].float()[None, :] - 2.0 * (qc @ yb.T)
        pad = -sc.shape[1] % _CHUNK
        if pad:
            sc = torch.nn.functional.pad(sc, (0, pad), value=BIG)
        c0 = s // _CHUNK
        out[:, c0:c0 + sc.shape[1] // _CHUNK] = torch.amin(
            sc.reshape(m, -1, _CHUNK), dim=2)
    return out


def _check_index(name, y, d):
    if y.dim() != 2 or y.shape[1] != d:
        raise ValueError(
            f"{name}: index must be (n, {d}), got {tuple(y.shape)}")
    if y.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"{name}: index must be float32 or bfloat16, got {y.dtype}")
    if not y.is_contiguous():
        raise ValueError(f"{name}: index must be contiguous (row-major)")


def _check_queries(name, q):
    if q.dim() != 2 or q.dtype != torch.float32:
        raise ValueError(
            f"{name}: queries must be a 2-D float32 tensor, got "
            f"{tuple(q.shape)} {q.dtype}")


def _check_devices(name, *ts):
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"{name}: operands on different devices {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def chunk_mins(q, y, ynorm, npad: int, compute_dtype=torch.float32):
    """(m, d) f32 queries x (n, d) f32 or bf16 index -> (m, npad/128) f32
    minima over 128-row chunks of ``ynorm[r] − 2·(q·y_r)``, rows
    ``r >= n`` scoring :data:`BIG`. ``ynorm`` (n,) f32 holds the index's
    squared row norms and ``npad`` (a multiple of 128, >= n) fixes the
    chunk count. ``compute_dtype=torch.bfloat16`` rounds both operands
    to bf16 first (f32 accumulation either way). CPU tensors run the
    plain version; CUDA tensors run the kernel."""
    _check_queries("chunk_mins", q)
    m, d = q.shape
    _check_index("chunk_mins", y, d)
    n = y.shape[0]
    cd = _compute_dtype(compute_dtype)
    if tuple(ynorm.shape) != (n,) or ynorm.dtype != torch.float32:
        raise ValueError(
            f"chunk_mins: ynorm must be ({n},) float32, got "
            f"{tuple(ynorm.shape)} {ynorm.dtype}")
    if npad % _CHUNK or npad < n or m < 1 or n < 1:
        raise ValueError(
            f"chunk_mins: need m, n >= 1 and npad a multiple of {_CHUNK} "
            f">= n (m={m}, n={n}, npad={npad})")
    dev = _check_devices("chunk_mins", q, y, ynorm)
    if dev.type == "cpu":
        return chunk_mins_plain(q, y, ynorm, npad, cd)
    n_chunks = npad // _CHUNK
    q = q.contiguous()
    ynorm = ynorm.contiguous()
    out = torch.empty((m, n_chunks), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.raft_fused_chunk_mins(
            q.data_ptr(), y.data_ptr(), ynorm.data_ptr(), out.data_ptr(),
            m, n, d, n_chunks, int(y.dtype == torch.bfloat16),
            int(cd == torch.bfloat16), stream)
    _raise_on(lib, err, "chunk_mins")
    LAUNCHES["chunk_mins"] += 1
    return out


# ---------------------------------------------------------------------------
# Phase 2: rescore of whole candidate chunks
# ---------------------------------------------------------------------------


@full_f32
def rescore_scores_plain(q, cids, y):
    """Plain PyTorch version of :func:`rescore_scores`: a gather of each
    candidate chunk's 128 rows and the same formula
    ``Σ y·(y − 2q)`` (y upcast to f32), blocked over queries. Rows outside
    the index score 0."""
    m, d = q.shape
    c = cids.shape[1]
    n = y.shape[0]
    out = torch.empty((m, c * _CHUNK), dtype=torch.float32, device=q.device)
    off = torch.arange(_CHUNK, device=q.device)
    bq = max(1, _PLAIN_TILE_ELEMS // (c * _CHUNK * max(d, 1)))
    for s in range(0, m, bq):
        cb = cids[s:s + bq].long()
        rows = (cb[:, :, None] * _CHUNK + off).reshape(cb.shape[0], -1)
        valid = (rows >= 0) & (rows < n)
        blk = y[rows.clamp(0, n - 1)].float()
        qb = q[s:s + bq].float()[:, None, :]
        sc = torch.sum(blk * (blk - 2.0 * qb), dim=2)
        out[s:s + bq] = torch.where(valid, sc, torch.zeros_like(sc))
    return out


def rescore_scores(q, cids, y):
    """(m, d) f32 queries, (m, c) int32 candidate chunk ids and the
    (n, d) f32 or bf16 index -> (m, c·128) f32 scores ``Σ y·(y − 2q)`` of
    the 128 rows of each candidate chunk (``‖y‖² − 2 q·y``; the caller
    adds ``‖q‖²`` and masks rows past ``n``, which score 0 here). q is
    never rounded. CPU tensors run the plain version; CUDA tensors run
    the kernel, which inverts the pair map on the card first (the
    (query, slot) pairs sorted by chunk) and then reads each chunk once
    for up to 32 of the queries that name it."""
    _check_queries("rescore_scores", q)
    m, d = q.shape
    _check_index("rescore_scores", y, d)
    if (cids.dim() != 2 or cids.shape[0] != m
            or cids.dtype != torch.int32 or cids.shape[1] < 1):
        raise ValueError(
            f"rescore_scores: cids must be ({m}, c) int32 with c >= 1, got "
            f"{tuple(cids.shape)} {cids.dtype}")
    dev = _check_devices("rescore_scores", q, cids, y)
    if dev.type == "cpu":
        return rescore_scores_plain(q, cids, y)
    c = cids.shape[1]
    n = y.shape[0]
    if m * c >= 2**31 or _cdiv(n, _CHUNK) >= 2**31 - 1:
        raise ValueError(
            f"rescore_scores: {m} x {c} pairs or {n} rows exceed the "
            "kernel's int32 indices")
    q = q.contiguous()
    cids = cids.contiguous()
    out = torch.empty((m, c * _CHUNK), dtype=torch.float32, device=dev)
    lib = _lib()
    plan = torch.empty(lib.raft_fused_rescore_plan_ints(m, n, c),
                       dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.raft_fused_rescore(
            q.data_ptr(), cids.data_ptr(), y.data_ptr(), out.data_ptr(),
            plan.data_ptr(), m, n, d, c, int(y.dtype == torch.bfloat16),
            stream)
    _raise_on(lib, err, "rescore_scores")
    LAUNCHES["rescore_scores"] += 1
    return out


# ---------------------------------------------------------------------------
# Launch limits and the probe
# ---------------------------------------------------------------------------


def _max_grid_steps() -> int:
    """The largest phase-1 grid (blocks) one fused call may launch: the
    1-D grid limit of a capability-9.0 card, or ``RAFT_TPU_MAX_GRID_STEPS``
    (read at call time; :func:`probe_grid_steps` checks a value on the
    card before a deployment relies on it)."""
    env = os.environ.get("RAFT_TPU_MAX_GRID_STEPS")
    if not env:
        return _MAX_GRID_STEPS_DEFAULT
    try:
        val = int(env)
    except ValueError:
        raise ValueError(
            f"RAFT_TPU_MAX_GRID_STEPS must be a positive integer, "
            f"got {env!r}"
        ) from None
    if val <= 0:
        raise ValueError(
            f"RAFT_TPU_MAX_GRID_STEPS must be positive, got {val}")
    return val


def probe_grid_steps(steps: int, device=None) -> bool:
    """Whether the card runs a ``steps``-block grid laid out as the
    phase-1 launch (1-D, 256-thread blocks), each block copying one
    (8, 128) f32 tile. False when the card refuses the configuration;
    raises without a CUDA device."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"probe_grid_steps: needs a CUDA device, got {dev}")
    src = torch.arange(8 * 128, dtype=torch.float32, device=dev).reshape(
        8, 128)
    dst = torch.zeros_like(src)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.raft_fused_probe_grid_steps(
            src.data_ptr(), dst.data_ptr(), int(steps), stream)
    if err == lib.raft_fused_invalid_configuration():
        return False
    _raise_on(lib, err, "probe_grid_steps")
    LAUNCHES["probe_grid_steps"] += 1
    if not torch.equal(dst, src):
        raise RuntimeError("probe_grid_steps: the copy kernel did not run")
    return True


def _plan_blocks(m: int, n: int, d: int, bm: int = 1024, bn: int = 2048):
    """The JAX package's phase-1 tile rule, kept because ``bn`` fixes
    ``npad = round_up(n, bn)`` and with it the chunk count (the CUDA
    kernel tiles itself)."""
    bn = min(bn, _round_up(n, _CHUNK))
    bm = min(bm, _round_up(m, 128))
    while bn > 256 and (bn * bm * 4 + 8 * d * (bn + bm)) > 12 * 2**20:
        bn //= 2
        if bm > 256:
            bm //= 2
    return bm, bn


def _grid_steps(m: int, npad: int) -> int:
    """Blocks of the phase-1 launch: one per (128-query tile, chunk)."""
    return _cdiv(m, _QTILE) * (npad // _CHUNK)


def fused_grid_ok(m: int, n: int, d: int, bm: int = 1024,
                  bn: int = 2048) -> bool:
    """Whether one fused call at this shape stays within the phase-1
    launch's grid limit (:func:`_max_grid_steps`); callers above it
    partition the index or take the scan path."""
    _, pbn = _plan_blocks(m, n, d, bm, bn)
    return _grid_steps(m, _round_up(n, pbn)) <= _max_grid_steps()


_L2_FAMILY = (
    DistanceType.L2Expanded,
    DistanceType.L2SqrtExpanded,
    DistanceType.L2Unexpanded,
)


def fused_knn_supported(metric: DistanceType, m: int, n: int, d: int,
                        k: int) -> bool:
    """Shapes and metrics the fused path serves: an L2-family metric,
    enough chunks for the exact cover, k <= 128 and d <= 4096 (the JAX
    package's rule)."""
    return (
        metric in _L2_FAMILY
        and n // _CHUNK >= max(k, 32)
        and k <= 128
        and d <= 4096
        and m >= 1
    )


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------


@full_f32
def _row_norms(y):
    """Squared row norms in f32, blocked over rows (no f32 copy of a
    bf16 index)."""
    n, d = y.shape
    rows = max(1, _PLAIN_TILE_ELEMS // max(d, 1))
    out = torch.empty(n, dtype=torch.float32, device=y.device)
    for s in range(0, n, rows):
        yb = y[s:s + rows].float()
        out[s:s + rows] = torch.sum(yb * yb, dim=1)
    return out


def _finish(vals, idxs, metric):
    vals = relu0(vals)
    if metric == DistanceType.L2SqrtExpanded:
        vals = sqrt_f64(vals)
    return vals, idxs.to(torch.int32)


@full_f32
def _fused_l2_knn_impl(queries, index, k: int, metric: DistanceType, *,
                       bm: int, bn: int, bq2: int, extra_chunks: int,
                       compute_dtype, gather_rows=None, index_norms=None,
                       grid_limit: int = _MAX_GRID_STEPS_DEFAULT
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    global RESCORE_GATHER_CALLS
    m, d = queries.shape
    n = index.shape[0]
    dev = queries.device
    q = queries.float().contiguous()
    y = index
    npad = _round_up(n, bn)
    yn = (index_norms.float() if index_norms is not None
          else _row_norms(y))

    cmins = chunk_mins(q, y, yn, npad, compute_dtype)     # (m, nC)

    # top-c chunks per query, c = k + extra_chunks (the margin covers
    # phase-1 rounding near the boundary), then an exact rescore
    n_c = npad // _CHUNK
    c = min(n_c, k + extra_chunks)
    cpad = _round_up(c, 8)
    off = torch.arange(_CHUNK, device=dev)
    qn = torch.sum(q * q, dim=-1)
    if gather_rows is None and cpad <= n_c and d % _CHUNK == 0:
        # the rescore kernel: each candidate chunk read in place
        _, cids = top_k_smallest(cmins, cpad)             # (m, cpad)
        cids32 = cids.to(torch.int32)
        # the kernel launches at most one block per (query, slot) pair
        blk = max(1, grid_limit // cpad)
        scores = torch.cat([
            rescore_scores(q[s:s + blk], cids32[s:s + blk], y)
            for s in range(0, m, blk)
        ])                                                # (m, cpad*128)
        d2 = qn[:, None] + scores
        col = (cids[:, :, None] * _CHUNK + off).reshape(m, cpad * _CHUNK)
        d2 = torch.where(col >= n, torch.full_like(d2, BIG), d2)
        vals, pos = top_k_smallest(d2, k)
        return _finish(vals, torch.gather(col, 1, pos), metric)

    # torch gather of the candidate rows: qn + yn - 2 dots over c chunks
    if dev.type == "cuda":
        RESCORE_GATHER_CALLS += 1
    _, cids = top_k_smallest(cmins, c)                    # (m, c)
    # bf16 compute with bf16 storage feeds the dot bf16 queries, as the
    # JAX package does to keep the gathered block in bf16
    bf16_mode = (_compute_dtype(compute_dtype) == torch.bfloat16
                 and y.dtype == torch.bfloat16)
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    vals_out, idx_out = [], []
    for s in range(0, m, bq2):
        cb = cids[s:s + bq2]
        b = cb.shape[0]
        rows = (cb[:, :, None] * _CHUNK + off).reshape(b, c * _CHUNK)
        valid = rows < n
        safe = rows.clamp(max=n - 1)
        yv = y[safe].float()                              # (b, c*128, d)
        ynv = torch.where(valid, yn[safe], big)
        qb = q[s:s + bq2]
        if bf16_mode:
            qb = qb.to(torch.bfloat16).float()
        dots = torch.bmm(yv, qb[:, :, None])[:, :, 0]
        dots = torch.where(valid, dots, torch.zeros_like(dots))
        d2 = qn[s:s + bq2, None] + ynv - 2.0 * dots
        v, pos = top_k_smallest(d2, k)
        which = torch.gather(cb, 1, pos // _CHUNK)
        vals_out.append(v)
        idx_out.append(which * _CHUNK + pos % _CHUNK)
    return _finish(torch.cat(vals_out), torch.cat(idx_out), metric)


def fused_l2_knn(queries, index, k: int, *,
                 metric=DistanceType.L2SqrtExpanded, bm: int = 1024,
                 bn: int = 2048, bq2: int = 40, extra_chunks: int = 8,
                 compute_dtype=torch.float32,
                 gather_rows: Optional[bool] = None,
                 init: Optional[Tuple] = None, index_norms=None,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact fused kNN for the L2 metric family. Returns (dists (m, k)
    f32, int32 indices (m, k)) best-first, as ``brute_force_knn``.

    ``compute_dtype=torch.bfloat16`` rounds the phase-1 operands to bf16
    (chunk ranking then carries bf16 error; pair it with a larger
    ``extra_chunks``, 32 in the benches); the rescore stays f32.
    ``init``: a previous top-k ``(dists, ids)`` to merge with (ids
    already global). ``index_norms``: precomputed f32 squared row norms
    (n,), which saves one read of the index per call. The index is read
    in its storage type (f32 or bf16; other float types are converted to
    f32). The call runs on ``device`` when given, else on the index's
    device if it is a tensor (then the queries'), else on CUDA (raising
    without it)."""
    metric = resolve_metric(metric)
    dev = call_device(index, queries, device=device)
    queries = as_tensor(queries, dev)
    index = as_tensor(index, dev)
    if index.dtype not in (torch.float32, torch.bfloat16):
        index = index.float()
    m, d = queries.shape
    n = index.shape[0]
    if not fused_knn_supported(metric, m, n, d, k):
        raise ValueError(
            f"fused kNN unsupported for metric={metric} m={m} n={n} d={d} "
            f"k={k}")
    bm, bn = _plan_blocks(m, n, d, bm, bn)
    steps = _grid_steps(m, _round_up(n, bn))
    limit = _max_grid_steps()
    if steps > limit:
        raise ValueError(
            f"fused kNN grid too large ({steps} blocks > {limit}): split "
            f"the index into partitions of <= "
            f"{limit // _cdiv(m, _QTILE) * _CHUNK} rows and use "
            "brute_force_knn(partitions, ...)")
    if index_norms is not None:
        index_norms = as_tensor(index_norms, dev)
        if index_norms.dim() != 1 or index_norms.shape[0] != n:
            raise ValueError(
                f"index_norms must have shape ({n},), got "
                f"{tuple(index_norms.shape)}")
    vals, idxs = _fused_l2_knn_impl(
        queries, index.contiguous(), k, metric, bm=bm, bn=bn, bq2=bq2,
        extra_chunks=extra_chunks, compute_dtype=compute_dtype,
        gather_rows=gather_rows, index_norms=index_norms, grid_limit=limit,
    )
    if init is not None:
        init_d, init_i = init
        vals, idxs = merge_topk(
            vals, idxs, as_tensor(init_d, dev).float(),
            as_tensor(init_i, dev).to(torch.int32), select_min=True)
    return vals, idxs


def _raise_on(lib, err: int, name: str) -> None:
    if err:
        raise RuntimeError(
            f"{name}: kernel launch failed: CUDA error {err} "
            f"({lib.raft_fused_error_string(err).decode()})")


def _lib():
    from raft_tpu_torch import _build

    lib = _build.load("fused_knn")
    if lib.raft_fused_chunk_mins.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.raft_fused_chunk_mins.argtypes = [p, p, p, p, i, ll, i, ll, i,
                                              i, p]
        lib.raft_fused_chunk_mins.restype = i
        lib.raft_fused_rescore.argtypes = [p, p, p, p, p, i, ll, i, i, i,
                                           p]
        lib.raft_fused_rescore.restype = i
        lib.raft_fused_rescore_group.argtypes = []
        lib.raft_fused_rescore_group.restype = i
        lib.raft_fused_rescore_plan_ints.argtypes = [i, ll, i]
        lib.raft_fused_rescore_plan_ints.restype = ll
        lib.raft_fused_probe_grid_steps.argtypes = [p, p, ll, p]
        lib.raft_fused_probe_grid_steps.restype = i
        lib.raft_fused_probe_empty.argtypes = [ll, p]
        lib.raft_fused_probe_empty.restype = i
        lib.raft_fused_invalid_configuration.argtypes = []
        lib.raft_fused_invalid_configuration.restype = i
        lib.raft_fused_max_grid_x.argtypes = []
        lib.raft_fused_max_grid_x.restype = ll
        lib.raft_fused_error_string.argtypes = [i]
        lib.raft_fused_error_string.restype = ctypes.c_char_p
    return lib
