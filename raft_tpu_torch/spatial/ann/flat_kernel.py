"""Flat sub-chunk-min scan — the port of the TPU kernel
``flat_scan_subchunk_min`` (``raft_tpu/spatial/ann/flat_kernel.py:115``,
driven by ``scan_core.subchunk_scan``). The CUDA kernel is
``raft_tpu_torch/csrc/flat_scan.cu`` (tensor cores); its source note says
what bounds it on the H100 and what the design does about it. It has two
forms, chosen by width alone (:func:`scan_form`): the resident form keeps
two stages of whole rows beside the query tile; rows too wide for that
(d = 960 at every query tile, d = 768 past 16 slots) take the wide form,
which streams rows in 256-feature slices beside a resident query tile
sized to fit.

For each list b, query slot q and 8-row sub-chunk j:
``out[b, q, j] = min over r in 8j..8j+7 of (‖q‖² + ‖y_r‖²) − 2 q·y_r``
with bf16 operands and f32 products, norms and sums; rows outside the
list's ``[lo, hi)`` range score :data:`BIG`. Only the (lists, Q, Lpad/8)
minima leave the kernel.

Two entries launch the one kernel (which, with its int8 row loader, is
also the IVF-SQ scan of :mod:`.sq_kernel`):

* :func:`flat_scan_lists` — the grouped search's form: one launch per
  batch, query rows read by id through the (lists, Q) slot map, slab
  rows read in place from the index's rows by window origin; dead slots
  (the sentinel id) and lists without a live slot score BIG.
* :func:`flat_scan_subchunk_min` — the gathered form of the JAX kernel,
  (LB, Q, d) query rows x an (LB, d, Lpad) slab: list b's window starts
  at row b·Lpad of the slab and every slot is live.

Tensors on the CPU go to the plain versions
(:func:`flat_scan_lists_plain`, :func:`flat_scan_subchunk_min_plain`,
the counterpart of the JAX ``flat_scan_subchunk_min_lax`` mirror),
tensors on a CUDA device go to the kernel — or the wrapper raises.
:data:`LAUNCHES` counts kernel launches of both entries, so a run can
show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from raft_tpu_torch.core.device import full_f32
from raft_tpu_torch.spatial.ann import scan_core
from raft_tpu_torch.spatial.ann.scan_core import (
    BIG as BIG,  # re-export: callers read the masked-row constant here
    SUBCHUNK,
    pad_queries,
    round_up,
)

__all__ = [
    "BIG", "LAUNCHES", "SUBCHUNK", "flat_scan_lists", "flat_scan_lists_plain",
    "flat_scan_subchunk_min", "flat_scan_subchunk_min_plain",
    "flat_scan_supported", "plan_l_tile", "scan_form", "window_l_pad",
]

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0

_MAX_Q_TILE = 64         # csrc/flat_scan.cu: 8 n-tiles of 8 query slots
_GROUP_SUBS = 64         # sub-chunks per block (512 rows)
_TILE_ROWS = 64          # rows per pipeline stage
_SLICE_K = 256           # the wide form's features per stage
_STAGES = 2              # the wide form's stages (double-buffered)


def _q_tile_capped(q: int, cap: int) -> int:
    """csrc/flat_scan.cu q_tile_capped(): the query slots of a block for
    Q slots at most ``cap`` a block, round_up(ceil(Q / tiles), 8) over
    the fewest tiles; 0 when ``cap`` is under 8."""
    if q < 1 or cap < 8:
        return 0
    tiles = -(-q // cap)
    return round_up(-(-q // tiles), 8)


def _q_tile(q: int) -> int:
    """csrc/flat_scan.cu raft_flat_scan_q_tile(): the resident form's
    query slots of a block, tiles of at most 64."""
    return _q_tile_capped(q, _MAX_Q_TILE)


def _lists_smem_bytes(d: int, q_tile: int) -> int:
    # csrc/flat_scan.cu smem_bytes(): the query tile and two row stages
    # (bf16 rows padded to round_up(d, 16) + 8 elements), the block's
    # minima, the query and row norms and the slot ids
    stride = round_up(d, 16) + 8
    return (2 * stride * (q_tile + 2 * _TILE_ROWS)
            + 4 * (q_tile * _GROUP_SUBS + q_tile + _TILE_ROWS + q_tile))


def _wide_smem_bytes(d: int, q_tile: int) -> int:
    # csrc/flat_scan.cu wide_smem_bytes(): the query tile (as the resident
    # form's) and two 64-row stages of 256-feature slices padded to 264,
    # then the block's minima, the query norms and the slot ids
    return (2 * (round_up(d, 16) + 8) * q_tile
            + 2 * _STAGES * _TILE_ROWS * (_SLICE_K + 8)
            + 4 * (q_tile * _GROUP_SUBS + 2 * q_tile))


def _wide_q_cap(d: int) -> int:
    """csrc/flat_scan.cu wide_q_cap(): the wide form's most query slots a
    block at width ``d`` (a multiple of 8 up to 64 whose block fits), 0
    when not even 8 fit."""
    cap = _MAX_Q_TILE
    while cap > 0 and _wide_smem_bytes(d, cap) > scan_core.SMEM_LIMIT:
        cap -= 8
    return cap


def scan_form(d: int, q: int):
    """csrc/flat_scan.cu flat_wide(): ``(wide, q_tile, smem)`` of a flat
    scan at width ``d`` over ``q`` query slots — the resident form
    wherever its two whole-row stages fit beside the query tile, else
    the wide form with its query tile sized to fit (``q_tile`` 0 when
    no tile does)."""
    q_tile = _q_tile(q)
    smem = _lists_smem_bytes(d, q_tile)
    if smem <= scan_core.SMEM_LIMIT:
        return False, q_tile, smem
    q_tile = _q_tile_capped(q, _wide_q_cap(d))
    return True, q_tile, _wide_smem_bytes(d, q_tile)


def _sq_lists_smem_bytes(d: int, q_tile: int) -> int:
    # csrc/flat_scan.cu sq_smem_bytes(): the flat layout, then vmin and
    # vscale (f32) and two raw int8 row stages, each 16-byte aligned
    return (_lists_smem_bytes(d, q_tile) + round_up(8 * d, 16)
            + 2 * _TILE_ROWS * round_up(d, 16))


def _step_bytes(d: int, q_pad: int, l_tile: int) -> int:
    # the JAX engine's window byte model (raft_tpu flat_kernel._step_bytes)
    return 2 * 2 * d * l_tile + 2 * 2 * q_pad * d + 4 * q_pad * l_tile


def plan_l_tile(d: int, q_pad: int, l_tile=None, profile="throughput"):
    """The flat engine's window tile under the shared JAX window rule
    (:func:`scan_core.plan_l_tile`); it fixes ``l_pad``, not the kernel's
    block tiling."""
    return scan_core.plan_l_tile(
        functools.partial(_step_bytes, d), q_pad, l_tile, profile
    )


def flat_scan_supported(d: int, qcap: int) -> bool:
    """Whether the kernel engine applies: one block of the form the
    kernel takes at width ``d`` over ``qcap`` slots (:func:`scan_form`)
    fits a block's shared memory. The window needs no plan of the JAX
    rule (:func:`window_l_pad`)."""
    if d < 1:
        return False
    _, q_tile, smem = scan_form(d, max(qcap, 1))
    return q_tile >= 1 and smem <= scan_core.SMEM_LIMIT


def window_l_pad(d: int, qcap: int, max_list: int, plan=None) -> int:
    """The kernel engine's window length ``l_pad``: ``max_list`` rounded
    up to the JAX window rule's tile (``plan``: :func:`plan_l_tile`, or
    the SQ scan's) at ``qcap``, or to the kernel's 64-row stage where
    that rule has no plan — its byte model holds the whole ``qcap`` x
    ``d`` query block in one TPU window, which bounds the TPU kernel and
    not this one."""
    l_tile = (plan or plan_l_tile)(
        d, pad_queries(qcap),
        l_tile=round_up(max_list, scan_core.LANE),
        profile=scan_core.tile_profile(qcap),
    )
    return round_up(max_list, l_tile or _TILE_ROWS)


@full_f32
def flat_scan_subchunk_min_plain(qrows, slabs_t, bounds):
    """Plain PyTorch version (the counterpart of
    ``flat_scan_subchunk_min_lax``): the same bf16 operands, f32 products
    and norms, masking and sub-chunk min, through a materialized
    (LB, Q, Lpad) distance tile."""
    d2 = scan_core.l2_gram_tile(qrows, slabs_t)
    return scan_core.mask_subchunk_min(d2, bounds)


def flat_scan_lists_plain(queries, qmat, rows, origins, bounds, l_pad: int):
    """Plain PyTorch version of :func:`flat_scan_lists`: the gathered
    form (:func:`flat_scan_subchunk_min_plain`) of every list with a live
    slot, on ``queries[qmat[b]]`` and the window
    ``rows[origins[b] : origins[b] + l_pad]``. As in the kernel, a dead
    slot (an id outside ``[0, n − 1)``: the sentinel, the last row of
    ``queries``) scores :data:`BIG`, and a list with no live slot is not
    scanned at all — its minima are all BIG."""
    return _lists_plain(queries, qmat, rows, origins, bounds, l_pad,
                        queries.shape[0] - 1, flat_scan_subchunk_min_plain)


def _lists_plain(queries, qmat, rows, origins, bounds, l_pad, n_ids, scan):
    """The gathered form of a list scan: ``scan(query rows, slabs_t,
    bounds)`` over the lists with a live slot, BIG elsewhere."""
    n_lists, q = qmat.shape
    live = (qmat >= 0) & (qmat < n_ids)
    out = torch.full((n_lists, q, l_pad // SUBCHUNK), BIG,
                     dtype=torch.float32, device=queries.device)
    scanned = torch.nonzero(live.any(1)).squeeze(1)
    if scanned.numel():
        lv = live[scanned]
        qv = queries[torch.where(lv, qmat[scanned], 0).long()]
        win = (origins[scanned].long()[:, None]
               + torch.arange(l_pad, device=rows.device))
        got = scan(qv, rows[win].transpose(1, 2), bounds[scanned])
        out[scanned] = torch.where(lv[:, :, None], got, BIG)
    return out


def _check_lists(name, queries, qmat, rows, origins, bounds, l_pad,
                 row_dtype=torch.bfloat16):
    if queries.dim() != 2 or rows.dim() != 2 or qmat.dim() != 2:
        raise ValueError(
            f"{name}: expected queries (n, d), rows (R, d) and qmat "
            f"(lists, Q), got {tuple(queries.shape)}, {tuple(rows.shape)} "
            f"and {tuple(qmat.shape)}"
        )
    if queries.shape[1] != rows.shape[1]:
        raise ValueError(
            f"{name}: query dim {queries.shape[1]} does not match row dim "
            f"{rows.shape[1]}"
        )
    if queries.dtype != torch.bfloat16 or rows.dtype != row_dtype:
        raise ValueError(
            f"{name}: queries must be bfloat16 and rows {row_dtype}, got "
            f"{queries.dtype} and {rows.dtype}"
        )
    n_lists = qmat.shape[0]
    if (qmat.dtype != torch.int32 or origins.dtype != torch.int32
            or tuple(origins.shape) != (n_lists,)):
        raise ValueError(
            f"{name}: qmat and origins must be int32 of shapes (lists, Q) "
            f"and (lists,), got {qmat.dtype} {tuple(qmat.shape)} and "
            f"{origins.dtype} {tuple(origins.shape)}"
        )
    scan_core.check_bounds(name, bounds, n_lists)
    scan_core.validate_scan_shapes(name, l_pad)
    if rows.shape[0] < l_pad:
        raise ValueError(
            f"{name}: {rows.shape[0]} rows cannot hold a window of {l_pad}")
    scan_core.check_same_device(name, queries, qmat, rows, origins, bounds)


def flat_scan_lists(queries, qmat, rows, origins, bounds, l_pad: int):
    """One launch over every list of a grouped-search batch -> (lists,
    Q, l_pad/8) f32 sub-chunk minima.

    ``queries`` (nq + 1, d) bf16 holds the batch's query rows with the
    sentinel (zero) row last; ``qmat`` (lists, Q) int32 names each slot's
    query row, the sentinel id ``nq`` marking a dead slot (it scores
    BIG). ``rows`` (R, d) bf16 contiguous are the index's rows, read in
    place: list b's window is rows ``origins[b] .. origins[b] + l_pad −
    1`` (the caller keeps every window inside ``rows``), and ``bounds``
    (lists, 2) int32 its valid ``[lo, hi)`` relative to that origin. On
    live slots the result equals :func:`flat_scan_subchunk_min` on the
    gathered slabs. CPU tensors run the plain version; CUDA tensors run
    the kernel."""
    name = "flat_scan_lists"
    _check_lists(name, queries, qmat, rows, origins, bounds, l_pad)
    if queries.device.type == "cpu":
        return flat_scan_lists_plain(queries, qmat, rows, origins, bounds,
                                     l_pad)
    out = _launch(name, queries, qmat, rows, origins, bounds, l_pad,
                  queries.shape[0] - 1)
    global LAUNCHES
    LAUNCHES += 1
    return out


def flat_scan_subchunk_min(qrows, slabs_t, bounds):
    """(LB, Q, d) bf16 query rows x (LB, d, Lpad) bf16 slab rows ->
    (LB, Q, Lpad/8) f32 sub-chunk minima of the squared L2 distance.

    ``bounds`` (LB, 2) int32 is each list's valid row range ``[lo, hi)``
    in its slab window. ``slabs_t`` may be a strided view (for example a
    gathered (LB, Lpad, d) slab ``.transpose(1, 2)``, which the kernel
    reads without a copy; other layouts are made row-major first); Q is
    any positive count and Lpad any positive multiple of 8. CPU tensors
    run the plain version; CUDA tensors run the kernel of
    :func:`flat_scan_lists` with list b's window at row b·Lpad and every
    slot live."""
    name = "flat_scan_subchunk_min"
    scan_core.check_l2_operands(name, qrows, slabs_t, bounds, torch.bfloat16)
    dev = qrows.device
    if dev.type == "cpu":
        return flat_scan_subchunk_min_plain(qrows, slabs_t, bounds)
    lb, q, d = qrows.shape
    l_pad = slabs_t.shape[2]
    rows = slabs_t.transpose(1, 2).contiguous().reshape(lb * l_pad, d)
    i32 = torch.int32
    qmat = torch.arange(lb * q, dtype=i32, device=dev).reshape(lb, q)
    origins = torch.arange(0, lb * l_pad, l_pad, dtype=i32, device=dev)
    out = _launch(name, qrows.reshape(lb * q, d), qmat, rows, origins,
                  bounds, l_pad, lb * q)
    global LAUNCHES
    LAUNCHES += 1
    return out


def _launch(name, queries, qmat, rows, origins, bounds, l_pad, n_ids,
            params=None):
    """Launch the list kernel (the caller counts the launch): bf16
    ``rows``, or with ``params`` ((2, d) f32, vmin then vscale) the
    IVF-SQ loader over int8 code rows."""
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not rows.is_contiguous():
        raise ValueError(f"{name}: rows must be contiguous (row-major)")
    n_lists, q = qmat.shape
    d = rows.shape[1]
    if params is None:
        _, q_tile, smem = scan_form(d, q)
        if q_tile < 1:
            raise ValueError(
                f"{name}: rows of width {d} leave no room for a query tile "
                "in a block's shared memory")
    else:
        q_tile = _q_tile(q)
        smem = _sq_lists_smem_bytes(d, q_tile)
    scan_core.check_launch(name, smem, rows, n_lists, q, q_tile=q_tile)
    queries = queries.contiguous()
    qmat = qmat.contiguous()
    origins = origins.contiguous()
    bounds = bounds.contiguous()
    out = torch.empty((n_lists, q, l_pad // SUBCHUNK), dtype=torch.float32,
                      device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = (queries.data_ptr(), qmat.data_ptr(), rows.data_ptr(),
                origins.data_ptr(), bounds.data_ptr())
        if params is None:
            err = lib.raft_flat_scan_lists(*ptrs, out.data_ptr(), n_lists,
                                           q, n_ids, d, l_pad, stream)
        else:
            params = params.contiguous()
            err = lib.raft_sq_scan_lists(*ptrs, params.data_ptr(),
                                         out.data_ptr(), n_lists, q, n_ids,
                                         d, l_pad, stream)
    scan_core.raise_on_error(err, name, lib)
    return out


def _lib():
    from raft_tpu_torch import _build

    lib = _build.load("flat_scan")
    fn = lib.raft_flat_scan_lists
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = i
        lib.error_string = lib.raft_cuda_error_string
        lib.error_string.argtypes = [i]
        lib.error_string.restype = ctypes.c_char_p
        lib.raft_flat_scan_smem_bytes.argtypes = [i, i]
        lib.raft_flat_scan_smem_bytes.restype = ctypes.c_longlong
        lib.raft_flat_scan_q_tile.argtypes = [i]
        lib.raft_flat_scan_q_tile.restype = i
        lib.raft_flat_scan_form.argtypes = [i, i, p, p]
        lib.raft_flat_scan_form.restype = i
        lib.raft_sq_scan_lists.argtypes = [p, p, p, p, p, p, p, i, i, i, i,
                                           i, p]
        lib.raft_sq_scan_lists.restype = i
        lib.raft_sq_scan_smem_bytes.argtypes = [i, i]
        lib.raft_sq_scan_smem_bytes.restype = ctypes.c_longlong
    return lib
