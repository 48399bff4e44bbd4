"""Beam-search candidate scan — the port of the TPU kernel
``beam_scan_subchunk_min`` (``raft_tpu/spatial/ann/graph_kernel.py:88``,
driven by ``scan_core.subchunk_scan``). The CUDA kernel is
``raft_tpu_torch/csrc/beam_scan.cu``; its source note says what bounds
it on the H100 and what the design does about it.

For each query b and 8-row sub-chunk j of its Cpad candidate ids:
``mins[b, j] = min over r in 8j..8j+7 of (‖q_b‖² + ‖y_r‖²) − 2 q_b·y_r``
with ``y_r = table[ids[b, r]]``, bf16-rounded operands and f32 products,
norms and sums; candidates outside the query's ``[lo, hi)`` range score
:data:`BIG`.

The JAX kernel takes one live query row padded to 16 sublanes and the
candidate rows already gathered and transposed, ``(NQ, d, Cpad)``. The
port reads the ids and gathers the rows inside the kernel, so no
gathered copy of the candidates is made, and computes slot 0 only: its
minima are the JAX output's ``[:, 0]``. From the same read of each row
:func:`beam_scan_score` also returns the exact f32 distance of every
candidate (``score_l2_candidates`` of the gathered rows, +inf at ids
``>= n``), which the beam search's pool merge keeps, so the walk reads
no candidate row twice.

:func:`beam_scan_score` and :func:`beam_scan_subchunk_min` (the minima
alone) are the wrappers: tensors on the CPU go to the plain versions
(:func:`beam_scan_subchunk_min_plain`, the counterpart of the JAX
``beam_scan_subchunk_min_lax`` mirror, and
:func:`beam_scan_score_plain`), tensors on a CUDA device go to the
kernel — or the wrapper raises. :data:`LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from raft_tpu_torch.core.device import full_f32
from raft_tpu_torch.spatial.ann import scan_core
from raft_tpu_torch.spatial.ann.common import score_l2_candidates
from raft_tpu_torch.spatial.ann.scan_core import (
    BIG as BIG,  # re-export: callers read the masked-row constant here
    SUBCHUNK,
)

__all__ = [
    "BIG", "LAUNCHES", "SUBCHUNK", "beam_scan_score", "beam_scan_score_plain",
    "beam_scan_subchunk_min", "beam_scan_subchunk_min_plain",
    "beam_scan_supported", "rows_per_block",
]

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0

_MAX_ROWS, _MIN_ROWS = 128, 16

# The widest d the kernel engine takes: where the first beam kernel's
# 32-row tile of (d + 1)-float rows fit a block. Tiles of 16 rows fit up
# to d ~3,200, but routing stays where it was.
_MAX_ROUTED_D = 1755


def _stride(d: int) -> int:
    # csrc/beam_scan.cu beam_stride(): d in 16-byte units, an odd count
    s = scan_core.round_up(d, 4)
    return s if (s // 4) % 2 else s + 4


def _smem_bytes(d: int, rows: int) -> int:
    # csrc/beam_scan.cu beam_smem_bytes(): the query row unrounded and
    # rounded, rows x stride staged rows, one value per row, f32
    s = _stride(d)
    return 4 * (2 * s + rows * s + rows)


def rows_per_block(d: int) -> int:
    """Candidate rows (one thread each) of the kernel's widest tile at
    width ``d``: the largest of 128, 64, 32, 16 whose shared memory fits
    a block beside the kernel's static id array; 0 when none does (a
    launch with few queries takes narrower tiles, down to 32 rows)."""
    rows = _MAX_ROWS
    while rows >= _MIN_ROWS:
        if _smem_bytes(d, rows) + 4 * _MAX_ROWS <= scan_core.SMEM_LIMIT:
            return rows
        rows //= 2
    return 0


def beam_scan_supported(d: int, c_pad: int) -> bool:
    """Whether the kernel engine applies at this config: ``c_pad`` on the
    128-candidate granule the beam search pads to (the JAX rule) and a
    block's staged rows fit shared memory at width ``d``, up to the
    widest width routed to the kernel (1,755)."""
    if d < 1 or d > _MAX_ROUTED_D or c_pad < 1 or c_pad % scan_core.LANE:
        return False
    return rows_per_block(d) > 0


def _check(name, q, table, cand_ids, bounds):
    if q.dim() != 2 or table.dim() != 2 or cand_ids.dim() != 2:
        raise ValueError(
            f"{name}: expected q (NQ, d), table (rows, d) and cand_ids "
            f"(NQ, Cpad), got {tuple(q.shape)}, {tuple(table.shape)} and "
            f"{tuple(cand_ids.shape)}")
    nq, d = q.shape
    if table.shape[1] != d or cand_ids.shape[0] != nq:
        raise ValueError(
            f"{name}: query dim {d} / queries {nq} do not match table "
            f"{tuple(table.shape)} and cand_ids {tuple(cand_ids.shape)}")
    if (q.dtype != torch.float32 or table.dtype != torch.float32
            or cand_ids.dtype != torch.int32):
        raise ValueError(
            f"{name}: q and table must be float32 and cand_ids int32, got "
            f"{q.dtype}, {table.dtype} and {cand_ids.dtype}")
    scan_core.check_bounds(name, bounds, nq)
    scan_core.validate_scan_shapes(name, cand_ids.shape[1])
    scan_core.check_same_device(name, q, table, cand_ids, bounds)


@full_f32
def beam_scan_subchunk_min_plain(q, table, cand_ids, bounds):
    """Plain PyTorch version (the counterpart of
    ``beam_scan_subchunk_min_lax``, slot 0): gathers the candidate rows,
    then the shared bf16 distance body and the masked sub-chunk min
    through a materialized (NQ, Cpad) distance row."""
    rows = table[cand_ids.long()]                        # (NQ, Cpad, d)
    d2 = scan_core.l2_gram_tile(q[:, None, :], rows.transpose(1, 2))
    return scan_core.mask_subchunk_min(d2, bounds)[:, 0]


@full_f32
def beam_scan_score_plain(q, table, cand_ids, bounds, n: int):
    """Plain PyTorch version of :func:`beam_scan_score`: the minima of
    :func:`beam_scan_subchunk_min_plain`, and the exact distances of
    ``score_l2_candidates`` on the gathered f32 rows, +inf at ids
    ``>= n``."""
    mins = beam_scan_subchunk_min_plain(q, table, cand_ids, bounds)
    exact = score_l2_candidates(q, table[cand_ids.long()].float(),
                                cand_ids < n)
    return mins, exact


def beam_scan_subchunk_min(q, table, cand_ids, bounds):
    """(NQ, d) f32 queries x (NQ, Cpad) int32 ids into an (rows, d) f32
    ``table`` -> (NQ, Cpad/8) f32 sub-chunk minima of the squared L2
    distance (bf16 operands, f32 sums).

    ``bounds`` (NQ, 2) int32 is each query's valid candidate range
    ``[lo, hi)``; Cpad is any positive multiple of 8 and every id must
    lie in ``[0, rows)``. CPU tensors run the plain version; CUDA tensors
    run the kernel, its exact output switched off."""
    name = "beam_scan_subchunk_min"
    _check(name, q, table, cand_ids, bounds)
    if q.device.type == "cpu":
        return beam_scan_subchunk_min_plain(q, table, cand_ids, bounds)
    return _launch(name, q, table, cand_ids, bounds, table.shape[0],
                   exact=False)[0]


def beam_scan_score(q, table, cand_ids, bounds, n: int):
    """:func:`beam_scan_subchunk_min`'s minima and, from the same read of
    each candidate row, its exact squared L2 distance: ``(mins (NQ,
    Cpad/8), exact (NQ, Cpad))`` f32, ``exact`` the unrounded f32 query
    and row (the ``(‖q‖² + ‖y‖²) − 2 q·y`` of ``score_l2_candidates``)
    and +inf where the id is ``n`` or more (``n <= rows``: the sentinel
    row and past it). CPU tensors run the plain version; CUDA tensors run
    the kernel."""
    name = "beam_scan_score"
    _check(name, q, table, cand_ids, bounds)
    n = int(n)
    if not 0 <= n <= table.shape[0]:
        raise ValueError(
            f"{name}: n={n} must lie in [0, {table.shape[0]}] (the table's "
            "rows)")
    if q.device.type == "cpu":
        return beam_scan_score_plain(q, table, cand_ids, bounds, n)
    return _launch(name, q, table, cand_ids, bounds, n, exact=True)


def _launch(name, q, table, cand_ids, bounds, n: int, exact: bool):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    nq, d = q.shape
    c_pad = cand_ids.shape[1]
    rows = rows_per_block(d)
    if rows == 0 or -(-c_pad // min(rows, 32)) > 65535:
        raise ValueError(
            f"{name}: d={d} Cpad={c_pad} is past the kernel's shared memory "
            "or grid limits")
    q, table = q.contiguous(), table.contiguous()
    cand_ids, bounds = cand_ids.contiguous(), bounds.contiguous()
    mins = torch.empty((nq, c_pad // SUBCHUNK), dtype=torch.float32,
                       device=dev)
    ex = (torch.empty((nq, c_pad), dtype=torch.float32, device=dev)
          if exact else None)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.raft_beam_scan(
            q.data_ptr(), table.data_ptr(), cand_ids.data_ptr(),
            bounds.data_ptr(), mins.data_ptr(),
            ex.data_ptr() if exact else None, nq, table.shape[0], n, d,
            c_pad, stream,
        )
    scan_core.raise_on_error(err, name, lib)
    global LAUNCHES
    LAUNCHES += 1
    return mins, ex


def _lib():
    from raft_tpu_torch import _build

    lib = _build.load("beam_scan")
    fn = lib.raft_beam_scan
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.error_string = lib.raft_cuda_error_string
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        lib.raft_beam_scan_rows_per_block.argtypes = [ctypes.c_int]
        lib.raft_beam_scan_rows_per_block.restype = ctypes.c_int
        lib.raft_beam_scan_smem_bytes.argtypes = [ctypes.c_int]
        lib.raft_beam_scan_smem_bytes.restype = ctypes.c_longlong
    return lib
