"""Beam-search candidate scan — the port of the TPU kernel
``beam_scan_subchunk_min`` (``raft_tpu/spatial/ann/graph_kernel.py:88``,
driven by ``scan_core.subchunk_scan``). The CUDA kernel is
``raft_tpu_torch/csrc/beam_scan.cu``; its source note says what bounds
it on the H100 and what the design does about it.

For each query b and 8-row sub-chunk j of its Cpad candidate ids:
``out[b, j] = min over r in 8j..8j+7 of (‖q_b‖² + ‖y_r‖²) − 2 q_b·y_r``
with ``y_r = table[ids[b, r]]``, bf16-rounded operands and f32 products,
norms and sums; candidates outside the query's ``[lo, hi)`` range score
:data:`BIG`. Only the (NQ, Cpad/8) minima leave the kernel.

The JAX kernel takes one live query row padded to 16 sublanes and the
candidate rows already gathered and transposed, ``(NQ, d, Cpad)``. The
port reads the ids and gathers the rows inside the kernel, so no
gathered copy of the candidates is made, and computes slot 0 only: its
output is the JAX output's ``[:, 0]``.

:func:`beam_scan_subchunk_min` is the wrapper: tensors on the CPU go to
:func:`beam_scan_subchunk_min_plain` (the counterpart of the JAX
``beam_scan_subchunk_min_lax`` mirror), tensors on a CUDA device go to
the kernel — or the wrapper raises. :data:`LAUNCHES` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from raft_tpu_torch.core.device import full_f32
from raft_tpu_torch.spatial.ann import scan_core
from raft_tpu_torch.spatial.ann.scan_core import (
    BIG as BIG,  # re-export: callers read the masked-row constant here
    SUBCHUNK,
)

__all__ = [
    "BIG", "LAUNCHES", "SUBCHUNK", "beam_scan_subchunk_min",
    "beam_scan_subchunk_min_plain", "beam_scan_supported",
    "rows_per_block",
]

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0

_MAX_ROWS = 128


def _smem_bytes(d: int, rows: int) -> int:
    # csrc/beam_scan.cu beam_smem_bytes(): the query row, rows x (d + 1)
    # staged candidate rows and one value per row, f32
    return 4 * (d + rows * (d + 1) + rows)


def rows_per_block(d: int) -> int:
    """Candidate rows (one thread each) per block of the kernel at width
    ``d``: the largest of 128, 64, 32 whose shared memory fits a block
    beside the kernel's static id array; 0 when none does."""
    rows = _MAX_ROWS
    while rows >= 32:
        if _smem_bytes(d, rows) + 4 * _MAX_ROWS <= scan_core.SMEM_LIMIT:
            return rows
        rows //= 2
    return 0


def beam_scan_supported(d: int, c_pad: int) -> bool:
    """Whether the kernel engine applies at this config: ``c_pad`` on the
    128-candidate granule the beam search pads to (the JAX rule) and a
    block's staged rows fit shared memory at width ``d``."""
    if d < 1 or c_pad < 1 or c_pad % scan_core.LANE:
        return False
    return rows_per_block(d) > 0


def _check(q, table, cand_ids, bounds):
    name = "beam_scan_subchunk_min"
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


def beam_scan_subchunk_min(q, table, cand_ids, bounds):
    """(NQ, d) f32 queries x (NQ, Cpad) int32 ids into an (rows, d) f32
    ``table`` -> (NQ, Cpad/8) f32 sub-chunk minima of the squared L2
    distance (bf16 operands, f32 sums).

    ``bounds`` (NQ, 2) int32 is each query's valid candidate range
    ``[lo, hi)``; Cpad is any positive multiple of 8 and every id must
    lie in ``[0, rows)``. CPU tensors run the plain version; CUDA tensors
    run the kernel."""
    _check(q, table, cand_ids, bounds)
    dev = q.device
    if dev.type == "cpu":
        return beam_scan_subchunk_min_plain(q, table, cand_ids, bounds)
    if dev.type != "cuda":
        raise ValueError(f"beam_scan_subchunk_min: unsupported device {dev}")
    nq, d = q.shape
    c_pad = cand_ids.shape[1]
    rows = rows_per_block(d)
    if rows == 0 or -(-c_pad // rows) > 65535:
        raise ValueError(
            f"beam_scan_subchunk_min: d={d} Cpad={c_pad} is past the "
            "kernel's shared memory or grid limits")
    q, table = q.contiguous(), table.contiguous()
    cand_ids, bounds = cand_ids.contiguous(), bounds.contiguous()
    out = torch.empty((nq, c_pad // SUBCHUNK), dtype=torch.float32,
                      device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.raft_beam_scan_subchunk_min(
            q.data_ptr(), table.data_ptr(), cand_ids.data_ptr(),
            bounds.data_ptr(), out.data_ptr(), nq, table.shape[0], d, c_pad,
            stream,
        )
    scan_core.raise_on_error(err, "beam_scan_subchunk_min", lib)
    global LAUNCHES
    LAUNCHES += 1
    return out


def _lib():
    from raft_tpu_torch import _build

    lib = _build.load("beam_scan")
    fn = lib.raft_beam_scan_subchunk_min
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.error_string = lib.raft_cuda_error_string
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        lib.raft_beam_scan_rows_per_block.argtypes = [ctypes.c_int]
        lib.raft_beam_scan_rows_per_block.restype = ctypes.c_int
        lib.raft_beam_scan_smem_bytes.argtypes = [ctypes.c_int]
        lib.raft_beam_scan_smem_bytes.restype = ctypes.c_longlong
    return lib
