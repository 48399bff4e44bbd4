"""Flat sub-chunk-min scan — the port of the TPU kernel
``flat_scan_subchunk_min`` (``raft_tpu/spatial/ann/flat_kernel.py:115``,
driven by ``scan_core.subchunk_scan``). The CUDA kernel is
``raft_tpu_torch/csrc/flat_scan.cu``; its source note says what bounds
it on the H100 and what the design does about it.

For each list block b, query slot q and 8-row sub-chunk j:
``out[b, q, j] = min over r in 8j..8j+7 of (‖q‖² + ‖y_r‖²) − 2 q·y_r``
with bf16 operands and f32 products, norms and sums; rows outside the
list's ``[lo, hi)`` range score :data:`BIG`. Only the (LB, Q, Lpad/8)
minima leave the kernel.

:func:`flat_scan_subchunk_min` is the wrapper: tensors on the CPU go to
:func:`flat_scan_subchunk_min_plain` (the counterpart of the JAX
``flat_scan_subchunk_min_lax`` mirror), tensors on a CUDA device go to
the kernel — or the wrapper raises. :data:`LAUNCHES` counts kernel
launches, so a run can show that it went through the kernel.
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
)

__all__ = [
    "BIG", "LAUNCHES", "SUBCHUNK", "flat_scan_subchunk_min",
    "flat_scan_subchunk_min_plain", "flat_scan_supported", "plan_l_tile",
]

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0


def _smem_bytes(d: int) -> int:
    # csrc/flat_scan.cu smem_bytes(): a 64 x (d + 1) query tile, a
    # d x 68 transposed slab tile, 64 query norms and 64 row norms, f32
    return 4 * (64 * (d + 1) + d * 68 + 64 + 64)


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
    """Whether the kernel engine applies: one block's shared-memory
    tiles fit at width ``d`` (the kernel tiles the query axis itself, so
    ``qcap`` only enters through the window rule, which must yield a
    plan for the grouped search to derive ``l_pad``)."""
    if d < 1 or _smem_bytes(d) > scan_core.SMEM_LIMIT:
        return False
    return plan_l_tile(
        d, pad_queries(qcap), profile=scan_core.tile_profile(qcap)
    ) is not None


@full_f32
def flat_scan_subchunk_min_plain(qrows, slabs_t, bounds):
    """Plain PyTorch version (the counterpart of
    ``flat_scan_subchunk_min_lax``): the same bf16 operands, f32 products
    and norms, masking and sub-chunk min, through a materialized
    (LB, Q, Lpad) distance tile."""
    d2 = scan_core.l2_gram_tile(qrows, slabs_t)
    return scan_core.mask_subchunk_min(d2, bounds)


def flat_scan_subchunk_min(qrows, slabs_t, bounds):
    """(LB, Q, d) bf16 query rows x (LB, d, Lpad) bf16 slab rows ->
    (LB, Q, Lpad/8) f32 sub-chunk minima of the squared L2 distance.

    ``bounds`` (LB, 2) int32 is each list's valid row range ``[lo, hi)``
    in its slab window. ``slabs_t`` may be a strided view (for example a
    gathered (LB, Lpad, d) slab ``.transpose(1, 2)``); Q is any positive
    count and Lpad any positive multiple of 8. CPU tensors run the plain
    version; CUDA tensors run the kernel."""
    scan_core.check_l2_operands("flat_scan_subchunk_min", qrows, slabs_t,
                                bounds, torch.bfloat16)
    dev = qrows.device
    if dev.type == "cpu":
        return flat_scan_subchunk_min_plain(qrows, slabs_t, bounds)
    if dev.type != "cuda":
        raise ValueError(
            f"flat_scan_subchunk_min: unsupported device {dev}"
        )
    lb, q, d = qrows.shape
    l_pad = slabs_t.shape[2]
    scan_core.check_launch("flat_scan_subchunk_min", _smem_bytes(d),
                           slabs_t, lb, q)
    qrows = qrows.contiguous()
    bounds = bounds.contiguous()
    out = torch.empty((lb, q, l_pad // SUBCHUNK), dtype=torch.float32,
                      device=dev)
    lib = _lib()
    sb, sd, sl = slabs_t.stride()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.raft_flat_scan_subchunk_min(
            qrows.data_ptr(), slabs_t.data_ptr(), bounds.data_ptr(),
            out.data_ptr(), lb, q, d, l_pad, sb, sd, sl, stream,
        )
    scan_core.raise_on_error(err, "flat_scan_subchunk_min", lib)
    global LAUNCHES
    LAUNCHES += 1
    return out


def _lib():
    from raft_tpu_torch import _build

    lib = _build.load("flat_scan")
    fn = lib.raft_flat_scan_subchunk_min
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, i, i, i, i, ll, ll, ll, p]
        fn.restype = ctypes.c_int
        lib.error_string = lib.raft_cuda_error_string
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        lib.raft_flat_scan_smem_bytes.argtypes = [ctypes.c_int]
        lib.raft_flat_scan_smem_bytes.restype = ctypes.c_longlong
    return lib
