"""Shared scan core of the port — the counterpart of
``raft_tpu/spatial/ann/scan_core.py``: the shape rules every sub-chunk
scan engine shares, and the plain PyTorch pieces of the fused
distance + 8-row sub-chunk-min recipe.

What carries over unchanged, because it fixes results:

* :data:`SUBCHUNK` (8 rows per selection granule) and :data:`BIG` (the
  finite score of a masked row, never +inf) fix the candidate pool's
  width and the cover argument (every rank-c row lives in a sub-chunk
  whose minimum is <= the c-th best scanned value).
* :func:`plan_l_tile` keeps the JAX window rule — the profile start
  (512 rows, or 1024 at qcap <= 8), lane rounding, the halving under the
  rule's byte budget, the cap at the list's own lane-rounded height. The
  tile it returns fixes ``l_pad`` = max_list rounded up to the tile, and
  ``l_pad`` fixes the sub-chunk windows and the pool clamp of the grouped
  search, so equal plans give equal un-saturated results in both
  packages. :data:`WINDOW_BUDGET` is that rule's constant (the JAX
  package's per-step VMEM budget); it is not a limit of any CUDA device.

What does not: the CUDA kernels' own block tiling is internal to
``csrc/`` (``scan_core.cuh`` holds the constants and the sub-chunk min;
``flat_scan.cu``, with its int8 row loader for IVF-SQ, and ``pq_scan.cu``
scan whole batches of lists in place) and independent of the window
tile, and the kernels take any query count (no 16-row query granule).

The plain pieces fix one summation order, the kernels' own: every sum
over the feature axis (or over PQ subspaces) runs in ascending order,
one rounded f32 add per term, so a kernel and its plain version agree
bitwise on any input.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = [
    "BIG", "LANE", "Q_GRANULE", "SMEM_LIMIT", "SUBCHUNK", "WINDOW_BUDGET",
    "check_bounds", "check_l2_operands", "check_launch",
    "check_same_device", "l2_gram_tile", "mask_subchunk_min",
    "pad_queries", "plan_l_tile", "raise_on_error", "round_up",
    "tile_profile", "validate_scan_shapes",
]

SUBCHUNK = 8      # rows per selection granule
LANE = 128        # window tiles are multiples of this
Q_GRANULE = 16    # query-slot rounding of the window rule's byte model

# Masked rows score a finite BIG (never +inf: inf - inf is NaN, and the
# pooled selection must still order masked sub-chunks last).
BIG = 1e30

# The window rule's per-step byte budget (the JAX package's VMEM budget).
WINDOW_BUDGET = 10 * 2**20

# shared memory one block may use on sm_90 (227 KB)
SMEM_LIMIT = 232_448

_PROFILE_START = {"throughput": 512, "latency": 1024}
_LATENCY_QCAP = 8


def round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def pad_queries(qcap: int) -> int:
    """The query-slot count the window rule's byte model is evaluated at
    (qcap rounded up to :data:`Q_GRANULE`)."""
    return round_up(max(qcap, 1), Q_GRANULE)


def tile_profile(qcap: int) -> str:
    """``"latency"`` (1024-row start) at qcap <= 8, else
    ``"throughput"`` (512-row start)."""
    return "latency" if qcap <= _LATENCY_QCAP else "throughput"


def plan_l_tile(step_bytes: Callable[[int, int], int], q_pad: int,
                l_tile: Optional[int] = None,
                profile: str = "throughput") -> Optional[int]:
    """Largest window tile (a multiple of :data:`LANE`, at most the
    profile's start width or the explicit ``l_tile`` cap) whose
    ``step_bytes(q_pad, lt)`` fits :data:`WINDOW_BUDGET`, halving and
    re-aligning to the lane; None when even a 128-row tile does not fit.
    The JAX rule, step for step."""
    start = _PROFILE_START[profile]
    lt = max(LANE, round_up(min(start if l_tile is None else l_tile,
                                start), LANE))
    while lt > LANE and step_bytes(q_pad, lt) > WINDOW_BUDGET:
        lt = max(LANE, (lt // 2) // LANE * LANE)
    if step_bytes(q_pad, lt) > WINDOW_BUDGET:
        return None
    return lt


def l2_gram_tile(qv, y):
    """THE flat-family distance body: ``(‖q‖² + ‖y‖²) − 2 qᵀy`` for
    (..., Q, d) x (..., d, L) operands — bf16-rounded operands, products
    and sums in f32, the norms f32 sums of the rounded squares. Every sum
    runs over the feature axis in ascending order, as the CUDA kernels
    sum (a product of two bf16 values is exact in f32, so how the add is
    fused does not matter)."""
    qf = qv.to(torch.bfloat16).float()
    yf = y.to(torch.bfloat16).float()
    dots = qf.new_zeros(qf.shape[:-1] + yf.shape[-1:])
    qn = qf.new_zeros(qf.shape[:-1])
    yn = yf.new_zeros(yf.shape[:-2] + yf.shape[-1:])
    for c in range(qf.shape[-1]):
        qc, yc = qf[..., c], yf[..., c, :]
        dots.addcmul_(qc[..., :, None], yc[..., None, :])
        qn.addcmul_(qc, qc)
        yn.addcmul_(yc, yc)
    return qn[..., :, None] + yn[..., None, :] - 2.0 * dots


def mask_subchunk_min(d2, bounds, sub: int = SUBCHUNK, big: float = BIG):
    """Rows outside each list's ``[lo, hi)`` score ``big``; then the min
    over ``sub``-row granules: (LB, Q, Lpad) -> (LB, Q, Lpad/sub)."""
    lb, q, l_pad = d2.shape
    col = torch.arange(l_pad, device=d2.device, dtype=torch.int32)
    lo = bounds[:, 0].to(torch.int32)[:, None, None]
    hi = bounds[:, 1].to(torch.int32)[:, None, None]
    d2 = torch.where((col >= lo) & (col < hi), d2,
                     torch.tensor(big, dtype=d2.dtype, device=d2.device))
    return torch.amin(d2.reshape(lb, q, l_pad // sub, sub), dim=3)


def validate_scan_shapes(name: str, l_pad: int):
    """A sub-chunk scan needs ``Lpad`` on the sub-chunk granule."""
    if l_pad < SUBCHUNK or l_pad % SUBCHUNK:
        raise ValueError(
            f"{name}: Lpad={l_pad} must be a positive multiple of "
            f"{SUBCHUNK}"
        )


def check_l2_operands(name, qrows, slabs_t, bounds, slab_dtype):
    """Shape, dtype and device checks of an L2 scan's operands: bf16
    (LB, Q, d) query rows, an (LB, d, Lpad) slab of ``slab_dtype`` (bf16
    rows for the flat scan, int8 codes for the SQ scan), (LB, 2) int32
    bounds, Lpad on the sub-chunk granule."""
    if qrows.dim() != 3 or slabs_t.dim() != 3:
        raise ValueError(
            f"{name}: expected qrows (LB, Q, d) and slabs_t (LB, d, Lpad), "
            f"got {tuple(qrows.shape)} and {tuple(slabs_t.shape)}"
        )
    lb, q, d = qrows.shape
    if slabs_t.shape[0] != lb or slabs_t.shape[1] != d:
        raise ValueError(
            f"{name}: query dim {d} / blocks {lb} do not match slab shape "
            f"{tuple(slabs_t.shape)}"
        )
    check_bounds(name, bounds, lb)
    if qrows.dtype != torch.bfloat16 or slabs_t.dtype != slab_dtype:
        raise ValueError(
            f"{name}: qrows must be bfloat16 and the slab {slab_dtype}, "
            f"got {qrows.dtype} and {slabs_t.dtype}"
        )
    validate_scan_shapes(name, slabs_t.shape[2])
    check_same_device(name, qrows, slabs_t, bounds)


def check_bounds(name, bounds, lb: int):
    if tuple(bounds.shape) != (lb, 2) or bounds.dtype != torch.int32:
        raise ValueError(
            f"{name}: bounds must be (LB, 2) int32, got "
            f"{tuple(bounds.shape)} {bounds.dtype}"
        )


def check_same_device(name, *ts):
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"{name}: operands on different devices {devs}")


def check_launch(name, smem: int, slabs_t, lb: int, q: int,
                 q_tile: int = 64):
    """The launch limits the CUDA scans check again, as a clear error:
    shared memory per block, non-negative slab strides, grid y and z."""
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"{name}: the kernel's shared memory exceeds a block's "
            f"({smem} > {SMEM_LIMIT} bytes)"
        )
    if min(slabs_t.stride()) < 0 or lb > 65535 or -(-q // q_tile) > 65535:
        raise ValueError(
            f"{name}: negative slab strides or a grid beyond the launch "
            f"limits (LB={lb}, Q={q})"
        )


def raise_on_error(err: int, name: str, lib) -> None:
    """Raise when a launch returned a CUDA error (``lib.error_string``
    names it)."""
    if err:
        raise RuntimeError(
            f"{name}: kernel launch failed: CUDA error {err} "
            f"({lib.error_string(err).decode()})"
        )
