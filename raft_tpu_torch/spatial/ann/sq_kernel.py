"""IVF-SQ int8 dequant + sub-chunk-min scan — the port of the TPU kernel
``sq_scan_subchunk_min`` (``raft_tpu/spatial/ann/sq_kernel.py:114``,
driven by ``scan_core.subchunk_scan``). The CUDA kernel is the flat
scan's tensor-core list kernel (``raft_tpu_torch/csrc/flat_scan.cu``)
with an int8 row loader: codes cross device memory at one byte per
element, read in place by window origin, and are dequantized into the
bf16 shared stage; the source note says what bounds it on the H100.

For each list b, query slot q and 8-row sub-chunk j:
``out[b, q, j] = min over r in 8j..8j+7 of (‖q‖² + ‖y_r‖²) − 2 q·y_r``
where ``y = bf16((code + 128) · vscale + vmin)`` per dimension
(:func:`_dequant_tile`); bf16 operands, f32 products, norms and sums;
rows outside the list's ``[lo, hi)`` range score :data:`BIG`.

Two entries launch the one kernel, as in :mod:`.flat_kernel`:

* :func:`sq_scan_lists` — the grouped search's form: one launch per
  batch, query rows read by id through the (lists, Q) slot map, code
  rows read in place from the index by window origin; dead slots and
  lists without a live slot score BIG.
* :func:`sq_scan_subchunk_min` — the gathered form of the JAX kernel,
  (LB, Q, d) query rows x an (LB, d, Lpad) code slab: list b's window
  starts at row b·Lpad and every slot is live.

Tensors on the CPU go to the plain versions (:func:`sq_scan_lists_plain`,
:func:`sq_scan_subchunk_min_plain`, the counterpart of the JAX
``sq_scan_subchunk_min_lax`` mirror), tensors on a CUDA device go to the
kernel — or the wrapper raises. The tensor cores sum the dot in their own
order, so the kernel equals the plain version bit for bit where every
partial sum is exact (dyadic stats and integer queries) and within
1e-5 × (‖q‖² + ‖y‖²) elsewhere. :data:`LAUNCHES` counts kernel launches of
both entries.
"""

from __future__ import annotations

import functools

import torch

from raft_tpu_torch.core.device import full_f32
from raft_tpu_torch.spatial.ann import flat_kernel, scan_core
from raft_tpu_torch.spatial.ann.scan_core import (
    BIG as BIG,  # re-export: callers read the masked-row constant here
    SUBCHUNK,
    pad_queries,
)

__all__ = [
    "BIG", "LAUNCHES", "SUBCHUNK", "plan_l_tile", "sq_scan_lists",
    "sq_scan_lists_plain", "sq_scan_subchunk_min",
    "sq_scan_subchunk_min_plain", "sq_scan_supported",
]

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0


def _step_bytes(d: int, q_pad: int, l_tile: int) -> int:
    # the JAX engine's window byte model (raft_tpu sq_kernel._step_bytes)
    return (2 * d * l_tile + 2 * d * l_tile
            + 2 * 2 * q_pad * d + 4 * q_pad * l_tile)


def plan_l_tile(d: int, q_pad: int, l_tile=None, profile="throughput"):
    """The SQ engine's window tile under the shared JAX window rule
    (:func:`scan_core.plan_l_tile`); it fixes ``l_pad``, not the kernel's
    block tiling."""
    return scan_core.plan_l_tile(
        functools.partial(_step_bytes, d), q_pad, l_tile, profile
    )


def sq_scan_supported(d: int, qcap: int) -> bool:
    """Whether the kernel engine applies: one block's shared-memory
    tiles fit at width ``d`` and the query tile of ``qcap`` slots, and
    the window rule yields a plan from which the grouped search derives
    ``l_pad``."""
    q_tile = flat_kernel._q_tile(max(qcap, 1))
    if (d < 1 or flat_kernel._sq_lists_smem_bytes(d, q_tile)
            > scan_core.SMEM_LIMIT):
        return False
    return plan_l_tile(
        d, pad_queries(qcap), profile=scan_core.tile_profile(qcap)
    ) is not None


def _dequant_tile(codes, vmin_col, vscale_col):
    """The QT_8bit affine map of an int8 tile, ``(code + 128) · vscale +
    vmin`` in f32 — the multiply and the add rounded each on its own
    (the kernel writes them as ``__fmul_rn`` / ``__fadd_rn``) — then
    rounded once to bf16. ``vmin_col`` / ``vscale_col`` broadcast over
    the tile's feature axis."""
    yf = (codes.float() + 128.0) * vscale_col + vmin_col
    return yf.to(torch.bfloat16)


@full_f32
def sq_scan_subchunk_min_plain(qrows, codes_t, bounds, vmin, vscale):
    """Plain PyTorch version (the counterpart of
    ``sq_scan_subchunk_min_lax``): :func:`_dequant_tile`, then the flat
    distance body :func:`scan_core.l2_gram_tile` and
    :func:`scan_core.mask_subchunk_min`, through a materialized
    (LB, Q, Lpad) distance tile."""
    d = qrows.shape[2]
    yb = _dequant_tile(codes_t, vmin.float().reshape(1, d, 1),
                       vscale.float().reshape(1, d, 1))
    d2 = scan_core.l2_gram_tile(qrows, yb)
    return scan_core.mask_subchunk_min(d2, bounds)


def sq_scan_lists_plain(queries, qmat, codes, origins, bounds, l_pad: int,
                        vmin, vscale):
    """Plain PyTorch version of :func:`sq_scan_lists`: the gathered form
    (:func:`sq_scan_subchunk_min_plain`) of every list with a live slot,
    on ``queries[qmat[b]]`` and the code window
    ``codes[origins[b] : origins[b] + l_pad]``. A dead slot (an id outside
    ``[0, n − 1)``: the sentinel, the last row of ``queries``) scores
    :data:`BIG`, and a list with no live slot is not scanned at all."""
    return flat_kernel._lists_plain(
        queries, qmat, codes, origins, bounds, l_pad, queries.shape[0] - 1,
        lambda qv, slabs_t, b: sq_scan_subchunk_min_plain(qv, slabs_t, b,
                                                          vmin, vscale))


def _check_params(name, vmin, vscale, d, device):
    for pname, v in (("vmin", vmin), ("vscale", vscale)):
        if tuple(v.shape) != (d,) or v.dtype != torch.float32:
            raise ValueError(
                f"{name}: {pname} must be ({d},) float32, got "
                f"{tuple(v.shape)} {v.dtype}"
            )
        if v.device != device:
            raise ValueError(
                f"{name}: {pname} on {v.device}, the operands on {device}"
            )


def sq_scan_lists(queries, qmat, codes, origins, bounds, l_pad: int, vmin,
                  vscale):
    """One launch over every list of a grouped IVF-SQ batch -> (lists,
    Q, l_pad/8) f32 sub-chunk minima over the dequantized rows.

    As :func:`~.flat_kernel.flat_scan_lists`, with ``codes`` (R, d) int8
    contiguous — the index's codes, read in place (list b's window is
    rows ``origins[b] .. origins[b] + l_pad − 1``) — and ``vmin`` /
    ``vscale`` (d,) f32 the index's affine parameters. On live slots the
    result equals :func:`sq_scan_subchunk_min` on the gathered slabs.
    CPU tensors run the plain version; CUDA tensors run the kernel."""
    name = "sq_scan_lists"
    flat_kernel._check_lists(name, queries, qmat, codes, origins, bounds,
                             l_pad, row_dtype=torch.int8)
    _check_params(name, vmin, vscale, codes.shape[1], queries.device)
    if queries.device.type == "cpu":
        return sq_scan_lists_plain(queries, qmat, codes, origins, bounds,
                                   l_pad, vmin, vscale)
    out = flat_kernel._launch(name, queries, qmat, codes, origins, bounds,
                              l_pad, queries.shape[0] - 1,
                              params=torch.stack([vmin, vscale]))
    global LAUNCHES
    LAUNCHES += 1
    return out


def sq_scan_subchunk_min(qrows, codes_t, bounds, vmin, vscale):
    """(LB, Q, d) bf16 query rows x (LB, d, Lpad) int8 code slabs ->
    (LB, Q, Lpad/8) f32 sub-chunk minima of the squared L2 distance over
    the dequantized rows.

    ``vmin`` / ``vscale`` (d,) f32 are the index's affine parameters;
    ``bounds`` (LB, 2) int32 is each list's valid row range ``[lo, hi)``
    in its slab window. ``codes_t`` may be a strided view (a gathered
    (LB, Lpad, d) slab ``.transpose(1, 2)``, which is then read without a
    copy; other layouts are made row-major first); Q is any positive
    count and Lpad any positive multiple of 8. CPU tensors run the plain
    version; CUDA tensors run the kernel of :func:`sq_scan_lists` with
    list b's window at row b·Lpad and every slot live."""
    name = "sq_scan_subchunk_min"
    scan_core.check_l2_operands(name, qrows, codes_t, bounds, torch.int8)
    dev = qrows.device
    lb, q, d = qrows.shape
    _check_params(name, vmin, vscale, d, dev)
    if dev.type == "cpu":
        return sq_scan_subchunk_min_plain(qrows, codes_t, bounds, vmin,
                                          vscale)
    l_pad = codes_t.shape[2]
    rows = codes_t.transpose(1, 2).contiguous().reshape(lb * l_pad, d)
    i32 = torch.int32
    qmat = torch.arange(lb * q, dtype=i32, device=dev).reshape(lb, q)
    origins = torch.arange(0, lb * l_pad, l_pad, dtype=i32, device=dev)
    out = flat_kernel._launch(name, qrows.reshape(lb * q, d), qmat, rows,
                              origins, bounds, l_pad, lb * q,
                              params=torch.stack([vmin, vscale]))
    global LAUNCHES
    LAUNCHES += 1
    return out
