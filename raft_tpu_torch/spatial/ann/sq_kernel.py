"""IVF-SQ int8 dequant + sub-chunk-min scan — the port of the TPU kernel
``sq_scan_subchunk_min`` (``raft_tpu/spatial/ann/sq_kernel.py:114``,
driven by ``scan_core.subchunk_scan``). The CUDA kernel is
``raft_tpu_torch/csrc/sq_scan.cu``: the flat scan's templated kernel
(``csrc/scan_core.cuh``) with a tile loader that reads int8 codes at one
byte per element and dequantizes them as they are staged into shared
memory; its source note says what bounds it on the H100.

For each list block b, query slot q and 8-row sub-chunk j:
``out[b, q, j] = min over r in 8j..8j+7 of (‖q‖² + ‖y_r‖²) − 2 q·y_r``
where ``y = bf16((code + 128) · vscale + vmin)`` per dimension
(:func:`_dequant_tile`); bf16 operands, f32 products, norms and sums;
rows outside the list's ``[lo, hi)`` range score :data:`BIG`.

:func:`sq_scan_subchunk_min` is the wrapper: tensors on the CPU go to
:func:`sq_scan_subchunk_min_plain` (the counterpart of the JAX
``sq_scan_subchunk_min_lax`` mirror), tensors on a CUDA device go to the
kernel — or the wrapper raises. :data:`LAUNCHES` counts kernel launches.
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
    "BIG", "LAUNCHES", "SUBCHUNK", "plan_l_tile", "sq_scan_subchunk_min",
    "sq_scan_subchunk_min_plain", "sq_scan_supported",
]

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0


def _smem_bytes(d: int) -> int:
    # csrc/scan_core.cuh l2_smem_bytes(d, 2): the L2 scan template's
    # tiles (a 64 x (d + 1) query tile, a d x 68 transposed slab tile, 64
    # query norms and 64 row norms) plus vmin and vscale, all f32
    return 4 * (64 * (d + 1) + d * 68 + 64 + 64) + 4 * 2 * d


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
    tiles fit at width ``d``, and the window rule yields a plan from
    which the grouped search derives ``l_pad``."""
    if d < 1 or _smem_bytes(d) > scan_core.SMEM_LIMIT:
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


def _check_params(vmin, vscale, d, device):
    for name, v in (("vmin", vmin), ("vscale", vscale)):
        if tuple(v.shape) != (d,) or v.dtype != torch.float32:
            raise ValueError(
                f"sq_scan_subchunk_min: {name} must be ({d},) float32, got "
                f"{tuple(v.shape)} {v.dtype}"
            )
        if v.device != device:
            raise ValueError(
                f"sq_scan_subchunk_min: {name} on {v.device}, the operands "
                f"on {device}"
            )


def sq_scan_subchunk_min(qrows, codes_t, bounds, vmin, vscale):
    """(LB, Q, d) bf16 query rows x (LB, d, Lpad) int8 code slabs ->
    (LB, Q, Lpad/8) f32 sub-chunk minima of the squared L2 distance over
    the dequantized rows.

    ``vmin`` / ``vscale`` (d,) f32 are the index's affine parameters;
    ``bounds`` (LB, 2) int32 is each list's valid row range ``[lo, hi)``
    in its slab window. ``codes_t`` may be a strided view (a gathered
    (LB, Lpad, d) slab ``.transpose(1, 2)``); Q is any positive count and
    Lpad any positive multiple of 8. CPU tensors run the plain version;
    CUDA tensors run the kernel."""
    name = "sq_scan_subchunk_min"
    scan_core.check_l2_operands(name, qrows, codes_t, bounds, torch.int8)
    dev = qrows.device
    lb, q, d = qrows.shape
    _check_params(vmin, vscale, d, dev)
    if dev.type == "cpu":
        return sq_scan_subchunk_min_plain(qrows, codes_t, bounds, vmin,
                                          vscale)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    l_pad = codes_t.shape[2]
    scan_core.check_launch(name, _smem_bytes(d), codes_t, lb, q)
    qrows = qrows.contiguous()
    bounds = bounds.contiguous()
    params = torch.stack([vmin, vscale])                     # (2, d)
    out = torch.empty((lb, q, l_pad // SUBCHUNK), dtype=torch.float32,
                      device=dev)
    lib = _lib()
    sb, sd, sl = codes_t.stride()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.raft_sq_scan_subchunk_min(
            qrows.data_ptr(), codes_t.data_ptr(), params.data_ptr(),
            bounds.data_ptr(), out.data_ptr(), lb, q, d, l_pad, sb, sd, sl,
            stream,
        )
    scan_core.raise_on_error(err, name, lib)
    global LAUNCHES
    LAUNCHES += 1
    return out


def _lib():
    from raft_tpu_torch import _build

    lib = _build.load("sq_scan")
    fn = lib.raft_sq_scan_subchunk_min
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, i, i, i, i, ll, ll, ll, p]
        fn.restype = ctypes.c_int
        lib.error_string = lib.raft_sq_error_string
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        lib.raft_sq_scan_smem_bytes.argtypes = [ctypes.c_int]
        lib.raft_sq_scan_smem_bytes.restype = ctypes.c_longlong
    return lib
