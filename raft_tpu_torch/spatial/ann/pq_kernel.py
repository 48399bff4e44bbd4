"""IVF-PQ ADC sub-chunk-min scan — the port of the TPU kernel
``pq_adc_subchunk_min`` (``raft_tpu/spatial/ann/pq_kernel.py:107``,
driven by ``scan_core.subchunk_scan``). The CUDA kernel is
``raft_tpu_torch/csrc/pq_scan.cu``; its source note says what bounds it
on the H100 and what the design does about it.

For each list block b, query slot q and 8-row sub-chunk j:
``out[b, q, j] = min over r in 8j..8j+7 of Σ_m lut[b, q, m·K + code[b, m, r]]``
over a bf16 LUT (LB, Q, M·K) and uint8 codes (LB, M, Lpad), the entries
widened to f32 and summed over ``m = 0..M−1`` in ascending order. Rows
outside the list's ``[lo, hi)`` range score :data:`BIG`. The TPU kernel
spells the lookup as a one-hot MXU contraction (Mosaic had no dynamic
gather); the CUDA kernel gathers from the LUT held in shared memory, and
the plain version gathers too.

:func:`pq_adc_subchunk_min` is the wrapper: tensors on the CPU go to
:func:`pq_adc_subchunk_min_plain`, tensors on a CUDA device go to the
kernel — or the wrapper raises. :data:`LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from raft_tpu_torch.spatial.ann import scan_core
from raft_tpu_torch.spatial.ann.scan_core import (
    BIG as BIG,  # re-export: callers read the masked-row constant here
    SUBCHUNK,
    pad_queries,
    round_up,
)

__all__ = [
    "BIG", "LAUNCHES", "SUBCHUNK", "plan_l_tile", "pq_adc_subchunk_min",
    "pq_adc_subchunk_min_plain", "pq_adc_supported",
]

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0

_ROW_TILE = 256          # csrc/pq_scan.cu kPqRowTile


def _smem_bytes(qtile: int, m: int, k: int) -> int:
    # csrc/pq_scan.cu pq_smem_bytes(): qtile LUT rows (bf16, the region
    # rounded up to 16 bytes) and an (M, 256) uint8 code tile
    return round_up(qtile * m * k * 2, 16) + m * _ROW_TILE


def _max_qtile(m: int, k: int) -> int:
    """csrc/pq_scan.cu raft_pq_adc_max_qtile(): the most query slots whose
    LUT rows fit one block beside the code tile (0: not even one)."""
    limit = scan_core.SMEM_LIMIT
    if m < 1 or k < 1 or m * _ROW_TILE >= limit:
        return 0
    q = (limit - m * _ROW_TILE) // (m * k * 2)
    while q > 0 and _smem_bytes(q, m, k) > limit:
        q -= 1
    return q


def _query_tile(q: int, m: int, k: int) -> int:
    """The kernel's query tile for Q slots: the largest balanced tiles
    that fit (the wrapper's grid y is ``ceil(Q / tile)``)."""
    n_tiles = -(-q // _max_qtile(m, k))
    return -(-q // n_tiles)


def _step_bytes(mk: int, q_pad: int, l_tile: int) -> int:
    # the JAX engine's window byte model (raft_tpu pq_kernel._step_bytes)
    return 2 * mk * l_tile + 2 * 2 * q_pad * mk + 4 * q_pad * l_tile


def plan_l_tile(mk: int, q_pad: int, l_tile=None, profile="throughput"):
    """The ADC engine's window tile under the shared JAX window rule
    (:func:`scan_core.plan_l_tile`); it fixes ``l_pad``, not the kernel's
    block tiling."""
    return scan_core.plan_l_tile(
        functools.partial(_step_bytes, mk), q_pad, l_tile, profile
    )


def pq_adc_supported(pq_dim: int, pq_bits: int, qcap: int) -> bool:
    """Whether the kernel engine applies: uint8 codes (``pq_bits <= 8``),
    one query's LUT and a code tile fit a block's shared memory (the
    kernel tiles the query axis itself), and the window rule yields a
    plan from which the grouped search derives ``l_pad``."""
    if not (1 <= pq_bits <= 8) or pq_dim < 1:
        return False
    if _max_qtile(pq_dim, 1 << pq_bits) < 1:
        return False
    return plan_l_tile(
        pq_dim * (1 << pq_bits), pad_queries(qcap),
        profile=scan_core.tile_profile(qcap),
    ) is not None


def pq_adc_subchunk_min_plain(luts, codes_t, bounds):
    """Plain PyTorch version (the counterpart of
    ``pq_adc_subchunk_min_lax``): a gather per subspace from the
    f32-widened LUT, added in ascending ``m`` as the kernel adds, then
    :func:`scan_core.mask_subchunk_min` over the (LB, Q, Lpad) tile."""
    lb, q, mk = luts.shape
    m_dim, l_pad = codes_t.shape[1], codes_t.shape[2]
    lut = luts.float().reshape(lb, q, m_dim, mk // m_dim)
    acc = lut.new_zeros((lb, q, l_pad))
    for m in range(m_dim):
        idx = codes_t[:, m, :].long()[:, None, :].expand(lb, q, l_pad)
        acc = acc + torch.gather(lut[:, :, m, :], 2, idx)
    return scan_core.mask_subchunk_min(acc, bounds)


def _check(luts, codes_t, bounds):
    name = "pq_adc_subchunk_min"
    if luts.dim() != 3 or codes_t.dim() != 3:
        raise ValueError(
            f"{name}: expected luts (LB, Q, M*K) and codes_t (LB, M, Lpad), "
            f"got {tuple(luts.shape)} and {tuple(codes_t.shape)}"
        )
    lb, q, mk = luts.shape
    m_dim = codes_t.shape[1]
    if codes_t.shape[0] != lb or m_dim < 1 or mk % m_dim:
        raise ValueError(
            f"{name}: LUT width {mk} / blocks {lb} do not match code slab "
            f"shape {tuple(codes_t.shape)} (the width must be M*K)"
        )
    if mk // m_dim > 256:
        raise ValueError(f"{name}: K={mk // m_dim} exceeds uint8 codes")
    scan_core.check_bounds(name, bounds, lb)
    if luts.dtype != torch.bfloat16 or codes_t.dtype != torch.uint8:
        raise ValueError(
            f"{name}: luts must be bfloat16 and codes_t uint8, got "
            f"{luts.dtype} and {codes_t.dtype}"
        )
    scan_core.validate_scan_shapes(name, codes_t.shape[2])
    scan_core.check_same_device(name, luts, codes_t, bounds)


def pq_adc_subchunk_min(luts, codes_t, bounds):
    """(LB, Q, M·K) bf16 LUTs x (LB, M, Lpad) uint8 codes -> (LB, Q,
    Lpad/8) f32 sub-chunk ADC minima.

    ``bounds`` (LB, 2) int32 is each list's valid row range ``[lo, hi)``
    in its code window. ``codes_t`` may be a strided view (a gathered
    (LB, Lpad, M) code slab ``.transpose(1, 2)``); Q is any positive
    count and Lpad any positive multiple of 8. CPU tensors run the plain
    version; CUDA tensors run the kernel."""
    name = "pq_adc_subchunk_min"
    _check(luts, codes_t, bounds)
    dev = luts.device
    if dev.type == "cpu":
        return pq_adc_subchunk_min_plain(luts, codes_t, bounds)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    lb, q, mk = luts.shape
    m_dim, l_pad = codes_t.shape[1], codes_t.shape[2]
    k_dim = mk // m_dim
    if _max_qtile(m_dim, k_dim) < 1:
        raise ValueError(
            f"{name}: one query's LUT ({mk} bf16) and a code tile exceed "
            f"a block's shared memory ({scan_core.SMEM_LIMIT} bytes)"
        )
    qtile = _query_tile(q, m_dim, k_dim)
    scan_core.check_launch(name, _smem_bytes(qtile, m_dim, k_dim), codes_t,
                           lb, q, q_tile=qtile)
    luts = luts.contiguous()
    bounds = bounds.contiguous()
    out = torch.empty((lb, q, l_pad // SUBCHUNK), dtype=torch.float32,
                      device=dev)
    lib = _lib()
    sb, sm, sl = codes_t.stride()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.raft_pq_adc_subchunk_min(
            luts.data_ptr(), codes_t.data_ptr(), bounds.data_ptr(),
            out.data_ptr(), lb, q, m_dim, k_dim, l_pad, sb, sm, sl, stream,
        )
    scan_core.raise_on_error(err, name, lib)
    global LAUNCHES
    LAUNCHES += 1
    return out


def _lib():
    from raft_tpu_torch import _build

    lib = _build.load("pq_scan")
    fn = lib.raft_pq_adc_subchunk_min
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, i, i, i, i, i, ll, ll, ll, p]
        fn.restype = ctypes.c_int
        lib.error_string = lib.raft_pq_error_string
        lib.error_string.argtypes = [i]
        lib.error_string.restype = ctypes.c_char_p
        lib.raft_pq_adc_max_qtile.argtypes = [i, i]
        lib.raft_pq_adc_max_qtile.restype = i
        lib.raft_pq_adc_smem_bytes.argtypes = [i, i, i]
        lib.raft_pq_adc_smem_bytes.restype = ll
    return lib
