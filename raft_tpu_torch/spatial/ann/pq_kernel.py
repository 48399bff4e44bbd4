"""IVF-PQ ADC sub-chunk-min scan — the port of the TPU kernel
``pq_adc_subchunk_min`` (``raft_tpu/spatial/ann/pq_kernel.py:107``,
driven by ``scan_core.subchunk_scan``). The CUDA kernel is
``raft_tpu_torch/csrc/pq_scan.cu``; its source note says what bounds it
on the H100 and what the design does about it.

For each list b, query slot q and 8-row sub-chunk j:
``out[b, q, j] = min over r in 8j..8j+7 of Σ_m lut[b, q, m·K + code[b, m, r]]``
over bf16 LUT rows and uint8 codes, the entries widened to f32 and
summed over ``m = 0..M−1`` in ascending order. Rows outside the list's
``[lo, hi)`` range score :data:`BIG`. The TPU kernel spells the lookup
as a one-hot MXU contraction (Mosaic had no dynamic gather); the CUDA
kernel gathers from LUT rows held in shared memory, and the plain
version gathers too.

Two entries launch the one kernel:

* :func:`pq_adc_lists` — the grouped search's form: one launch over
  every list of a chunk, LUT rows read through a (lists, Q) slot map
  (−1: a dead slot, which scores BIG) and codes read in place from the
  index's code rows by window origin.
* :func:`pq_adc_subchunk_min` — the gathered form of the JAX kernel,
  (LB, Q, M·K) LUTs x an (LB, M, Lpad) code slab: the identity slot map
  and list b's window at row b·Lpad of the slab.

Tensors on the CPU go to the plain versions
(:func:`pq_adc_lists_plain`, :func:`pq_adc_subchunk_min_plain`),
tensors on a CUDA device go to the kernel — or the wrapper raises.
:data:`LAUNCHES` counts kernel launches of both entries.

The tables the scan reads come from a second kernel of the same library,
:func:`pq_lut_rows`: the bf16 ADC rows of live (list, query) pairs, each
written once (plain version :func:`pq_lut_rows_plain`, launches counted
in :data:`LUT_LAUNCHES`). It replaces no TPU kernel: the JAX package
builds its LUTs in ``jnp``.
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
    "BIG", "LAUNCHES", "LUT_LAUNCHES", "SUBCHUNK", "plan_l_tile",
    "pq_adc_lists", "pq_adc_lists_plain", "pq_adc_subchunk_min",
    "pq_adc_subchunk_min_plain", "pq_adc_supported", "pq_lut_rows",
    "pq_lut_rows_plain", "window_l_pad",
]

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0
# LUT-build kernel launches, likewise
LUT_LAUNCHES = 0

_ROW_TILE = 256          # csrc/pq_scan.cu kPqRowTile
_MAX_SLOTS = 8           # csrc/pq_scan.cu kPqMaxSlots


def _lut_stride_words(mk: int, slots: int) -> int:
    """csrc/pq_scan.cu lut_stride_words(): 32-bit words per staged LUT
    row, 16-byte rows at a stride of 32/S modulo 32 words."""
    w = round_up((mk + 1) // 2, 4)
    return w + (32 // slots - w % 32 + 64) % 32


def _smem_bytes(slots: int, m: int, k: int) -> int:
    # csrc/pq_scan.cu pq_smem_bytes(): S staged LUT rows and an (M, 256)
    # uint8 code tile
    return slots * _lut_stride_words(m * k, slots) * 4 + m * _ROW_TILE


def _slots(q: int, m: int, k: int) -> int:
    """csrc/pq_scan.cu raft_pq_lists_slots(): query slots per block, the
    largest power of two up to 8 (and up to Q rounded up to one) whose
    LUT rows fit beside a code tile; 0 when not even one fits."""
    if q < 1 or m < 1 or k < 1:
        return 0
    s = 1
    while s < _MAX_SLOTS and s < q:
        s *= 2
    while s > 0 and _smem_bytes(s, m, k) > scan_core.SMEM_LIMIT:
        s //= 2
    return s


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


def pq_adc_supported(pq_dim: int, pq_bits: int) -> bool:
    """Whether the kernel engine applies: uint8 codes (``pq_bits <= 8``)
    and one query's LUT row beside a code tile fit a block's shared
    memory. The kernel tiles the query axis itself, staging at most
    :data:`_MAX_SLOTS` LUT rows a block, so no qcap bounds it — unlike
    the JAX rule, whose window holds every slot's LUT row at once
    (:func:`window_l_pad`)."""
    return (1 <= pq_bits <= 8 and pq_dim >= 1
            and _slots(1, pq_dim, 1 << pq_bits) >= 1)


def window_l_pad(mk: int, qcap: int, max_list: int) -> int:
    """The kernel engine's window length ``l_pad``: ``max_list`` rounded
    up to the JAX window rule's tile (:func:`plan_l_tile`) at ``qcap``,
    or to one lane where that rule has no plan — its byte model counts
    the LUT rows of all ``qcap`` slots in one TPU window, which bounds
    the TPU kernel and not this one."""
    l_tile = plan_l_tile(
        mk, pad_queries(qcap),
        l_tile=round_up(max_list, scan_core.LANE),
        profile=scan_core.tile_profile(qcap),
    )
    return round_up(max_list, l_tile or scan_core.LANE)


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


def pq_adc_lists_plain(luts, lut_map, codes, origins, bounds, l_pad: int):
    """Plain PyTorch version of :func:`pq_adc_lists`: the gathered form
    (:func:`pq_adc_subchunk_min_plain`) of every list with a live slot,
    on ``luts[lut_map[b]]`` and the code window ``codes[origins[b] :
    origins[b] + l_pad]``. As in the kernel, a dead slot (a map entry
    outside ``[0, n_luts)``) scores :data:`BIG`, and a list with no live
    slot is not scanned at all — its minima are all BIG."""
    n_lists, q = lut_map.shape
    live = (lut_map >= 0) & (lut_map < luts.shape[0])
    out = torch.full((n_lists, q, l_pad // SUBCHUNK), BIG,
                     dtype=torch.float32, device=luts.device)
    scanned = torch.nonzero(live.any(1)).squeeze(1)
    if scanned.numel():
        lv = live[scanned]
        lg = luts[torch.where(lv, lut_map[scanned], 0).long()]
        win = (origins[scanned].long()[:, None]
               + torch.arange(l_pad, device=codes.device))
        got = pq_adc_subchunk_min_plain(lg, codes[win].transpose(1, 2),
                                        bounds[scanned])
        out[scanned] = torch.where(lv[:, :, None], got, BIG)
    return out


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
    _check_types(name, luts, codes_t, mk // m_dim)
    scan_core.check_bounds(name, bounds, lb)
    scan_core.validate_scan_shapes(name, codes_t.shape[2])
    scan_core.check_same_device(name, luts, codes_t, bounds)


def _check_types(name, luts, codes, k_dim):
    if k_dim > 256:
        raise ValueError(f"{name}: K={k_dim} exceeds uint8 codes")
    if luts.dtype != torch.bfloat16 or codes.dtype != torch.uint8:
        raise ValueError(
            f"{name}: luts must be bfloat16 and codes uint8, got "
            f"{luts.dtype} and {codes.dtype}"
        )


def _check_lists(name, luts, lut_map, codes, origins, bounds, l_pad):
    if luts.dim() != 2 or codes.dim() != 2 or lut_map.dim() != 2:
        raise ValueError(
            f"{name}: expected luts (P, M*K), codes (R, M) and lut_map "
            f"(lists, Q), got {tuple(luts.shape)}, {tuple(codes.shape)} "
            f"and {tuple(lut_map.shape)}"
        )
    m_dim = codes.shape[1]
    if m_dim < 1 or luts.shape[1] % m_dim or luts.shape[1] < m_dim:
        raise ValueError(
            f"{name}: LUT width {luts.shape[1]} does not match {m_dim} "
            "code columns (the width must be M*K)"
        )
    _check_types(name, luts, codes, luts.shape[1] // m_dim)
    n_lists = lut_map.shape[0]
    if (lut_map.dtype != torch.int32 or origins.dtype != torch.int32
            or tuple(origins.shape) != (n_lists,)):
        raise ValueError(
            f"{name}: lut_map and origins must be int32 of shapes "
            f"(lists, Q) and (lists,), got {lut_map.dtype} "
            f"{tuple(lut_map.shape)} and {origins.dtype} "
            f"{tuple(origins.shape)}"
        )
    scan_core.check_bounds(name, bounds, n_lists)
    scan_core.validate_scan_shapes(name, l_pad)
    if codes.shape[0] < l_pad:
        raise ValueError(
            f"{name}: {codes.shape[0]} code rows cannot hold a window of "
            f"{l_pad}")
    scan_core.check_same_device(name, luts, lut_map, codes, origins, bounds)


def pq_adc_lists(luts, lut_map, codes, origins, bounds, l_pad: int,
                 out=None):
    """One launch over every list of a chunk -> (lists, Q, l_pad/8) f32
    sub-chunk ADC minima (written into ``out`` when given: a contiguous
    f32 tensor of that shape, for example a slice of a batch's array).

    ``luts`` (P, M·K) bf16 holds the LUT rows of the chunk's live
    (list, slot) pairs; ``lut_map`` (lists, Q) int32 names each slot's
    row, −1 marking a dead slot (it scores BIG). ``codes`` (R, M) uint8
    contiguous are the index's code rows, read in place: list b's window
    is rows ``origins[b] .. origins[b] + l_pad − 1`` (the caller keeps
    every window inside ``codes``), and ``bounds`` (lists, 2) int32 its
    valid ``[lo, hi)`` relative to that origin. On live slots the result
    equals :func:`pq_adc_subchunk_min` on the gathered LUT and code
    slabs. CPU tensors run the plain version; CUDA tensors run the
    kernel."""
    name = "pq_adc_lists"
    _check_lists(name, luts, lut_map, codes, origins, bounds, l_pad)
    if luts.device.type == "cpu":
        res = pq_adc_lists_plain(luts, lut_map, codes, origins, bounds,
                                 l_pad)
        return res if out is None else out.copy_(res)
    return _launch(name, luts, lut_map, codes, origins, bounds, l_pad, out)


def pq_adc_subchunk_min(luts, codes_t, bounds):
    """(LB, Q, M·K) bf16 LUTs x (LB, M, Lpad) uint8 codes -> (LB, Q,
    Lpad/8) f32 sub-chunk ADC minima.

    ``bounds`` (LB, 2) int32 is each list's valid row range ``[lo, hi)``
    in its code window. ``codes_t`` may be a strided view (a gathered
    (LB, Lpad, M) code slab ``.transpose(1, 2)``, read without a copy;
    other layouts are made row-major first); Q is any positive count and
    Lpad any positive multiple of 8. CPU tensors run the plain version;
    CUDA tensors run the kernel of :func:`pq_adc_lists` with the identity
    slot map and list b's window at row b·Lpad."""
    name = "pq_adc_subchunk_min"
    _check(luts, codes_t, bounds)
    dev = luts.device
    if dev.type == "cpu":
        return pq_adc_subchunk_min_plain(luts, codes_t, bounds)
    lb, q, mk = luts.shape
    m_dim, l_pad = codes_t.shape[1], codes_t.shape[2]
    codes = codes_t.transpose(1, 2).contiguous().reshape(lb * l_pad, m_dim)
    i32 = torch.int32
    lut_map = torch.arange(lb * q, dtype=i32, device=dev).reshape(lb, q)
    origins = torch.arange(0, lb * l_pad, l_pad, dtype=i32, device=dev)
    return _launch(name, luts.reshape(lb * q, mk), lut_map, codes, origins,
                   bounds, l_pad, None)


def _launch(name, luts, lut_map, codes, origins, bounds, l_pad, out):
    dev = luts.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not codes.is_contiguous():
        raise ValueError(f"{name}: codes must be contiguous (row-major)")
    n_lists, q = lut_map.shape
    m_dim = codes.shape[1]
    k_dim = luts.shape[1] // m_dim
    slots = _slots(q, m_dim, k_dim)
    if slots < 1:
        raise ValueError(
            f"{name}: one query's LUT ({luts.shape[1]} bf16) and a code "
            f"tile exceed a block's shared memory ({scan_core.SMEM_LIMIT} "
            "bytes)"
        )
    if n_lists > 65535:
        raise ValueError(f"{name}: {n_lists} lists exceed the grid's 65535")
    shape = (n_lists, q, l_pad // SUBCHUNK)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=dev)
    elif (tuple(out.shape) != shape or out.dtype != torch.float32
          or not out.is_contiguous() or out.device != dev):
        raise ValueError(
            f"{name}: out must be a contiguous f32 {shape} tensor on {dev}")
    luts = luts.contiguous()
    lut_map = lut_map.contiguous()
    origins = origins.contiguous()
    bounds = bounds.contiguous()
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.raft_pq_adc_lists(
            luts.data_ptr(), lut_map.data_ptr(), codes.data_ptr(),
            origins.data_ptr(), bounds.data_ptr(), out.data_ptr(), n_lists,
            q, luts.shape[0], m_dim, k_dim, l_pad, stream,
        )
    scan_core.raise_on_error(err, name, lib)
    global LAUNCHES
    LAUNCHES += 1
    return out


def pq_lut_rows_plain(queries, centroids, codebooks, cb_norms, pair_lists,
                      pair_qids):
    """Plain PyTorch version of :func:`pq_lut_rows`, in the kernel's
    order: one rounded f32 operation a tensor op (never ``einsum`` or
    ``sum``, whose order is not fixed), the residual's norm and its dot
    with each codebook entry accumulated over ascending ``j``."""
    m_dim, k_dim, ds = codebooks.shape
    res = (queries[pair_qids] - centroids[pair_lists]).reshape(-1, m_dim, ds)
    n = res[:, :, 0] * res[:, :, 0]
    g = res[:, :, None, 0] * codebooks[:, :, 0]
    for j in range(1, ds):
        n = n + res[:, :, j] * res[:, :, j]
        g = g + res[:, :, None, j] * codebooks[:, :, j]
    lut = (n[:, :, None] + cb_norms) - 2.0 * g
    return lut.reshape(-1, m_dim * k_dim).to(torch.bfloat16)


def _check_lut_rows(name, queries, centroids, codebooks, cb_norms,
                    pair_lists, pair_qids):
    if (queries.dim() != 2 or centroids.dim() != 2 or codebooks.dim() != 3
            or cb_norms.dim() != 2 or pair_lists.dim() != 1
            or pair_qids.dim() != 1):
        raise ValueError(
            f"{name}: expected queries (nq, d), centroids (lists, d), "
            "codebooks (M, K, ds), cb_norms (M, K) and pair ids (P,), got "
            f"{tuple(queries.shape)}, {tuple(centroids.shape)}, "
            f"{tuple(codebooks.shape)}, {tuple(cb_norms.shape)}, "
            f"{tuple(pair_lists.shape)} and {tuple(pair_qids.shape)}"
        )
    f32, i64 = torch.float32, torch.int64
    if (any(t.dtype != f32 for t in (queries, centroids, codebooks, cb_norms))
            or pair_lists.dtype != i64 or pair_qids.dtype != i64):
        raise ValueError(
            f"{name}: queries, centroids, codebooks and cb_norms must be "
            f"float32 and the pair ids int64, got {queries.dtype}, "
            f"{centroids.dtype}, {codebooks.dtype}, {cb_norms.dtype}, "
            f"{pair_lists.dtype} and {pair_qids.dtype}"
        )
    m_dim, k_dim, ds = codebooks.shape
    d = queries.shape[1]
    if (min(m_dim, k_dim, ds) < 1 or d != m_dim * ds
            or centroids.shape[1] != d
            or tuple(cb_norms.shape) != (m_dim, k_dim)
            or pair_lists.shape != pair_qids.shape):
        raise ValueError(
            f"{name}: widths do not match: queries {tuple(queries.shape)}, "
            f"centroids {tuple(centroids.shape)}, codebooks "
            f"{tuple(codebooks.shape)} (d must be M*ds), cb_norms "
            f"{tuple(cb_norms.shape)}, pair ids {tuple(pair_lists.shape)} "
            f"and {tuple(pair_qids.shape)}"
        )
    if k_dim > 256:
        raise ValueError(f"{name}: K={k_dim} exceeds uint8 codes")
    ts = (queries, centroids, codebooks, cb_norms, pair_lists, pair_qids)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: every operand must be contiguous")
    scan_core.check_same_device(name, *ts)


def pq_lut_rows(queries, centroids, codebooks, cb_norms, pair_lists,
                pair_qids):
    """The bf16 ADC tables (P, M·K) of P (list, query) pairs -> each
    row written once.

    Row i is query ``pair_qids[i]``'s residual against centroid
    ``pair_lists[i]``, scored against every codebook entry with the
    residual's norm added, so summed entries are complete squared
    distances: ``bf16((n + cb_norms[m, k]) − 2·g)`` with ``n`` the
    residual's squared norm in subspace m and ``g`` its dot with
    ``codebooks[m, k]``, both accumulated over ascending ``j``, every
    operation one rounded f32 op (``csrc/pq_scan.cu`` states the order).
    ``queries`` (nq, d), ``centroids`` (lists, d), ``codebooks`` (M, K,
    ds) and ``cb_norms`` (M, K) are contiguous f32 with d = M·ds and K
    <= 256; the ids are int64 rows of centroids and queries (the caller
    keeps them in range). CPU tensors run the plain version; CUDA tensors
    run the kernel. No pair: an empty table, no launch."""
    name = "pq_lut_rows"
    _check_lut_rows(name, queries, centroids, codebooks, cb_norms,
                    pair_lists, pair_qids)
    dev = queries.device
    if dev.type == "cpu":
        return pq_lut_rows_plain(queries, centroids, codebooks, cb_norms,
                                 pair_lists, pair_qids)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    m_dim, k_dim, ds = codebooks.shape
    n_pairs = pair_lists.shape[0]
    out = torch.empty((n_pairs, m_dim * k_dim), dtype=torch.bfloat16,
                      device=dev)
    if n_pairs == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.raft_pq_lut_rows(
            queries.data_ptr(), centroids.data_ptr(), codebooks.data_ptr(),
            cb_norms.data_ptr(), pair_lists.data_ptr(), pair_qids.data_ptr(),
            out.data_ptr(), n_pairs, queries.shape[1], m_dim, k_dim, ds,
            stream,
        )
    scan_core.raise_on_error(err, name, lib)
    global LUT_LAUNCHES
    LUT_LAUNCHES += 1
    return out


def _lib():
    from raft_tpu_torch import _build

    lib = _build.load("pq_scan")
    fn = lib.raft_pq_adc_lists
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = i
        lib.error_string = lib.raft_pq_error_string
        lib.error_string.argtypes = [i]
        lib.error_string.restype = ctypes.c_char_p
        lib.raft_pq_lists_slots.argtypes = [i, i, i]
        lib.raft_pq_lists_slots.restype = i
        lib.raft_pq_lists_smem_bytes.argtypes = [i, i, i]
        lib.raft_pq_lists_smem_bytes.restype = ctypes.c_longlong
        lib.raft_pq_lut_rows.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                         p]
        lib.raft_pq_lut_rows.restype = i
    return lib
