"""The grouped (list-major) IVF search: one body, :func:`search`, behind
IVF-Flat, IVF-SQ and IVF-PQ.

Each probed list is scanned once for all the queries probing it (at most
``qcap``, :func:`~.common.invert_probe_map_ranked`); the partials land in
a query-major pool whose top is selected. The body owns the phases, their
order and their ranges (:mod:`.search_obs`); an :class:`Engine` supplies
what is its own. Its kernel form scans lists in place with a hand-written
CUDA kernel (its plain version on the CPU) into 8-row sub-chunk minima,
whose rows are rescored in exact f32 (:func:`_rerank`: R, :mod:`.rerank`,
reads them in place where the engine names its f32 rows); its legacy form
scores rows in plain PyTorch. The engines: :class:`FlatEngine` (bf16
rows; the two-level coarse probe scans its member blocks with it),
``ivf_sq.SQEngine`` (int8 codes) and ``ivf_pq.PQEngine`` (PQ codes and
LUTs). :func:`resolve_kernel` is the one ``use_kernel`` rule of the
three.
"""

from __future__ import annotations

import collections.abc
import functools
import logging
import math

import torch

from raft_tpu_torch import errors
from raft_tpu_torch.core.annotate import annotate
from raft_tpu_torch.core.device import full_f32, hopper_device
from raft_tpu_torch.spatial.ann import flat_kernel, rerank, search_obs
from raft_tpu_torch.spatial.ann.common import (
    coarse_probe,
    invert_probe_map_ranked,
    map_query_blocks,
    regroup_pairs,
    regroup_values,
    scatter_pairs,
    score_l2_candidates,
    select_candidates,
    subchunk_pool_rows,
)
from raft_tpu_torch.spatial.ann.scan_core import SUBCHUNK
from raft_tpu_torch.spatial.selection import top_k_smallest

__all__ = [
    "ENGINE_FALLBACKS", "Engine", "FlatEngine", "RERANK_BLOCK_BYTES",
    "resolve_kernel", "search", "slab_rows",
]

logger = logging.getLogger("raft_tpu_torch")

# the exact rescore's candidate gather per query block on the gather route
# (:func:`_rerank`), at most (bytes)
RERANK_BLOCK_BYTES = 256 << 20

# partials past this many bytes, materialized as (n_lists, qcap, width),
# stream through the query-major pool instead
_STREAM_BYTES = 1 << 31


class _Fallbacks(collections.abc.Mapping):
    """Grouped searches of a CUDA index that ``use_kernel=None`` sent to
    the legacy engine because its kernel cannot serve them, by engine (an
    unrefined IVF-PQ search runs the legacy engine by rule, not counted):
    the ``reason="fallback"`` part of the legacy series of
    ``ivf_search_scan_form_total`` (:mod:`.search_obs`), read from it and
    never kept apart (``RAFT_TPU_OBS=off`` stops it with every series).
    Setting an entry (a reset to 0) moves the point it is read from; the
    counter never goes back."""

    _names = ("ivf_flat", "ivf_sq", "ivf_pq")

    def __init__(self):
        self._base = dict.fromkeys(self._names, 0)

    def _count(self, name):
        if name not in self._names:
            raise KeyError(name)
        return search_obs.scan_forms(name, "legacy", "fallback")

    def __getitem__(self, name):
        return self._count(name) - self._base[name]

    def __setitem__(self, name, value):
        self._base[name] = self._count(name) - value

    def __iter__(self):
        return iter(self._names)

    def __len__(self):
        return len(self._names)


ENGINE_FALLBACKS = _Fallbacks()
# (engine, reason) pairs already warned about
_fallback_reasons_warned: set = set()


def resolve_kernel(use_kernel, engine, device: torch.device, *shape,
                   refine: bool = True) -> bool:
    """The ``use_kernel`` rule of every grouped search: whether
    ``engine`` (an :class:`Engine` class) runs its kernel form at
    ``shape`` (what its ``fits`` takes) on ``device``.

    ``None``: the kernel on a capability-9.0 CUDA device when ``refine``
    holds (IVF-PQ's exact refine tail; an unrefined PQ search runs the
    legacy engine by rule, as in the JAX package) and the kernel fits; a
    CUDA search sent to the legacy engine otherwise is counted in
    ``ENGINE_FALLBACKS[engine.name]`` and warned about once per reason.
    ``True``: the kernel form, raising with the unmet requirement (on a
    CPU index its scan runs its plain version). ``False``: the legacy
    engine. Every call counts the form it picks, and why, in
    ``ivf_search_scan_form_total`` (:func:`.search_obs.scan_form`)."""
    if use_kernel is None:
        if device.type != "cuda" or not refine:
            search_obs.scan_form(
                engine.name, False,
                "host" if device.type != "cuda" else "unrefined")
            return False
        ok, reason, _ = engine.fits(*shape)
        if ok:
            if hopper_device(device):
                search_obs.scan_form(engine.name, True, "auto")
                return True
            reason = f"{device} is not a capability-9.0 (Hopper) card"
        search_obs.scan_form(engine.name, False, "fallback")
        if (engine.name, reason) not in _fallback_reasons_warned:
            _fallback_reasons_warned.add((engine.name, reason))
            logger.warning(
                "%s grouped search of a CUDA index runs the legacy "
                "plain-PyTorch scan, not the CUDA kernel: %s (use_kernel="
                "False chooses it without this warning)", engine.label,
                reason)
        return False
    if use_kernel:
        errors.expects(
            refine,
            "use_kernel=True requires the exact refine tail "
            "(refine_ratio > 1 and stored raw vectors or a "
            "refine_dataset): the kernel emits sub-chunk ADC minima to "
            "build the refine pool, not per-row ADC distances",
        )
        ok, _, unsupported = engine.fits(*shape)
        errors.expects(ok, unsupported)
        errors.expects(
            device.type == "cpu" or hopper_device(device),
            "use_kernel=True needs a capability-9.0 (Hopper) CUDA device "
            "for the sm_90a kernel; %s is not one", device,
        )
    search_obs.scan_form(engine.name, bool(use_kernel), "pinned")
    return bool(use_kernel)


def slab_rows(rows: torch.Tensor, n_rows: int, cache=None) -> torch.Tensor:
    """``rows`` as a scan kernel's slab operand: int8 (SQ) or uint8 (PQ)
    codes as they are, any other rows in bf16, zero rows appended up to
    ``n_rows`` (codes that need no padding come back without a copy);
    made once per ``n_rows`` into the dict ``cache`` when one is given
    (an index is not mutated in place)."""
    if cache is not None and n_rows in cache:
        return cache[n_rows]
    slab = (rows if rows.dtype in (torch.int8, torch.uint8)
            else rows.to(torch.bfloat16))
    if n_rows > slab.shape[0]:
        slab = torch.nn.functional.pad(slab,
                                       (0, 0, 0, n_rows - slab.shape[0]))
    if cache is not None:
        cache[n_rows] = slab
    return slab


class Batch:
    """One grouped search's operands, as the body hands them to its
    engine: the f32 queries, the probe map and its inversion, and (the
    kernel form) the scan windows."""

    def __init__(self, qf, probes, qcap, inverted):
        self.qf, self.probes, self.qcap = qf, probes, qcap
        self.qmat, self.rmat, self.l_flat, self.slot = inverted
        self.nq, self.p = probes.shape
        # the kernel form's windows (:meth:`Engine.window`): length, slab
        # rows, each list's clamped origin and its [lo, hi) within it
        self.l_pad = self.rows_pad = None
        self.win_origin = self.win_bounds = None

    @functools.cached_property
    def q_pad(self):
        """The queries with a zero row appended, an empty slot's query."""
        return torch.cat([self.qf, self.qf.new_zeros((1, self.qf.shape[1]))])

    @functools.cached_property
    def qn_pad(self):
        """The queries' squared norms, the empty slot's 0 appended."""
        return torch.cat([torch.sum(self.qf * self.qf, dim=1),
                          self.qf.new_zeros(1)])


class Engine:
    """What :func:`search` asks of an engine; an engine object serves one
    call. ``kernel`` picks the form (:func:`resolve_kernel`); ``ratio``
    sizes the exact rescore: the kernel form rescores the rows of the
    pool's top ``ceil(ratio * k)`` sub-chunks, and a legacy form with
    ``rescore`` its top ``ceil(ratio * k)`` candidates (IVF-PQ's
    refine); a legacy form without it returns its scan's scores.

    An engine defines ``fits(*shape)`` (whether its kernel serves the
    shape, the fallback's reason, the message ``use_kernel=True`` raises
    with); for the kernel form ``window(b)`` (the scan window's length
    and the slab's padded row count, its operands made) and ``scan(b,
    sel, ctx, luts, out)`` (lists ``sel``' (lists, qcap, width) minima,
    into ``out`` when given); for the legacy form ``scores(b, lblk, qids,
    pos)`` (list block ``lblk``'s (LB, qcap, L) squared distances of its
    slots' queries ``qids`` to the rows at slab positions ``pos``, before
    masking); and ``rows(pos)``, the f32 rows at slab positions ``pos``
    for the exact rescore. ``rerank_source()`` names the (n + 1, d) f32
    rows the rescore may read in place instead (R, :mod:`.rerank`), or
    None: the rows must be gathered through ``rows``."""

    name = label = ""     # search_obs / ENGINE_FALLBACKS key; in warnings
    rescore = False
    lut_stage = False     # the kernel form builds tables a piece

    def __init__(self, centroids, storage, kernel: bool, ratio: float):
        self.centroids, self.storage = centroids, storage
        self.kernel, self.ratio = bool(kernel), float(ratio)

    def pieces(self, b: Batch, stream: bool, list_block: int):
        """The kernel scan's list ranges in order, each ``(sel, ctx)``:
        ``sel`` indexes the list axis, ``ctx`` is the engine's own. One
        launch over every list, or list blocks when streaming."""
        if stream:
            return [(lblk, None) for lblk in _list_blocks(b, list_block)]
        return [(slice(None), None)]

    def tables(self, b: Batch, sel, ctx):
        """The piece's LUT rows (an engine with ``lut_stage``)."""
        return None

    def rerank_source(self):
        """The rows the exact rescore may read in place, or None."""
        return None


class FlatEngine(Engine):
    """List-sorted rows ``data`` (n + 1, d), the sentinel last: the
    kernel form reads them as a bf16 slab in place
    (:func:`~.flat_kernel.flat_scan_lists`; ``slab(n_rows)`` gives it,
    :func:`slab_rows` by default), the legacy form and the rescore in
    f32."""

    name, label = "ivf_flat", "IVF-Flat"
    kmod = flat_kernel

    def __init__(self, centroids, storage, data, kernel: bool = False,
                 ratio: float = 4.0, slab=None):
        super().__init__(centroids, storage, kernel, ratio)
        self.data = data
        self.slab = slab or functools.partial(slab_rows, data)

    @classmethod
    def of(cls, index, use_kernel, qcap: int, ratio: float = 4.0):
        """The engine of an ``IVFFlatIndex``, its form by the rule."""
        kernel = resolve_kernel(use_kernel, cls, index.device,
                                index.centroids.shape[1], qcap)
        return cls(index.centroids, index.storage, index.data_sorted,
                   kernel, ratio, index.scan_rows)

    @staticmethod
    def fits(d: int, qcap: int):
        return (
            flat_kernel.flat_scan_supported(d, qcap),
            f"d={d} qcap={qcap} does not fit the kernel's shared-memory "
            "tiles",
            f"use_kernel=True unsupported at d={d} qcap={qcap} (rows too "
            "wide for even an 8-slot query tile beside the kernel's "
            "row stages); use the legacy scan (use_kernel=False)",
        )

    def window(self, b):
        # l_pad fixes the sub-chunk windows and the pool clamp; the kernel
        # takes qcap rows as-is
        l_pad = flat_kernel.window_l_pad(self.data.shape[1], b.qcap,
                                         self.storage.max_list,
                                         plan=self.kmod.plan_l_tile)
        # n + 1 rows (sentinel last), zero-padded to one full window
        rows_pad = max(self.data.shape[0], l_pad)
        self._src = self.slab(rows_pad)
        self._q = b.q_pad.to(torch.bfloat16)
        return l_pad, rows_pad

    def scan(self, b, sel, ctx, luts, out=None):
        # query rows by id, slab rows in place: no gather
        return flat_kernel.flat_scan_lists(
            self._q, b.qmat[sel], self._src, b.win_origin[sel],
            b.win_bounds[sel], b.l_pad)

    def scores(self, b, lblk, qids, pos):
        mv = self.rows(pos)                                  # (LB, L, d)
        mn = torch.sum(mv * mv, dim=2)                       # (LB, L)
        dots = torch.bmm(b.q_pad[qids], mv.transpose(1, 2))  # full f32
        return b.qn_pad[qids][:, :, None] + mn[:, None, :] - 2.0 * dots

    def rows(self, pos):
        return self.data[pos].float()

    def rerank_source(self):
        return self.data


def _list_blocks(b: Batch, list_block: int):
    """The list axis in blocks of ``list_block`` ids, padded with the last
    list (the padded slots recompute it; nothing reads them)."""
    n_lists = b.qmat.shape[0]
    nl_pad = -(-n_lists // list_block) * list_block
    return torch.clamp(torch.arange(nl_pad, device=b.qmat.device),
                       max=n_lists - 1).reshape(-1, list_block)


def _kernel_pool(engine, b, width, stream, list_block):
    """The kernel form's (nq, p * width) pool of sub-chunk minima: each
    piece scattered into the query-major pool (``stream``), or the
    (n_lists, qcap, width) minima (one launch's, or each piece's written
    into its lists' rows) regrouped. Every piece in one ``ivf.scan``
    range, or (an engine with a LUT stage) one ``ivf.lut`` and one
    ``ivf.scan`` range a piece, the last holding the regroup."""
    pieces = engine.pieces(b, stream, list_block)
    if stream:
        vals = torch.full((b.nq, b.p, width), float("inf"),
                          dtype=torch.float32, device=b.qf.device)
    elif [sel for sel, _ in pieces] == [slice(None)]:
        vals = None                            # the one launch makes them
    else:
        vals = torch.empty((b.qmat.shape[0], b.qcap, width),
                           dtype=torch.float32, device=b.qf.device)

    def scan(sel, ctx, luts):
        nonlocal vals
        out = None if stream or vals is None else vals[sel]
        minima = engine.scan(b, sel, ctx, luts, out)
        if stream:
            scatter_pairs(vals, b.qmat[sel], b.rmat[sel], minima, b.nq, b.p)
        elif vals is None:
            vals = minima

    def pooled():
        if stream:
            return vals.reshape(b.nq, b.p * width)
        return regroup_values(vals, b.l_flat, b.slot, b.nq, b.p, b.qcap)

    if not engine.lut_stage:
        with annotate("ivf.scan"):
            for sel, ctx in pieces:
                scan(sel, ctx, None)
            return pooled()
    for i, (sel, ctx) in enumerate(pieces):
        with annotate("ivf.lut"):
            luts = engine.tables(b, sel, ctx)
        with annotate("ivf.scan"):
            scan(sel, ctx, luts)
            if i == len(pieces) - 1:
                return pooled()
    return pooled()


def _legacy_pool(engine, b, width, stream, list_block, row_mask):
    """The legacy form's (nq, p * width) pool of partials and their slab
    positions: each list block's rows scored, the ``[lo, hi)`` range and
    ``row_mask`` folded in, each slot's top ``width`` kept."""
    storage = engine.storage
    L, n = storage.max_list, storage.n
    nq, p = b.nq, b.p
    dev = b.qf.device
    offsets = storage.list_offsets.long()
    sizes = storage.list_sizes.long()
    qmat_l = b.qmat.long()

    def block(lblk):                                         # (LB,) list ids
        qids = qmat_l[lblk]                                  # (LB, qcap)
        offs, szs = offsets[lblk], sizes[lblk]
        o_c = torch.clamp(offs, max=n + 1 - L)               # slice clamp
        pos = o_c[:, None] + torch.arange(L, device=dev)[None, :]
        d2 = engine.scores(b, lblk, qids, pos)
        in_list = (pos >= offs[:, None]) & (pos < (offs + szs)[:, None])
        if row_mask is not None:
            in_list = in_list & (row_mask[pos] > 0)
        invalid = (qids >= nq)[:, :, None] | (~in_list)[:, None, :]
        d2 = torch.where(invalid, float("inf"), d2)
        vals, sel = top_k_smallest(d2, width)
        return vals, torch.gather(pos[:, None, :].expand(d2.shape), 2, sel)

    lids = _list_blocks(b, list_block)
    with annotate("ivf.scan"):
        if stream:
            # scatter each list block's partials straight into the
            # query-major (nq, p, width) pool; sentinel slots drop
            pv = torch.full((nq, p, width), float("inf"),
                            dtype=torch.float32, device=dev)
            pm = torch.full((nq, p, width), n, dtype=torch.int64, device=dev)
            for lblk in lids:
                vals, mem = block(lblk)
                scatter_pairs(pv, b.qmat[lblk], b.rmat[lblk], vals, nq, p)
                scatter_pairs(pm, b.qmat[lblk], b.rmat[lblk], mem, nq, p)
            return pv.reshape(nq, p * width), pm.reshape(nq, p * width)
        outs = [block(lblk) for lblk in lids]
        n_lists = b.qmat.shape[0]
        vals = torch.cat([o[0] for o in outs])[:n_lists]
        mem = torch.cat([o[1] for o in outs])[:n_lists]
        return regroup_pairs(vals, mem, b.l_flat, b.slot, nq, p, b.qcap)


@full_f32
def search(engine: Engine, q, k: int, n_probes: int, qcap: int,
           list_block: int, *, probes=None, stream_partials=None,
           row_mask=None):
    """The grouped search of the (nq, d) queries ``q`` over ``engine``'s
    lists: (nq, k) squared distances and original row ids (-1 where
    fewer than k rows were found), best first.

    ``probes``: the (nq, n_probes) probed lists, when the caller has
    them (else the coarse probe of ``engine.centroids``).
    ``stream_partials``: scatter the partials list block by list block
    into the query-major pool (``None``: once the materialized (n_lists,
    qcap, width) partials pass 2 GiB at the form's bytes per entry).
    ``row_mask``: an (n + 1,) live mask over slab positions (the
    mutation tier's tombstones; 0 = dead): the legacy form folds it into
    each list's row range, the kernel form applies it per row at the
    rescore (a dead row can crowd a pool slot, never surface), as the
    JAX package does."""
    storage = engine.storage
    n_lists = storage.list_index.shape[0]
    qf = q.float().contiguous()
    if probes is None:
        with annotate("ivf.probe"):
            probes, _ = coarse_probe(qf, engine.centroids, n_probes)
    with annotate("ivf.invert"):
        inverted = invert_probe_map_ranked(probes, n_lists, qcap)
    search_obs.count_pairs(engine.name, inverted[3], qcap)
    b = Batch(qf, probes, qcap, inverted)
    p = b.p

    if engine.kernel:
        b.l_pad, b.rows_pad = engine.window(b)
        width = b.l_pad // SUBCHUNK
        # every list's window origin (the slice clamp) and its [lo, hi)
        # relative to it: the scans read rows (or codes) in place
        offsets = storage.list_offsets.long()[:n_lists]
        o_all = torch.clamp(offsets, max=b.rows_pad - b.l_pad)
        lo_all = offsets - o_all
        b.win_origin = o_all.to(torch.int32)
        b.win_bounds = torch.stack(
            [lo_all, lo_all + storage.list_sizes.long()], 1).to(torch.int32)
    else:
        # per-(list, query) partial width: a rescored pool's, not just k
        # (a query's home list can hold most of its top candidates)
        width = min(max(k, math.ceil(engine.ratio * k)) if engine.rescore
                    else k, storage.max_list)
    if stream_partials is None:
        # the kernel form pools f32 minima; the legacy form positions too
        per_entry = 4 if engine.kernel else 8
        stream_partials = n_lists * qcap * width * per_entry > _STREAM_BYTES

    if engine.kernel:
        pv = _kernel_pool(engine, b, width, stream_partials, list_block)
        # rescore the rows of the top-c sub-chunks (a superset of the top
        # c rows by the 8-row cover) in exact f32; clamp c to the pool
        # width last
        c = min(p * width, max(k, int(math.ceil(engine.ratio * k))))
        with annotate("ivf.pool"):
            rpos, valid = subchunk_pool_rows(pv, c, probes, storage,
                                             b.rows_pad, b.l_pad, width)
            if row_mask is not None:
                valid = valid & (
                    row_mask[torch.clamp(rpos, 0, storage.n)] > 0)

        return _rerank(engine, qf, rpos, valid, k)

    pv, pm = _legacy_pool(engine, b, width, stream_partials, list_block,
                          row_mask)
    if not engine.rescore:
        with annotate("ivf.pool"):
            return select_candidates(storage, pm, pv, k)
    # exact refinement: top-c of the pooled candidates, f32 rescore
    c = max(k, min(int(math.ceil(engine.ratio * k)), p * width))
    with annotate("ivf.pool"):
        top, cpos = top_k_smallest(pv, c)                    # (nq, c)
        rpos = torch.gather(pm, 1, cpos)
    return _rerank(engine, qf, rpos, torch.isfinite(top), k)


def _rerank(engine: Engine, qf, rpos, valid, k: int):
    """The exact f32 rescore of the pool's candidates, the (nq, C) slab
    positions ``rpos`` where ``valid``, and their top ``k``: one launch of
    R over the engine's rows in place where
    :func:`~.rerank.rerank_kernel_fits` holds for its ``rerank_source()``,
    else the rows gathered (``engine.rows``) in query blocks whose gather
    stays under ``RERANK_BLOCK_BYTES``. Each call is counted by its route
    in ``ivf_rerank_calls_total`` (:func:`.search_obs.rerank`)."""
    storage = engine.storage
    src = engine.rerank_source()
    kernel = rerank.rerank_kernel_fits(qf, src)
    search_obs.rerank(engine.name, kernel)
    with annotate("ivf.rerank"):
        if kernel:
            errors.expects(
                src.shape[0] == storage.n + 1,
                "%s: rerank_source() has %d rows, not the %d of its "
                "storage and the sentinel", engine.label, src.shape[0],
                storage.n + 1)
            exact = rerank.rescore_rows_kernel(qf, src, rpos, valid)
            return select_candidates(storage, rpos, exact, k)

        def block(args):
            qb, rp, vl = args
            raw = engine.rows(torch.clamp(rp, 0, storage.n))
            exact = score_l2_candidates(qb, raw, vl & (rp < storage.n))
            return select_candidates(storage, rp, exact, k)

        nq, c = rpos.shape
        blk_q = max(8, min(nq, RERANK_BLOCK_BYTES // (c * qf.shape[1] * 4)))
        return map_query_blocks(block, (qf, rpos, valid), blk_q)
