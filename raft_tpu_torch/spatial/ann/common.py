"""Shared inverted-list storage and the grouped-search machinery — the
main-path half of ``raft_tpu/spatial/ann/common.py``.

Vectors are permuted so each list is contiguous, plus a dense
(n_lists, max_list) row-position matrix padded with the sentinel ``n``.
Searches probe lists by centroid distance (:func:`coarse_probe`), score
candidates in exact f32 (:func:`score_l2_candidates`) and keep the k
best (:func:`select_candidates`). The grouped searches invert the probe
map (:func:`invert_probe_map_ranked`) so each list is read once per
batch for all the queries probing it, at most ``qcap`` of them.

Selection ties: ``lax.top_k`` in the JAX package returns equal values
lowest index first. ``torch.topk`` does not promise that, so every
selection here goes through
:func:`~raft_tpu_torch.spatial.selection.top_k_smallest`, a stable sort —
with integer-exact data, ties are common and a different tie order would
pick different probes and different candidates, not just reorder them.
"""

from __future__ import annotations

import dataclasses
import logging
import weakref

import numpy as np
import torch

from raft_tpu_torch import errors
from raft_tpu_torch.core.device import full_f32
from raft_tpu_torch.spatial.ann.scan_core import BIG, SUBCHUNK
from raft_tpu_torch.spatial.selection import top_k_smallest

__all__ = [
    "ListStorage", "auto_qcap", "build_list_storage",
    "check_candidate_pool", "coarse_probe", "default_qcap",
    "invert_probe_map", "invert_probe_map_ranked", "map_query_blocks",
    "probe_drop_stats", "regroup_pairs", "regroup_values", "resolve_qcap",
    "resolve_qcap_arg", "scatter_pairs", "score_l2_candidates",
    "select_candidates", "split_oversized_lists", "static_qcap",
    "subchunk_pool_rows", "throughput_qcap", "warn_engine_fallback",
]

logger = logging.getLogger("raft_tpu_torch")


@dataclasses.dataclass
class ListStorage:
    """Sorted-by-list container.

    sorted_ids[i] = original row id of the i-th vector in list-sorted order;
    list_index[l, j] = position (into the sorted order) of the j-th member
    of list l, or ``n`` (sentinel) when padded.
    """

    sorted_ids: torch.Tensor     # (n,) int32
    list_offsets: torch.Tensor   # (n_lists + 1,) int32
    list_index: torch.Tensor     # (n_lists, max_list) int32, sentinel = n
    list_sizes: torch.Tensor     # (n_lists,) int32
    n: int
    max_list: int


@full_f32
def coarse_probe(qf, centroids, n_probes: int):
    """The ``n_probes`` nearest lists per query: returns (probes (nq, p)
    int64, centroid_d2 (nq, n_lists) f32), the gram in full f32.

    Where the JAX package switches to its chunk-min selection (n_lists a
    multiple of 128 and >= 512 x n_probes), that selection is
    value-exact but may order tied distances differently; this one
    always breaks ties lowest index first."""
    cents = centroids.float()
    qn = torch.sum(qf * qf, dim=1)
    cn = torch.sum(cents * cents, dim=1)
    g = qf @ cents.T
    d2 = qn[:, None] + cn[None, :] - 2.0 * g
    _, probes = top_k_smallest(d2, n_probes)
    return probes, d2


@full_f32
def score_l2_candidates(qf, cand, valid):
    """Batched |q - c|² over gathered candidates (nq, C, d), +inf where
    ``valid`` is False — the exact scoring primitive (full f32)."""
    qn = torch.sum(qf * qf, dim=1)
    cvn = torch.sum(cand * cand, dim=2)
    dots = torch.bmm(cand, qf[:, :, None])[:, :, 0]
    return torch.where(valid, qn[:, None] + cvn - 2.0 * dots,
                       float("inf"))


def select_candidates(storage: ListStorage, cand_pos, d2, k: int):
    """Top-k over candidate scores + remap to original row ids (-1 for
    padding that survives into the top-k)."""
    vals, pos = top_k_smallest(d2, k)
    sel = torch.gather(cand_pos, 1, pos).long()
    ids = storage.sorted_ids[torch.clamp(sel, 0, storage.n - 1)]
    ids = torch.where(torch.isfinite(vals), ids, -1)
    return vals, ids.to(torch.int32)


def map_query_blocks(fn, queries, block_q: int):
    """Apply ``fn`` to row blocks of ``queries`` (a tensor, or a tuple of
    tensors sharing the leading axis) and concatenate its ``(vals, ids)``
    — bounds the per-block candidate gather at any batch size."""
    multi = isinstance(queries, tuple)
    arrs = queries if multi else (queries,)
    nq = arrs[0].shape[0]
    if block_q >= nq:
        return fn(queries)
    outs = []
    for s in range(0, nq, block_q):
        blk = tuple(a[s:s + block_q] for a in arrs)
        outs.append(fn(blk if multi else blk[0]))
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def invert_probe_map(probes, n_lists: int, qcap: int):
    """Invert a (nq, p) query->list probe map: returns (qmat (n_lists,
    qcap) padded with nq, l_flat (nq*p,) the probed list of each pair,
    slot (nq*p,) that pair's row in qmat — >= qcap if dropped)."""
    qmat, _, l_flat, slot = invert_probe_map_ranked(probes, n_lists, qcap)
    return qmat, l_flat, slot


def invert_probe_map_ranked(probes, n_lists: int, qcap: int):
    """:func:`invert_probe_map` plus ``rmat`` (n_lists, qcap), the probe
    rank of each slot's pair (sentinel ``p``). Slots within a list fill in
    probe-rank order, so an overflowing list drops each query's marginal
    last-rank probes first."""
    nq, p = probes.shape
    dev = probes.device
    i32 = torch.int32
    l_flat = probes.reshape(-1).long()
    # arange // p, not repeat_interleave: that reads its size on the host
    q_flat = torch.arange(nq * p, device=dev, dtype=i32) // p
    rank_flat = torch.arange(p, device=dev, dtype=i32).repeat(nq)
    # two stable sorts = lexicographic (list, rank) order
    by_rank = torch.argsort(rank_flat, stable=True)
    order = by_rank[torch.argsort(l_flat[by_rank], stable=True)]
    sl = l_flat[order]
    sq = q_flat[order]
    starts = torch.searchsorted(sl, torch.arange(n_lists, device=dev))
    slot_sorted = (torch.arange(nq * p, device=dev) - starts[sl]).to(i32)
    # .at[...].set(mode="drop"): overflowing pairs land in a spare column
    # that is cut off (no boolean mask, which reads its count on the host)
    col = torch.clamp(slot_sorted, max=qcap).long()
    qmat = torch.full((n_lists, qcap + 1), nq, dtype=i32, device=dev)
    qmat[sl, col] = sq
    rmat = torch.full((n_lists, qcap + 1), p, dtype=i32, device=dev)
    rmat[sl, col] = rank_flat[order]
    qmat, rmat = qmat[:, :qcap].contiguous(), rmat[:, :qcap].contiguous()
    slot = torch.zeros(nq * p, dtype=i32, device=dev)
    slot[order] = slot_sorted
    return qmat, rmat, l_flat, slot


def regroup_values(vals, l_flat, slot, nq: int, p: int, qcap: int):
    """Redistribute per-(list, query-slot) values to query-major order:
    (n_lists, qcap, w) -> (nq, p*w) (+inf where the pair overflowed
    qcap)."""
    w = vals.shape[-1]
    ok = slot < qcap
    safe_slot = torch.clamp(slot, max=qcap - 1).long()
    pv = torch.where(ok[:, None], vals[l_flat, safe_slot], float("inf"))
    return pv.reshape(nq, p * w)


def regroup_pairs(vals, mem, l_flat, slot, nq: int, p: int, qcap: int):
    """Redistribute per-(list, query-slot) top-k results to query-major
    order: (n_lists, qcap, k) -> (nq, p*k) (+inf where the pair
    overflowed qcap)."""
    k = vals.shape[-1]
    pm = mem[l_flat, torch.clamp(slot, max=qcap - 1).long()]
    return (regroup_values(vals, l_flat, slot, nq, p, qcap),
            pm.reshape(nq, p * k))


def scatter_pairs(pool, qmat, rmat, out, nq: int, p: int):
    """Scatter one list block's per-(list, query-slot) partials ``out``
    into the query-major (nq, p, w) ``pool`` in place; sentinel slots
    drop."""
    qi, ri = qmat.long(), rmat.long()
    keep = (qi < nq) & (ri < p)
    pool[qi[keep], ri[keep]] = out[keep]


def default_qcap(nq: int, n_probes: int, n_lists: int) -> int:
    """2x the mean per-list probe occupancy, 8-aligned (the grouped
    searches' default static queries-per-list cap)."""
    mean_occ = max(1, (nq * n_probes + n_lists - 1) // n_lists)
    return min(nq, -(-2 * mean_occ // 8) * 8)


def throughput_qcap(nq: int, n_probes: int, n_lists: int) -> int:
    """~0.75x the mean per-list probe occupancy, 8-aligned upward — the
    opt-in throughput cap (``qcap="throughput"``); drops only marginal
    last-rank pairs, but costs recall where hot lists collect top-rank
    probes, so audit it with :func:`probe_drop_stats`."""
    mean_occ = max(1, (nq * n_probes + n_lists - 1) // n_lists)
    return min(nq, max(8, -(-(3 * mean_occ // 4) // 8) * 8))


class _AuditRegistry:
    """(n_lists, n_probes, qcap, nq) signatures whose throughput-mode drop
    fraction has been audited this process, keyed by a weakref to the
    index's centroids tensor (a recycled id of a freed index must not
    skip a new index's audit; dead entries evict themselves)."""

    def __init__(self):
        self._by_id: dict = {}    # id(tensor) -> (weakref, set of sigs)

    def _sigs(self, arr):
        ent = self._by_id.get(id(arr))
        if ent is not None and ent[0]() is arr:
            return ent[1]
        return None

    def seen(self, arr, sig) -> bool:
        sigs = self._sigs(arr)
        return sigs is not None and sig in sigs

    def add(self, arr, sig) -> None:
        sigs = self._sigs(arr)
        if sigs is None:
            key = id(arr)

            def _evict(_, key=key, reg=self._by_id):
                reg.pop(key, None)

            sigs = set()
            self._by_id[key] = (weakref.ref(arr, _evict), sigs)
        sigs.add(sig)


_THROUGHPUT_AUDITED = _AuditRegistry()


def _eager_probe(q, centroids, n_probes: int):
    probes, _ = coarse_probe(q.float(), centroids, n_probes)
    return probes


def resolve_qcap_arg(qcap, q, centroids, n_lists: int, n_probes: int,
                     max_drop_frac=None, coarse=None):
    """qcap argument of the grouped searches: ``None`` -> the recall-safe
    auto path (:func:`auto_qcap`), ``"throughput"`` ->
    :func:`throughput_qcap` (its first call per signature and index
    audits and logs the dropped-pair fraction; ``max_drop_frac`` audits
    every call and falls back to the auto cap above that fraction), an
    int -> as-is. Returns (qcap, probes_or_none)."""
    errors.expects(
        coarse is None,
        "coarse=: the two-level coarse probe is not yet ported",
    )
    if qcap == "throughput":
        nq = q.shape[0]
        qc = throughput_qcap(nq, n_probes, n_lists)
        sig = (n_lists, n_probes, qc, nq)
        if max_drop_frac is None and _THROUGHPUT_AUDITED.seen(centroids,
                                                               sig):
            return qc, None
        probes = _eager_probe(q, centroids, n_probes)
        stats = probe_drop_stats(probes, n_lists, qc)
        _THROUGHPUT_AUDITED.add(centroids, sig)
        if max_drop_frac is not None and stats["frac"] > max_drop_frac:
            qc2 = resolve_qcap(probes, n_lists, nq, n_probes,
                               max_drop_frac=max_drop_frac)
            logger.warning(
                "qcap='throughput' (=%d) would drop %.2f%% of probe "
                "pairs (> max_drop_frac=%.2f%%); falling back to "
                "auto-sized qcap=%d",
                qc, 100.0 * stats["frac"], 100.0 * max_drop_frac, qc2,
            )
            return qc2, probes
        if stats["dropped"]:
            logger.warning(
                "qcap='throughput' (=%d) drops %d/%d probe pairs "
                "(%.2f%%) on this workload; recall dips when hot lists "
                "collect top-rank probes — audit measured recall / "
                "probe_drop_stats, or pass max_drop_frac to bound drops",
                qc, stats["dropped"], stats["total"],
                100.0 * stats["frac"],
            )
        return qc, probes
    if qcap is None:
        return auto_qcap(q, centroids, n_lists, n_probes)
    errors.expects(
        isinstance(qcap, (int, np.integer)) and not isinstance(qcap, bool),
        "qcap must be an int, None, or 'throughput'; got %r", qcap,
    )
    return int(qcap), None


def probe_drop_stats(probes, n_lists: int, qcap: int):
    """Dropped (query, probe) pairs for a probe map under ``qcap``:
    ``max(0, occupancy - qcap)`` per list. Returns {"dropped", "total",
    "frac"}."""
    if isinstance(probes, torch.Tensor):
        probes = probes.cpu().numpy()
    occ = np.bincount(np.asarray(probes).reshape(-1), minlength=n_lists)
    total = int(occ.sum())
    dropped = int(np.maximum(occ - qcap, 0).sum())
    return {"dropped": dropped, "total": total,
            "frac": dropped / max(total, 1)}


def resolve_qcap(probes, n_lists: int, nq: int, n_probes: int,
                 max_drop_frac: float = 0.02) -> int:
    """Auto-size ``qcap`` from the actual probe map: start at the 2x-mean
    default and double (8-aligned) until at most ``max_drop_frac`` of the
    pairs drop (or every query fits); log any residual drop."""
    qcap = default_qcap(nq, n_probes, n_lists)
    while True:
        stats = probe_drop_stats(probes, n_lists, qcap)
        if stats["frac"] <= max_drop_frac or qcap >= nq:
            break
        qcap = min(nq, -(-2 * qcap // 8) * 8)
    if stats["dropped"]:
        logger.warning(
            "grouped search qcap=%d drops %d/%d probe pairs (%.3f%%); "
            "clustered queries overflow hot lists — raise qcap or "
            "max_drop_frac to trade memory for recall",
            qcap, stats["dropped"], stats["total"], 100.0 * stats["frac"],
        )
    return qcap


def auto_qcap(q, centroids, n_lists: int, n_probes: int):
    """qcap=None path: probe eagerly, size qcap from the actual map, and
    hand the probes back for reuse. Returns (qcap, probes)."""
    probes = _eager_probe(q, centroids, n_probes)
    return resolve_qcap(probes, n_lists, q.shape[0], n_probes), probes


def static_qcap(qcap, nq: int, n_probes: int, n_lists: int) -> int:
    """Shape-only qcap resolution for warm-up: ``None`` ->
    :func:`default_qcap`, ``"throughput"`` -> :func:`throughput_qcap`, an
    int -> as-is. Serving passes the returned int on every dispatch."""
    if qcap is None:
        return default_qcap(nq, n_probes, n_lists)
    if qcap == "throughput":
        return throughput_qcap(nq, n_probes, n_lists)
    errors.expects(
        isinstance(qcap, (int, np.integer)) and not isinstance(qcap, bool),
        "qcap must be an int, None, or 'throughput'; got %r", qcap,
    )
    return int(qcap)


def subchunk_pool_rows(pv, c: int, probes, storage: ListStorage,
                       rows_pad: int, l_pad: int, width: int):
    """The kernel engines' pool tail: the top ``c`` of each query's
    (nq, p*width) pool of sub-chunk minima (the 8-row cover argument:
    they hold the top-c rows) and the slab rows they cover, derived from
    (probe slot, chunk) and the block's clamped window origin
    ``min(offset, rows_pad - l_pad)``. A window can overhang its list's
    tail into the next list's rows, so a row is valid only inside its
    probe slot's exact range, and never in a masked sub-chunk. Returns
    (rows (nq, c*8), valid (nq, c*8))."""
    nq = pv.shape[0]
    nadc, cpos = top_k_smallest(pv, c)                        # (nq, c)
    slot_sel = cpos // width
    off_sel = torch.gather(storage.list_offsets.long()[probes], 1, slot_sel)
    end_sel = off_sel + torch.gather(storage.list_sizes.long()[probes], 1,
                                     slot_sel)
    base_sel = (torch.clamp(off_sel, max=rows_pad - l_pad)
                + SUBCHUNK * (cpos % width))                  # (nq, c)
    rows = base_sel[:, :, None] + torch.arange(SUBCHUNK, device=pv.device)
    valid = ((rows >= off_sel[:, :, None]) & (rows < end_sel[:, :, None])
             & (torch.isfinite(nadc) & (nadc < BIG))[:, :, None])
    return rows.reshape(nq, c * SUBCHUNK), valid.reshape(nq, c * SUBCHUNK)


def check_candidate_pool(k: int, n_probes: int, storage: ListStorage):
    if k > n_probes * storage.max_list:
        raise ValueError(
            f"k={k} exceeds the candidate pool "
            f"(n_probes*max_list = {n_probes * storage.max_list}); "
            "raise n_probes"
        )


def split_oversized_lists(labels_np, centroids, cap: int):
    """Split every list longer than ``cap`` into contiguous sublists that
    share the parent's centroid (appended as duplicate centroid rows).
    Host-side (numpy labels); returns (labels, centroids); no-op when
    nothing exceeds the cap."""
    n_lists = centroids.shape[0]
    sizes = np.bincount(labels_np, minlength=n_lists)
    extra = np.maximum(0, -(-sizes // cap) - 1)               # sublists - 1
    if not extra.any():
        return labels_np, centroids
    order = np.argsort(labels_np, kind="stable")
    lbl_sorted = labels_np[order]
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    rank = np.arange(labels_np.shape[0]) - offsets[lbl_sorted]
    sub = rank // cap                                         # 0..extra[l]
    base = n_lists + np.concatenate([[0], np.cumsum(extra)[:-1]])
    new_sorted = np.where(
        sub == 0, lbl_sorted, base[lbl_sorted] + sub - 1
    ).astype(labels_np.dtype)
    out = np.empty_like(labels_np)
    out[order] = new_sorted
    dup = torch.as_tensor(np.repeat(np.arange(n_lists), extra),
                          device=centroids.device)
    return out, torch.cat([centroids, centroids[dup]])


def build_list_storage(assignments, n_lists: int, device) -> ListStorage:
    """Host-side build of the sorted-by-list layout from (n,) list
    assignments; the tensors land on ``device``."""
    a = np.asarray(assignments)
    n = a.shape[0]
    order = np.argsort(a, kind="stable").astype(np.int32)
    sizes = np.bincount(a, minlength=n_lists).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    max_list = max(int(sizes.max()), 1)
    list_index = np.full((n_lists, max_list), n, np.int32)
    a_sorted = a[order]
    rank = np.arange(n) - offsets[a_sorted]
    list_index[a_sorted, rank] = np.arange(n, dtype=np.int32)
    return ListStorage(
        torch.as_tensor(order, device=device),
        torch.as_tensor(offsets, device=device),
        torch.as_tensor(list_index, device=device),
        torch.as_tensor(sizes, device=device),
        n,
        max_list,
    )


def warn_engine_fallback(warned: set, engine: str, reason: str) -> None:
    """Warn once per ``reason`` (tracked in the caller's ``warned`` set)
    that a grouped ``engine`` search of a CUDA index left its CUDA kernel
    for the legacy plain-PyTorch scan; the caller counts every such
    search in its module's ``ENGINE_FALLBACKS``."""
    if reason not in warned:
        warned.add(reason)
        logger.warning(
            "%s grouped search of a CUDA index runs the legacy "
            "plain-PyTorch scan, not the CUDA kernel: %s (use_kernel=False "
            "chooses it without this warning)", engine, reason)
