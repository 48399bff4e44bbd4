"""Online index mutation — the port of ``raft_tpu/spatial/ann/mutation.py``:
upsert / delete / streaming ingest for the IVF engines.

* **Delta segments** — every list owns a ``(cap,)`` padded delta segment
  with a fixed capacity (:class:`DeltaStore`). An upsert is one scatter
  into the assigned list's segment on the index's device, visible to the
  very next search: the delta is scanned densely (it is small by
  construction), so a fresh row is visible whatever the probe map.
* **Tombstone deletion** — a ``(n + 1,)`` live mask over the main slab's
  positions, folded into the grouped scans (``row_mask=`` of the one
  grouped body, :func:`~.grouped.search`): a delete flips one entry;
  the row scores +inf and never surfaces. The kernel engines apply it
  per row at their exact rerank tail, outside the kernel, as the JAX
  package does.
* **Compaction** — :func:`compact` merges deltas and tombstones into
  fresh main slabs (optionally refreshing the centroids by k-means
  warm-started from the current ones, with the :func:`probe_overlap`
  drift guard); :class:`BackgroundCompactor` runs it on a thread and a
  CUDA stream of its own while searches go on on the old state.
* **Incremental checkpoints** — :func:`save_delta_checkpoint` /
  :func:`apply_delta_checkpoint` write and splice only dirty lists'
  delta segments (format ``mutation-delta`` v4, the JAX package's bytes);
  the full v4 ``mutable_ivf`` archive is
  :func:`~raft_tpu_torch.spatial.ann.interop.save_index`'s.

Every state is functional: an operation returns fresh tensors and leaves
its input state serving. State tensors live on the wrapped index's
device; the host-side bookkeeping (dirty lists, epoch, epoch journal)
is Python and numpy, as in the reference. ``mutable_search`` and
``_upsert_impl`` make no host sync; ``upsert`` and ``delete`` make one
small copy to the host for their acks.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import typing

import numpy as np
import torch

from raft_tpu_torch import errors
from raft_tpu_torch.analysis.threads import runtime as lockcheck
from raft_tpu_torch.cluster.kmeans import (
    KMeansParams,
    canonical_lists,
    kmeans_fit,
    kmeans_predict,
)
from raft_tpu_torch.core.device import as_tensor, full_f32
from raft_tpu_torch.obs import crash as obs_crash
from raft_tpu_torch.obs import metrics as obs_metrics
from raft_tpu_torch.spatial.ann.common import (
    ListStorage,
    as_queries,
    build_list_storage,
    coarse_probe,
    map_query_blocks,
    static_qcap,
)
from raft_tpu_torch.spatial.ann import grouped
from raft_tpu_torch.spatial.ann.ivf_flat import IVFFlatIndex, _sqrt
from raft_tpu_torch.spatial.ann.ivf_pq import (
    IVFPQIndex,
    PQEngine,
    _encode_rows,
)
from raft_tpu_torch.spatial.ann.ivf_sq import (
    IVFSQIndex,
    SQEngine,
    sq_decode,
    sq_encode,
)
from raft_tpu_torch.spatial.selection import top_k_smallest

__all__ = [
    "DeltaStore",
    "MutableIndex",
    "CompactionPolicy",
    "BackgroundCompactor",
    "apply_delta_checkpoint",
    "compact",
    "compaction_stats",
    "delete",
    "delta_checkpoint_watermark",
    "delta_merge_topk",
    "lists_changed_since",
    "mutable_search",
    "mutable_warmup",
    "probe_overlap",
    "save_delta_checkpoint",
    "upsert",
    "wrap_mutable",
]


# mutation-tier telemetry: host-wall durations of the three ops (upsert
# and delete include their ack copy) and the delta-fill / tombstone
# gauges compaction decisions read, each labelled ``index=<name>`` and
# cached per name.
_mseries_cache: dict = {}
_mseries_lock = lockcheck.make_lock("mutation._mseries_lock")


def _mseries(index_name: str) -> dict:
    s = _mseries_cache.get(index_name)
    if s is not None:
        return s
    reg = obs_metrics.default_registry()
    with _mseries_lock:
        if index_name not in _mseries_cache:
            _mseries_cache[index_name] = {
                "op_ms": {
                    op: reg.histogram("mutation_op_ms",
                                      index=index_name, op=op)
                    for op in ("upsert", "delete", "compact")
                },
                "rows": {
                    key: reg.counter("mutation_rows_total",
                                     index=index_name, op=op, result=res)
                    for key, (op, res) in {
                        "accepted": ("upsert", "accepted"),
                        "rejected": ("upsert", "rejected"),
                        "deleted": ("delete", "found"),
                        "missing": ("delete", "missing"),
                    }.items()
                },
                "compactions": reg.counter("mutation_compactions_total",
                                           index=index_name),
                "journal_compacted": reg.counter(
                    "mutation_journal_compacted_total",
                    index=index_name),
                "fill": reg.gauge("mutation_delta_fill",
                                  index=index_name),
                "max_fill": reg.gauge("mutation_delta_max_fill",
                                      index=index_name),
                "tombstone": reg.gauge("mutation_tombstone_frac",
                                       index=index_name),
            }
        return _mseries_cache[index_name]


@dataclasses.dataclass
class DeltaStore:
    """Per-list delta segments of fixed capacity ``cap``.

    ``counts[l]``: rows APPENDED to list ``l``'s segment (a deleted or
    superseded delta row keeps its slot until compaction). ``ids``: the
    caller's global row ids (-1 = empty slot); ``live`` drops to 0 when a
    delta row is deleted or superseded. A full segment rejects further
    upserts (the accepted mask says so)."""

    vecs: torch.Tensor    # (n_lists, cap, d) f32
    ids: torch.Tensor     # (n_lists, cap) int32, -1 = empty
    live: torch.Tensor    # (n_lists, cap) int8
    counts: torch.Tensor  # (n_lists,) int32
    cap: int


@dataclasses.dataclass
class MutableIndex:
    """A frozen IVF index plus its mutation state.

    ``row_mask``: (n + 1,) int8 live mask over main-slab positions.
    ``id_to_pos``: (id_span,) int32 map from a global row id to its
    main-slab position (-1 = not in the main slab). The host-side
    bookkeeping set in ``__post_init__`` — ``dirty_lists`` (lists whose
    delta segment changed since the last checkpoint), ``name`` (the
    ``index=`` telemetry label), ``epoch`` (bumped by every applied
    upsert/delete batch and by compaction: the result cache's
    invalidation input) and the bounded epoch journal read by
    :func:`lists_changed_since` — is never serialized.

    ``canon``: the routing table of every write,
    :func:`~raft_tpu_torch.cluster.kmeans.canonical_lists` of the
    centroids — derived once when the index is formed (carried by
    ``dataclasses.replace``) and never serialized."""

    index: typing.Union[IVFFlatIndex, IVFPQIndex, IVFSQIndex]
    delta: DeltaStore
    row_mask: torch.Tensor   # (n + 1,) int8 live mask
    id_to_pos: torch.Tensor  # (id_span,) int32, -1 = absent
    canon: typing.Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.canon is None:
            self.canon = canonical_lists(self.index.centroids)
        self.dirty_lists: set = set()
        self.name: str = "mutable"
        self.epoch: int = 0
        self._epoch_journal: list = []
        self._journal_floor: int = 0
        self.flight = None

    @property
    def n_lists(self) -> int:
        return self.index.centroids.shape[0]

    @property
    def engine(self) -> str:
        if isinstance(self.index, IVFPQIndex):
            return "pq"
        if isinstance(self.index, IVFSQIndex):
            return "sq"
        return "flat"


def _with(mindex: MutableIndex, **kw) -> MutableIndex:
    """``dataclasses.replace`` that keeps the host-side dirty set, label,
    epoch, journal and flight recorder (``__post_init__`` would reset
    them; the mutation ops bump the epoch after this)."""
    out = dataclasses.replace(mindex, **kw)
    out.dirty_lists = set(mindex.dirty_lists)
    out.name = mindex.name
    out.epoch = mindex.epoch
    out._epoch_journal = list(mindex._epoch_journal)
    out._journal_floor = mindex._journal_floor
    out.flight = mindex.flight
    return out


_EPOCH_JOURNAL_CAP = 1024


def _journal_note(mindex: MutableIndex, changed) -> None:
    """Append one epoch-journal entry for ``mindex.epoch`` (call after
    the bump). ``changed``: the list ids whose serving state the write
    touched, or None = everything (compaction). Bounded at
    ``_EPOCH_JOURNAL_CAP``; dropped entries raise the floor below which
    :func:`lists_changed_since` answers None."""
    j = mindex._epoch_journal
    j.append((mindex.epoch,
              None if changed is None else frozenset(changed)))
    if len(j) > _EPOCH_JOURNAL_CAP:
        drop = len(j) - _EPOCH_JOURNAL_CAP
        mindex._journal_floor = j[drop - 1][0]
        del j[:drop]
        _mseries(mindex.name)["journal_compacted"].inc(drop)
        if mindex.flight is not None:
            mindex.flight.record(
                "mutation_journal_compacted", index=mindex.name,
                dropped=drop, floor=mindex._journal_floor,
                epoch=mindex.epoch)


def lists_changed_since(mindex: MutableIndex, epoch: int):
    """The list ids whose serving state changed in epochs ``(epoch,
    mindex.epoch]``, or None for "assume everything" (a compaction in
    the window, or a window older than the bounded journal). May
    over-approximate, never under-reports."""
    if epoch >= mindex.epoch:
        return set()
    if epoch < mindex._journal_floor:
        return None
    out: set = set()
    for e, changed in mindex._epoch_journal:
        if e <= epoch:
            continue
        if changed is None:
            return None
        out |= changed
    return out


def _main_slab_lists(mindex: MutableIndex, ids):
    """On the device: the list owning each id's MAIN-slab row (-1 when
    the id has none), whether or not that row is still live — the
    row_mask side of an epoch-journal entry. The reference returns the
    set of those lists from a host copy of its own; here the lists ride
    the ack's one copy."""
    span = mindex.id_to_pos.shape[0]
    inb = (ids >= 0) & (ids < span)
    pos = torch.where(
        inb, mindex.id_to_pos[torch.clamp(ids, 0, span - 1).long()], -1)
    offs = mindex.index.storage.list_offsets
    lists = torch.searchsorted(offs, pos.to(offs.dtype), right=True) - 1
    return torch.where(pos >= 0, lists, -1)


def wrap_mutable(index, *, delta_cap: int = 32,
                 name: str = "mutable") -> MutableIndex:
    """Wrap a frozen :class:`IVFFlatIndex` / :class:`IVFPQIndex` /
    :class:`IVFSQIndex` for online mutation: one inverse-permutation pass
    over ``sorted_ids`` on the host, the index's tensors aliased, the
    mutation state placed on the index's device. SQ delta rows stay
    exact f32 until compaction quantizes them.

    ``delta_cap``: per-list delta capacity; upserts into a full segment
    are rejected until compaction drains it. ``name``: the ``index=``
    label of this index's ``mutation_*`` series."""
    errors.expects(
        isinstance(index, (IVFFlatIndex, IVFPQIndex, IVFSQIndex)),
        "wrap_mutable: expected an IVFFlatIndex, IVFPQIndex, or "
        "IVFSQIndex, got %s",
        type(index).__name__,
    )
    errors.expects(delta_cap >= 1, "delta_cap=%d < 1", delta_cap)
    storage = index.storage
    dev = index.device
    n = storage.n
    d = index.centroids.shape[1]
    nl = index.centroids.shape[0]
    sids = storage.sorted_ids.cpu().numpy()
    valid = sids >= 0
    span = int(sids[valid].max()) + 1 if valid.any() else 1
    # the id -> position map is dense over [0, max_id]: ids must stay
    # dense-ish, or its memory scales with the largest id
    errors.expects(
        span <= max(1 << 22, 16 * max(n, 1)),
        "wrap_mutable: max global id %d is far beyond the row count %d "
        "— the id->pos map is dense over [0, max_id]; use dense-ish ids",
        span - 1, n,
    )
    id_to_pos = np.full(span, -1, np.int32)
    id_to_pos[sids[valid]] = np.nonzero(valid)[0].astype(np.int32)
    delta = DeltaStore(
        vecs=torch.zeros((nl, delta_cap, d), dtype=torch.float32,
                         device=dev),
        ids=torch.full((nl, delta_cap), -1, dtype=torch.int32, device=dev),
        live=torch.zeros((nl, delta_cap), dtype=torch.int8, device=dev),
        counts=torch.zeros((nl,), dtype=torch.int32, device=dev),
        cap=int(delta_cap),
    )
    out = MutableIndex(
        index=index,
        delta=delta,
        row_mask=torch.ones((n + 1,), dtype=torch.int8, device=dev),
        id_to_pos=torch.as_tensor(id_to_pos, device=dev),
    )
    out.name = str(name)
    return out


# ------------------------------------------------------------- mutation ops
def _put_dropping(base, index, values):
    """``base`` with ``base[index[i]] = values[i]`` along dim 0, where
    ``index[i] == base.shape[0]`` drops the write (JAX's
    ``.at[].set(mode="drop")``): the write lands in one extra dump row
    that is sliced off. Callers keep every other target unique or the
    written values equal, so the unordered CUDA ``index_put_`` is
    deterministic."""
    n = base.shape[0]
    out = torch.cat([base, base.new_zeros((1,) + tuple(base.shape[1:]))])
    if not isinstance(values, torch.Tensor):
        # a fill on the device, not a copy of a host scalar
        values = torch.full((), values, dtype=base.dtype, device=base.device)
    out[index] = values
    return out[:n]


def _member(values, pool):
    """Whether each entry of the 1-d ``values`` occurs in the 1-d
    ``pool``: a sort and a binary search on the device, no host sync, and
    memory linear in both (the reference's (n_lists, cap, B) match tensor
    would be gigabytes for a large delete batch)."""
    if pool.numel() == 0:
        return torch.zeros(values.shape, dtype=torch.bool,
                           device=values.device)
    sp, _ = torch.sort(pool)
    pos = torch.clamp(torch.searchsorted(sp, values), max=sp.numel() - 1)
    return sp[pos] == values


def _upsert_impl(centroids, delta, row_mask, id_to_pos, vecs, ids, canon):
    """Upsert a (B, d) batch on the device, with no host sync: assign each
    row to its nearest centroid (``canon``, the index's
    :func:`~raft_tpu_torch.cluster.kmeans.canonical_lists` table, sends
    it to the lowest list sharing that centroid), decide acceptance
    first, then — for
    accepted rows only — tombstone the previous copy (main slab through
    ``id_to_pos``, delta by id match) and append into the lists' delta
    segments. A rejected row is a strict no-op: its previous copy keeps
    serving. Returns ``(delta, row_mask, accepted, lbl, dirty_sup)``;
    ``dirty_sup`` (n_lists,) marks lists whose existing live delta copy
    was superseded."""
    n_lists = centroids.shape[0]
    cap = delta.cap
    dev = centroids.device
    b = ids.shape[0]
    d = delta.vecs.shape[2]
    lbl = canon[kmeans_predict(vecs.float(), centroids).long()]

    # 1) acceptance: slot = current count + within-batch rank among
    # same-list rows (stable sort + searchsorted), capped by the capacity
    order = torch.argsort(lbl, stable=True)
    ls = lbl[order]
    starts = torch.searchsorted(ls, torch.arange(n_lists, device=dev))
    within = torch.empty_like(lbl)
    within[order] = torch.arange(b, device=dev) - starts[ls]
    slot = delta.counts[lbl].long() + within
    accepted = (slot < cap) & (ids >= 0)
    ok_ids = torch.where(accepted, ids, -1)

    # 2) tombstone the previous MAIN copy of each accepted id
    span = id_to_pos.shape[0]
    inr = (ok_ids >= 0) & (ok_ids < span)
    pos = torch.where(
        inr, id_to_pos[torch.clamp(ok_ids, 0, span - 1).long()], -1)
    n_mask = row_mask.shape[0]
    row_mask = _put_dropping(
        row_mask, torch.where(pos >= 0, pos, n_mask).long(), 0)

    # 3) supersede matching EXISTING delta entries of accepted ids
    superseded = (_member(delta.ids.reshape(-1), ok_ids).reshape(
        n_lists, cap) & (delta.ids >= 0))
    dirty_sup = (superseded & (delta.live > 0)).any(dim=1)   # (n_lists,)
    live = torch.where(superseded, 0, delta.live).to(delta.live.dtype)

    # 4) append accepted rows; the targets (list, slot) of accepted rows
    # are distinct, rejected rows go to the dump row
    tgt = torch.where(accepted, lbl * cap + slot, n_lists * cap)
    new = DeltaStore(
        vecs=_put_dropping(delta.vecs.reshape(n_lists * cap, d), tgt,
                           vecs.to(delta.vecs.dtype)).reshape(
                               n_lists, cap, d),
        ids=_put_dropping(delta.ids.reshape(-1), tgt,
                          ids.to(delta.ids.dtype)).reshape(n_lists, cap),
        live=_put_dropping(live.reshape(-1), tgt, 1).reshape(n_lists, cap),
        counts=delta.counts.clone().index_add_(
            0, lbl, accepted.to(delta.counts.dtype)),
        cap=delta.cap,
    )
    return new, row_mask, accepted, lbl, dirty_sup


def _delete_impl(delta, row_mask, id_to_pos, ids):
    """Tombstone-delete a (B,) id batch on the device: flip the main-slab
    mask entry and kill matching live delta entries. Returns the new
    state, ``found`` (the id was live somewhere) and a per-list dirty
    flag."""
    span = id_to_pos.shape[0]
    n_mask = row_mask.shape[0]
    inr = (ids >= 0) & (ids < span)
    pos = torch.where(
        inr, id_to_pos[torch.clamp(ids, 0, span - 1).long()], -1)
    safe = torch.clamp(pos, 0, n_mask - 1).long()
    main_found = (pos >= 0) & (row_mask[safe] > 0)
    row_mask = _put_dropping(
        row_mask, torch.where(pos >= 0, pos, n_mask).long(), 0)

    live_ids = torch.where(delta.live > 0, delta.ids, -1)
    hit = (_member(delta.ids.reshape(-1), ids).reshape(delta.ids.shape)
           & (live_ids >= 0))                                 # (n_lists, cap)
    delta_found = _member(ids, live_ids.reshape(-1)) & (ids >= 0)   # (B,)
    dirty = hit.any(dim=1)                                    # (n_lists,)
    live = torch.where(hit, 0, delta.live).to(delta.live.dtype)
    return (
        dataclasses.replace(delta, live=live),
        row_mask,
        main_found | delta_found,
        dirty,
    )


def _host_writable(a):
    # torch wants writable memory (a replayed WAL payload is read-only)
    if isinstance(a, np.ndarray) and not a.flags.writeable:
        return a.copy()
    return a


def _as_ids(mindex: MutableIndex, ids):
    return torch.as_tensor(_host_writable(ids),
                           device=mindex.index.device).to(torch.int32)


def upsert(mindex: MutableIndex, vectors, ids):
    """Upsert a batch of rows. Returns ``(new_mindex, accepted)`` with
    ``accepted`` a host (B,) bool array — True is the ack: the row is in
    its list's delta segment and visible to the next search. False: the
    list's segment is full (compact, then retry) or the id is negative;
    a rejection is a strict no-op. A row whose id exists (main slab or
    delta) supersedes the old copy in the same dispatch. Ids must be
    unique within one batch. The ack is one small copy to the host."""
    vecs = as_tensor(_host_writable(vectors), mindex.index.device)
    idarr = _as_ids(mindex, ids)
    errors.check_matrix(vecs, "vectors")
    errors.check_same_cols(vecs, mindex.index.centroids, "vectors", "index")
    errors.expects(
        tuple(idarr.shape) == (vecs.shape[0],),
        "ids: expected shape (%d,), got %s", vecs.shape[0],
        tuple(idarr.shape),
    )
    b = vecs.shape[0]
    t0 = time.perf_counter()
    delta, row_mask, accepted, lbl, dirty_sup = _upsert_impl(
        mindex.index.centroids, mindex.delta, mindex.row_mask,
        mindex.id_to_pos, vecs, idarr, mindex.canon,
    )
    # the ack: one copy of accepted, labels, the main-slab lists of the
    # accepted ids and the superseded lists
    host = torch.cat([
        accepted.to(torch.int64), lbl,
        _main_slab_lists(mindex, torch.where(accepted, idarr, -1)),
        dirty_sup.to(torch.int64),
    ]).cpu().numpy()
    accepted_np = host[:b].astype(bool)
    lbl_np = host[b:2 * b]
    main_np = host[2 * b:3 * b]
    sup_lists = np.nonzero(host[3 * b:])[0].tolist()
    ms = _mseries(mindex.name)
    ms["op_ms"]["upsert"].observe((time.perf_counter() - t0) * 1e3)
    n_acc = int(accepted_np.sum())
    ms["rows"]["accepted"].inc(n_acc)
    ms["rows"]["rejected"].inc(int(accepted_np.size) - n_acc)
    out = _with(mindex, delta=delta, row_mask=row_mask)
    out.dirty_lists.update(lbl_np[accepted_np].tolist())
    # a superseded delta copy dirties its list too — an incremental
    # checkpoint that missed it would resurrect the stale copy
    out.dirty_lists.update(sup_lists)
    if n_acc:
        # an applied write bumps the epoch (cached results go stale); an
        # all-rejected batch changed nothing
        out.epoch = mindex.epoch + 1
        changed = set(lbl_np[accepted_np].tolist()) | set(sup_lists)
        changed |= set(main_np[main_np >= 0].tolist())
        _journal_note(out, changed)
    return out, accepted_np


def delete(mindex: MutableIndex, ids):
    """Tombstone-delete a batch of ids. Returns ``(new_mindex, found)``;
    ``found[i]`` is True when the id was live (main slab or delta). The
    ack is one small copy to the host."""
    idarr = _as_ids(mindex, ids)
    errors.expects(
        idarr.dim() == 1, "ids: expected a 1-d batch, got shape %s",
        tuple(idarr.shape),
    )
    b = idarr.shape[0]
    t0 = time.perf_counter()
    delta, row_mask, found, dirty = _delete_impl(
        mindex.delta, mindex.row_mask, mindex.id_to_pos, idarr
    )
    host = torch.cat([
        found.to(torch.int64), _main_slab_lists(mindex, idarr),
        dirty.to(torch.int64),
    ]).cpu().numpy()
    found_np = host[:b].astype(bool)
    main_np = host[b:2 * b]
    dirty_lists = np.nonzero(host[2 * b:])[0].tolist()
    out = _with(mindex, delta=delta, row_mask=row_mask)
    out.dirty_lists.update(dirty_lists)
    if bool(found_np.any()):
        out.epoch = mindex.epoch + 1
        changed = set(dirty_lists) | set(main_np[main_np >= 0].tolist())
        _journal_note(out, changed)
    ms = _mseries(mindex.name)
    ms["op_ms"]["delete"].observe((time.perf_counter() - t0) * 1e3)
    n_found = int(found_np.sum())
    ms["rows"]["deleted"].inc(n_found)
    ms["rows"]["missing"].inc(int(found_np.size) - n_found)
    return out, found_np


# --------------------------------------------------------------- search
# bytes of one query block's dense (block, delta rows) f32 distance tile
_DELTA_BLOCK_BYTES = 256 << 20


@full_f32
def delta_merge_topk(qf, vals, ids, dvec, dids, valid, k: int):
    """The exact dense delta scan and fold of every mutable search: score
    the flattened (DL, d) delta rows in full f32 (``torch.matmul``, TF32
    off), mask by ``valid``, and fold their top-k into the (nq, k)
    candidates ``(vals, ids)``. Query blocks bound the (block, DL)
    distance tile; each block's result is what the whole batch would
    give for its rows."""
    dv = dvec.float()
    vn = torch.sum(dv * dv, dim=1)
    kd = min(k, dids.shape[0])
    inf = float("inf")  # a Python scalar: no host-to-device copy

    def block(args):
        qb, vb, ib = args
        qn = torch.sum(qb * qb, dim=1)
        dots = qb @ dv.T
        d2 = torch.where(valid[None, :],
                         qn[:, None] + vn[None, :] - 2.0 * dots, inf)
        dvals, dp = top_k_smallest(d2, kd)
        dsel = torch.where(torch.isfinite(dvals), dids[dp],
                           -1).to(ib.dtype)
        fv, fp = top_k_smallest(torch.cat([vb, dvals], dim=1), k)
        fi = torch.gather(torch.cat([ib, dsel], dim=1), 1, fp)
        return fv, fi

    block_q = max(1, _DELTA_BLOCK_BYTES // (4 * max(dids.shape[0], 1)))
    return map_query_blocks(block, (qf, vals, ids), block_q)


# the grouped engine of each kind of frozen index
_ENGINES = {"flat": grouped.FlatEngine, "sq": SQEngine, "pq": PQEngine}


def _mut_search_impl(engine, delta, row_mask, q, k, n_probes, qcap,
                     list_block):
    qf = q.float()
    mv, mi = grouped.search(engine, qf, k, n_probes, qcap, list_block,
                            row_mask=row_mask)
    # dense exact scan of the delta segments: every fresh row is visible
    # whatever the probe map
    nl, cap, d = delta.vecs.shape
    dids = delta.ids.reshape(nl * cap)
    valid = (dids >= 0) & (delta.live.reshape(nl * cap) > 0)
    return delta_merge_topk(qf, mv, mi, delta.vecs.reshape(nl * cap, d),
                            dids, valid, k)


def mutable_search(
    mindex: MutableIndex, queries, k: int, *, n_probes: int = 8,
    qcap: typing.Union[int, str, None] = None,
    list_block: typing.Optional[int] = None,
    refine_ratio: float = 2.0, exact_selection: bool = False,
    approx_recall_target: float = 0.95,
    use_kernel: typing.Optional[bool] = None,
):
    """Grouped search over a mutable index: the frozen engine's grouped
    scan with the tombstone mask folded in, merged with a dense exact
    scan of the delta segments. Returns what the engine's own grouped
    search returns (IVF-Flat takes the root for ``metric='l2'``, through
    f64; IVF-SQ and IVF-PQ return squared distances).

    ``qcap`` resolves from shapes only (:func:`~.common.static_qcap`), so
    a dispatch makes no host sync. ``use_kernel`` selects the scan engine
    of all three kinds by the one rule (:func:`~.grouped.resolve_kernel`;
    the JAX package's ``use_pallas``): ``None`` runs the CUDA kernel on a
    Hopper card when it fits (a CUDA index it cannot serve is counted in
    ``grouped.ENGINE_FALLBACKS`` under its kind), ``True`` launches it or
    raises, ``False`` pins the legacy scan. The kernel engines apply the
    tombstones per row at their exact rerank tail — a dead row can crowd
    a pool slot, never surface."""
    index = mindex.index
    q = as_queries(queries, index.centroids)
    engine = mindex.engine
    storage = index.storage
    errors.expects(
        k <= n_probes * storage.max_list,
        "k=%d exceeds the candidate pool (n_probes*max_list=%d)",
        k, n_probes * storage.max_list,
    )
    errors.expects(
        0.0 < approx_recall_target <= 1.0,
        "approx_recall_target=%s out of range (0, 1]", approx_recall_target,
    )
    nl = index.centroids.shape[0]
    qc = static_qcap(qcap, q.shape[0], n_probes, nl)
    lb = list_block if list_block is not None else (8 if engine == "pq"
                                                   else 32)
    lb = max(1, min(lb, nl))
    # the flat and SQ kernels rerank at their default ratio
    ratio = refine_ratio if engine == "pq" else 4.0
    vals, ids = _mut_search_impl(
        _ENGINES[engine].of(index, use_kernel, qc, ratio), mindex.delta,
        mindex.row_mask, q, k, n_probes, qc, lb,
    )
    if engine == "flat" and index.metric == "l2":
        vals = _sqrt(vals)
    return vals, ids


def mutable_warmup(mindex: MutableIndex, nq: int, *, k: int = 10,
                   n_probes: int = 8, qcap=None,
                   ingest_batch: int = 0, **search_kw) -> int:
    """Warm the mutable serving path for (nq, d) batches (the mutation
    sibling of ``index.warmup(nq)``): one all-zeros search batch and,
    with ``ingest_batch`` > 0, one all-rejected upsert and one no-op
    delete of that size, so the first real traffic pays no kernel build
    or library initialisation. Consumes no delta slot. Returns the
    shape-only qcap to pass on every serving dispatch."""
    index = mindex.index
    d = index.centroids.shape[1]
    dev = index.device
    qc = static_qcap(qcap, nq, n_probes, mindex.n_lists)
    mutable_search(
        mindex, torch.zeros((nq, d), dtype=torch.float32, device=dev), k,
        n_probes=n_probes, qcap=qc, **search_kw,
    )
    if ingest_batch > 0:
        # ids = -1: the dispatch runs in full but accepts nothing
        z = torch.zeros((ingest_batch, d), dtype=torch.float32, device=dev)
        neg = torch.full((ingest_batch,), -1, dtype=torch.int32, device=dev)
        _upsert_impl(index.centroids, mindex.delta, mindex.row_mask,
                     mindex.id_to_pos, z, neg, mindex.canon)
        _delete_impl(mindex.delta, mindex.row_mask, mindex.id_to_pos, neg)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return qc


# ----------------------------------------------------------- compaction
def compaction_stats(mindex: MutableIndex) -> dict:
    """Mutation-pressure stats, copying only the small bookkeeping
    arrays to the host: delta fill fractions, live delta rows, and the
    tombstoned fraction of the main slab. Refreshes the pressure
    gauges."""
    delta = mindex.delta
    counts = delta.counts.cpu().numpy()
    live = ((delta.live > 0) & (delta.ids >= 0)).cpu().numpy()
    sids = mindex.index.storage.sorted_ids
    real = sids >= 0
    n_real = max(int(real.sum()), 1)
    rm = mindex.row_mask[: sids.shape[0]] > 0
    dead = int((real & ~rm).sum())
    out = {
        "delta_fill": float(counts.sum() / max(counts.size * delta.cap, 1)),
        "delta_max_fill": float(counts.max() / delta.cap)
        if counts.size else 0.0,
        "delta_live_rows": int(live.sum()),
        "tombstone_frac": dead / n_real,
        "main_rows": n_real,
    }
    ms = _mseries(mindex.name)
    ms["fill"].set(out["delta_fill"])
    ms["max_fill"].set(out["delta_max_fill"])
    ms["tombstone"].set(out["tombstone_frac"])
    return out


@dataclasses.dataclass(frozen=True)
class CompactionPolicy:
    """When to fold the mutation state back into the main slabs: any
    list's delta segment past ``max_fill_frac`` of its capacity, or the
    tombstoned fraction past ``max_tombstone_frac``. ``refresh_every``:
    the warm-started centroid refresh on every N-th compaction (0 =
    never)."""

    max_fill_frac: float = 0.5
    max_tombstone_frac: float = 0.25
    refresh_every: int = 4

    def should_compact(self, stats: dict) -> bool:
        return (
            stats["delta_max_fill"] >= self.max_fill_frac
            or stats["tombstone_frac"] >= self.max_tombstone_frac
        )


def probe_overlap(old_centroids, new_centroids, queries,
                  n_probes: int = 8) -> float:
    """The centroid-refresh drift guard: mean per-query fraction of
    probed centroid positions shared by the old and refreshed centroid
    sets on ``queries`` (an audit with a host copy, not a serving call).
    Runs on the device of the first tensor argument."""
    dev = next((a.device for a in (old_centroids, new_centroids, queries)
                if isinstance(a, torch.Tensor)), None)
    dev = torch.device("cuda") if dev is None else dev
    def put(a):
        return as_tensor(_host_writable(a), dev).float()

    qf = put(queries)
    a, _ = coarse_probe(qf, put(old_centroids), n_probes)
    b, _ = coarse_probe(qf, put(new_centroids), n_probes)
    a, b = a.cpu().numpy(), b.cpu().numpy()
    hits = sum(
        len(set(x.tolist()) & set(y.tolist())) for x, y in zip(a, b)
    )
    return hits / a.size


def _padded_storage(labels_np, gids, n_lists, list_bucket, row_bucket,
                    device):
    """A :class:`ListStorage` whose ``max_list`` and slab height round up
    to ``list_bucket`` / ``row_bucket`` multiples, so a steady-state
    compact -> ingest -> compact cycle usually keeps the same shapes.
    Returns (storage, order (positions into the input), n_real)."""
    base = build_list_storage(labels_np, n_lists, "cpu")
    n_real = labels_np.shape[0]
    ml = -(-max(int(base.max_list), 1) // list_bucket) * list_bucket
    nb = -(-max(n_real, 1) // row_bucket) * row_bucket
    sizes = base.list_sizes.numpy()
    offsets = base.list_offsets.numpy()
    order = base.sorted_ids.numpy()
    a_sorted = np.asarray(labels_np)[order]
    list_index = np.full((n_lists, ml), nb, np.int32)
    list_index[a_sorted, np.arange(n_real) - offsets[a_sorted]] = np.arange(
        n_real, dtype=np.int32)
    sorted_gids = np.concatenate(
        [gids[order], np.full(nb - n_real, -1, np.int32)]
    ).astype(np.int32)
    storage = ListStorage(
        torch.as_tensor(sorted_gids, device=device),
        torch.as_tensor(offsets, device=device),
        torch.as_tensor(list_index, device=device),
        torch.as_tensor(sizes, device=device),
        int(nb),
        int(ml),
    )
    return storage, order, n_real


def compact(
    mindex: MutableIndex, *, refresh_centroids: bool = False,
    kmeans_n_iters: int = 4, drift_queries=None, n_probes: int = 8,
    min_probe_overlap: float = 0.5, list_bucket: int = 64,
    row_bucket: int = 256,
):
    """Merge delta segments and drop tombstoned rows into fresh main
    slabs on the index's device (the storage layout is built on the
    host, like every index build). Returns ``(new_mindex, stats)``: empty
    deltas, an all-live mask, every surviving row under its (possibly
    refreshed) list with its global id kept.

    ``refresh_centroids=True`` re-fits the coarse quantizer by k-means
    (bf16-operand updates) warm-started from the current centroids; with
    ``drift_queries`` the :func:`probe_overlap` guard requires at least
    ``min_probe_overlap``. SQ survivors keep their codes verbatim (only
    delta rows are quantized, against the kept stats); PQ keeps its
    codebooks and re-encodes its survivors from the stored raw rows.
    ``list_bucket`` / ``row_bucket`` coarsen ``max_list`` and the slab
    height. The epoch continues the input's chain (+1) and the journal
    records "everything changed"."""
    t_compact0 = time.perf_counter()
    index = mindex.index
    engine = mindex.engine
    storage = index.storage
    dev = index.device
    d = index.centroids.shape[1]
    sids = storage.sorted_ids
    rm = mindex.row_mask[: sids.shape[0]] > 0
    keep = torch.nonzero(rm & (sids >= 0)).squeeze(1)
    codes_keep = None
    if engine == "flat":
        base_rows = index.data_sorted[keep]
    elif engine == "sq":
        # survivors keep their stored codes verbatim (decode -> re-encode
        # could move a code unit); decoded rows serve only assignment
        codes_keep = index.codes_sorted[keep]
        base_rows = sq_decode(codes_keep.float(), index.vmin, index.vscale)
    else:
        errors.expects(
            index.vectors_sorted is not None,
            "compact: a codes-only IVF-PQ index cannot be compacted — "
            "survivor rows must be re-encoded from raw vectors "
            "(build with store_raw=True)",
        )
        base_rows = index.vectors_sorted[keep]
    ids_main = sids[keep]
    delta = mindex.delta
    dlive = (delta.live > 0) & (delta.ids >= 0)
    dvecs = delta.vecs[dlive]
    x = torch.cat([base_rows.float(), dvecs.float()])
    gids = torch.cat([ids_main, delta.ids[dlive]]).to(torch.int32)
    errors.expects(
        x.shape[0] >= 1,
        "compact: no rows survive (everything tombstoned) — an empty "
        "index cannot be compacted; rebuild instead",
    )
    cents_old = index.centroids.float()
    stats = dict(compaction_stats(mindex))
    stats["survivors"] = int(x.shape[0])
    if refresh_centroids:
        out = kmeans_fit(
            x,
            KMeansParams(
                n_clusters=cents_old.shape[0], max_iter=kmeans_n_iters,
                init="random", compute_dtype="bfloat16",
            ),
            centroids=cents_old,                     # warm start
        )
        cents_new = out.centroids.float()
        stats["refreshed"] = True
        if drift_queries is not None:
            ov = probe_overlap(cents_old, cents_new, drift_queries,
                               n_probes)
            stats["probe_overlap"] = ov
            errors.expects(
                ov >= min_probe_overlap,
                "compact: centroid refresh drifted the probe map — "
                "probe_overlap %.3f < min_probe_overlap %.3f; refresh "
                "more often (smaller drift per refresh) or re-measure "
                "recall before serving", ov, min_probe_overlap,
            )
    else:
        cents_new = cents_old
        stats["refreshed"] = False

    nl = cents_new.shape[0]
    # route to the lowest list sharing a centroid, as the upserts do (a
    # piece's residual codes are its parent's: the rows are equal)
    canon = (mindex.canon if cents_new is cents_old
             else canonical_lists(cents_new))
    if engine == "pq":
        m = index.pq_dim
        lbl, codes = _encode_rows(x, cents_new, index.codebooks, m, d // m)
    else:
        lbl = kmeans_predict(x, cents_new)
    lbl = canon[lbl.long()]
    st, order_np, n_real = _padded_storage(
        lbl.cpu().numpy(), gids.cpu().numpy(), nl, list_bucket, row_bucket,
        dev)
    order = torch.as_tensor(order_np, device=dev).long()
    pad = st.n - n_real

    def slab(rows, dtype):
        # rows in list order, zero pad rows and the sentinel row appended
        return torch.cat([
            rows[order].to(dtype),
            torch.zeros((pad + 1,) + tuple(rows.shape[1:]), dtype=dtype,
                        device=dev),
        ])

    if engine == "flat":
        new_index = IVFFlatIndex(cents_new, slab(x, index.data_sorted.dtype),
                                 st, index.metric)
    elif engine == "sq":
        # survivors carry their codes; only the delta rows pay the
        # quantization they deferred, against the kept stats
        codes_all = torch.cat([codes_keep,
                               sq_encode(dvecs, index.vmin, index.vscale)])
        new_index = IVFSQIndex(cents_new, slab(codes_all, torch.int8),
                               index.vmin, index.vscale, st)
    else:
        new_index = IVFPQIndex(
            cents_new, index.codebooks, slab(codes, torch.uint8), st,
            slab(x, index.vectors_sorted.dtype), index.pq_dim,
            index.pq_bits)
    out = wrap_mutable(new_index, delta_cap=delta.cap, name=mindex.name)
    out.dirty_lists = set(range(nl))   # every list changed on disk
    # compaction continues the epoch chain (a reset would mark old cache
    # entries fresh again) and journals "everything"
    out.epoch = mindex.epoch + 1
    _journal_note(out, None)
    stats["max_list"] = st.max_list
    stats["n_slab"] = st.n
    ms = _mseries(mindex.name)
    ms["op_ms"]["compact"].observe(
        (time.perf_counter() - t_compact0) * 1e3)
    ms["compactions"].inc()
    return out, stats


class BackgroundCompactor:
    """Runs :func:`compact` on a thread of its own — and, for an index on
    a CUDA card, on a CUDA stream of its own — while the caller keeps
    serving searches on the old state (state is functional: readers never
    see a half-compacted index).

    Swap protocol: ``maybe_submit`` a snapshot of the current state; keep
    serving and buffer later writes (or re-apply them after the swap —
    upsert/delete are idempotent by id); when ``poll`` returns the
    compacted state, warm it (:func:`mutable_warmup`) and swap it in. The
    compaction stream waits for the submitting stream before it reads
    the snapshot, and ``poll`` makes the caller's current stream wait on
    the compaction's event before it hands the new state over. One
    compaction in flight at a time."""

    def __init__(self, policy: CompactionPolicy = CompactionPolicy(),
                 **compact_kw):
        self.policy = policy
        self._kw = compact_kw
        self._lock = lockcheck.make_lock("BackgroundCompactor._lock")
        self._thread: typing.Optional[threading.Thread] = None
        self._result = None
        self._event = None
        self._error: typing.Optional[BaseException] = None
        self._n_compactions = 0

    @property
    def busy(self) -> bool:
        with self._lock:
            return self._thread is not None and self._thread.is_alive()

    def submit(self, mindex: MutableIndex) -> bool:
        """Start a compaction of ``mindex`` (a snapshot); False when one
        is already in flight or an unpolled result is pending."""
        with self._lock:
            if (self._thread is not None and self._thread.is_alive()) or \
                    self._result is not None or self._error is not None:
                return False
            kw = dict(self._kw)
            if self.policy.refresh_every:
                due = (self._n_compactions + 1) % self.policy.refresh_every
                kw.setdefault("refresh_centroids", due == 0)
            dev = mindex.index.device
            stream = None
            if dev.type == "cuda":
                # the snapshot's tensors may still be written by work
                # queued on the submitting stream
                stream = torch.cuda.Stream(device=dev)
                stream.wait_stream(torch.cuda.current_stream(dev))

            def work():
                try:
                    if stream is None:
                        res, ev = compact(mindex, **kw), None
                    else:
                        with torch.cuda.stream(stream):
                            res = compact(mindex, **kw)
                            ev = torch.cuda.Event()
                            ev.record(stream)
                        # hold the snapshot until the stream read it
                        ev.synchronize()
                except BaseException as e:  # noqa: BLE001 — surfaced on poll
                    with self._lock:
                        self._error = e
                    return
                with self._lock:
                    self._result = res
                    self._event = ev
                    self._n_compactions += 1

            obs_crash.install_excepthook()
            self._thread = threading.Thread(
                target=work, daemon=True, name="ann-compactor")
            self._thread.start()
            return True

    def maybe_submit(self, mindex: MutableIndex) -> bool:
        """Submit iff the policy says the state needs compaction."""
        if self.busy:
            return False
        if not self.policy.should_compact(compaction_stats(mindex)):
            return False
        return self.submit(mindex)

    def poll(self):
        """``(new_mindex, stats)`` when a compaction finished, else None.
        Re-raises a failed compaction's error."""
        with self._lock:
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            if self._result is None:
                return None
            res, self._result = self._result, None
            ev, self._event = self._event, None
        if ev is not None:
            torch.cuda.current_stream(
                res[0].index.device).wait_event(ev)
        return res

    def join(self, timeout: typing.Optional[float] = None) -> None:
        with self._lock:
            t = self._thread
        if t is not None:
            t.join(timeout)

    def stop(self, timeout_s: float = 30.0) -> None:
        """Join the in-flight compaction (bounded) and re-raise a stored
        worker exception instead of dropping it. Raises ``TimeoutError``
        if the worker outlives ``timeout_s``."""
        with self._lock:
            t = self._thread
        if t is not None:
            t.join(timeout_s)
            if t.is_alive():
                raise TimeoutError(
                    f"BackgroundCompactor: worker still running after "
                    f"{timeout_s:.1f}s")
        with self._lock:
            self._thread = None
            if self._error is not None:
                err, self._error = self._error, None
                raise err


# ------------------------------------------- incremental checkpoint (v4)
_DELTA_KIND = "mutation-delta"
_DELTA_VERSION = 4


def save_delta_checkpoint(mindex: MutableIndex, path,
                          *, lists=None, wal_lsn=None) -> list:
    """Write an incremental v4 checkpoint: only dirty lists' delta
    segments (``lists`` overrides the tracked dirty set), plus the small
    full ``row_mask`` / ``counts`` arrays, each CRC32-manifested — the
    JAX package's ``mutation-delta`` format, byte for byte. Replay
    newest-last with :func:`apply_delta_checkpoint` (idempotent). Clears
    the dirty set; returns the list ids written. ``wal_lsn`` stamps the
    durable-ingest watermark (:func:`delta_checkpoint_watermark`)."""
    from raft_tpu_torch.spatial.ann.interop import _array_crc

    ls = sorted(set(mindex.dirty_lists if lists is None else lists))
    delta = mindex.delta
    arrays = {
        "row_mask": mindex.row_mask.cpu().numpy(),
        "counts": delta.counts.cpu().numpy(),
    }
    nl = delta.ids.shape[0]
    for l in ls:
        errors.expects(
            0 <= l < nl,
            "save_delta_checkpoint: list %d out of range [0, %d)", l, nl,
        )
    if ls:
        sel = torch.as_tensor(ls, device=delta.ids.device)
        dv, di, dl = (t[sel].cpu().numpy()
                      for t in (delta.vecs, delta.ids, delta.live))
        for j, l in enumerate(ls):
            arrays[f"list.{l}.vecs"] = dv[j]
            arrays[f"list.{l}.ids"] = di[j]
            arrays[f"list.{l}.live"] = dl[j]
    header = {
        "kind": _DELTA_KIND,
        "version": _DELTA_VERSION,
        "n_lists": int(nl),
        "cap": int(delta.cap),
        "lists": [int(l) for l in ls],
        **({} if wal_lsn is None else {"wal_lsn": int(wal_lsn)}),
        "integrity": {
            key: {
                "crc32": _array_crc(arr),
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
            }
            for key, arr in arrays.items()
        },
    }
    with open(path, "wb") as f:
        np.savez(
            f,
            __header__=np.frombuffer(
                json.dumps(header).encode("utf-8"), dtype=np.uint8
            ),
            **arrays,
        )
    mindex.dirty_lists.clear()
    return ls


def delta_checkpoint_watermark(path):
    """A delta checkpoint's ``wal_lsn`` watermark (the highest WAL LSN it
    captures) without loading its arrays; None when it has none."""
    try:
        with np.load(path) as npz:
            header = json.loads(bytes(npz["__header__"]).decode("utf-8"))
    except Exception as e:
        raise errors.CorruptIndexError(
            f"delta_checkpoint_watermark: header unreadable ({e})",
            field="__header__",
        ) from e
    lsn = header.get("wal_lsn")
    return None if lsn is None else int(lsn)


def apply_delta_checkpoint(mindex: MutableIndex, path) -> MutableIndex:
    """Splice a :func:`save_delta_checkpoint` file (either package's)
    into ``mindex``, on the wrapped index's device (idempotent: set
    semantics per list). Damage — a torn write, a block that fails its
    CRC32, a future format version, a geometry mismatch — raises
    :class:`~raft_tpu_torch.errors.CorruptIndexError` naming the field."""
    from raft_tpu_torch.spatial.ann.interop import _read

    where = "apply_delta_checkpoint"
    try:
        npz_file = np.load(path)
    except Exception as e:
        raise errors.CorruptIndexError(
            f"{where}: archive unreadable ({e}) — torn write or not a "
            "delta checkpoint", field="__header__"
        ) from e
    with npz_file as npz:
        try:
            header = json.loads(bytes(npz["__header__"]).decode("utf-8"))
        except Exception as e:
            raise errors.CorruptIndexError(
                f"{where}: header unreadable ({e})", field="__header__",
            ) from e
        if header.get("kind") != _DELTA_KIND:
            raise errors.CorruptIndexError(
                f"{where}: kind {header.get('kind')!r} is not "
                f"{_DELTA_KIND!r}", field="__header__",
            )
        v = header.get("version")
        if v != _DELTA_VERSION:
            raise errors.CorruptIndexError(
                f"{where}: format version {v!r} is not readable by this "
                f"release (expected {_DELTA_VERSION}); upgrade before "
                "restoring", field="__header__",
            )
        delta = mindex.delta
        nl = delta.ids.shape[0]
        if header.get("n_lists") != nl or header.get("cap") != delta.cap:
            raise errors.CorruptIndexError(
                f"{where}: geometry mismatch (checkpoint "
                f"n_lists={header.get('n_lists')} cap={header.get('cap')}"
                f", index n_lists={nl} cap={delta.cap})",
                field="__header__",
            )
        manifest = header.get("integrity") or {}
        dev = mindex.index.device

        def get(key):
            return torch.as_tensor(_read(npz, manifest, key, where),
                                   device=dev)

        row_mask = get("row_mask")
        if tuple(row_mask.shape) != tuple(mindex.row_mask.shape):
            raise errors.CorruptIndexError(
                f"{where}: row_mask shape {tuple(row_mask.shape)} != index "
                f"{tuple(mindex.row_mask.shape)}", field="row_mask",
            )
        counts = get("counts")
        dv, di, dl = delta.vecs.clone(), delta.ids.clone(), delta.live.clone()
        for l in header.get("lists", []):
            dv[l] = get(f"list.{l}.vecs")
            di[l] = get(f"list.{l}.ids")
            dl[l] = get(f"list.{l}.live")
        new_delta = DeltaStore(vecs=dv, ids=di, live=dl, counts=counts,
                               cap=delta.cap)
    return _with(mindex, delta=new_delta, row_mask=row_mask)
