"""The two-tier slab store — the port of ``raft_tpu/tier/store.py``: cold
IVF lists in host RAM, a hot working set of list-sized slots on the
card, and membership as runtime tensors of the unchanged grouped search.

Most of a shard's slab is paid for and almost never probed: list
accesses follow the query skew. The tier splits the slab by popularity
instead of truncating it:

* the COLD tier is the full list-sorted slab, snapshotted once into host
  memory — a pinned tensor when the index lives on a CUDA card (the
  buffer every promotion copies from), plain memory on the CPU;
* the HOT tier is ``n_slots`` list-sized slots on the index's device
  (``slot_rows = max_list`` rows each, the grouped scan's padded list
  height), plus a parallel id slab mapping hot positions back to row
  ids.

**The search is untouched.** :class:`TieredListStore` builds an
:class:`~raft_tpu_torch.spatial.ann.ivf_flat.IVFFlatIndex` VIEW over the
hot buffer — ``data_sorted`` is the hot slab, ``storage.sorted_ids`` the
hot id map, ``list_offsets``/``list_sizes`` derived from the slot map
(hot list ``l`` in slot ``s`` at offset ``s * max_list``; a cold list at
the sentinel offset with size 0) — and runs the one grouped body
(:func:`~raft_tpu_torch.spatial.ann.ivf_flat._grouped_impl`) on it with
the legacy engine, as the JAX tier pins its XLA engine
(``use_pallas=False``). That is the reference's engine choice, not a
fallback: ``ENGINE_FALLBACKS`` does not count it, and the tier has no
engine knob. A flip of membership or tombstones changes tensor values
only: no new extension is built, and a tiered search makes no host sync.
An int8 SQ index tiers its codes (the ``dequant`` pair rides along).

**Graceful degradation.** A probe that lands on a cold list scans an
empty slot: every candidate there scores +inf and the query is answered
from the hot lists it did hit. The miss is counted, recorded into the
per-list load feed (:func:`raft_tpu_torch.resilience.replica.record_list_load`)
and handed to the async fetcher (:class:`~raft_tpu_torch.tier.fetch.SlabFetcher`),
under the measured recall guardrail (:meth:`TieredListStore.measure_recall`).

**Install = copy-publish, one copy per membership transaction.** A
``promote`` or ``apply_moves`` clones the hot data and id buffers once,
copies each new list's rows into its slot of the clone, and
:meth:`TieredListStore._publish` swaps the clone in together with the
offsets, sizes and view mask, so a snapshot (:meth:`runtime`) always
describes one membership version and a dispatch still holding the old
snapshot keeps reading the old buffers. On a card all of it runs on the
store's own copy stream: host-to-device copies are ``non_blocking``
from the pinned cold slab, the offsets, sizes and mask go up from fresh
pinned tensors each time (never from a buffer the next publish
rewrites), and the publish records a CUDA event that rides in the
snapshot. A search makes its current stream wait on that event, and
marks the snapshot's tensors as used by that stream
(``record_stream``), so the caching allocator does not hand a replaced
buffer to a new allocation while a dispatch on another stream (the
executor's, or its hedge stream) still reads it. The transient peak is
twice the hot buffer.

**Mutation-epoch invalidation**: :meth:`sync_mutations` pulls a
:class:`~raft_tpu_torch.spatial.ann.mutation.MutableIndex`'s epoch
journal. Upsert/delete change only the tombstone ``row_mask`` (delta
rows live outside the frozen slab), so the view mask is re-gathered and
re-published. Compaction rewrites the slab: the journal answers None,
the store re-snapshots its host authority and invalidates every hot
slot.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import typing
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch import errors
from raft_tpu_torch.analysis.threads import runtime as lockcheck
from raft_tpu_torch.obs import metrics as obs_metrics
from raft_tpu_torch.spatial.ann.common import ListStorage, static_qcap
from raft_tpu_torch.spatial.ann.ivf_flat import (
    IVFFlatIndex,
    _grouped_impl,
    _sqrt,
)

__all__ = ["StagedQueries", "TierRuntime", "TierStats", "TieredListStore"]


@dataclasses.dataclass(frozen=True)
class TierRuntime:
    """One consistent tier snapshot — what a dispatch closure receives
    as its ``tier=`` runtime operand (taken under the store lock, so the
    view tensors and the row mask describe the same membership
    version)."""

    view: IVFFlatIndex        # the hot-buffer view index
    row_mask: torch.Tensor    # (n_view + 1,) int8 hot-position live mask
    version: int              # membership version (debugging/telemetry)
    epoch: int                # mutation epoch the snapshot reflects
    # the SQ dequant pair riding the snapshot (None for flat): a host
    # refresh that re-quantized never mixes new codes with old scales
    dequant: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    # recorded on the store's copy stream after the publish that made
    # this snapshot (None on the CPU): a reader's stream waits on it
    event: Optional[torch.cuda.Event] = None


@dataclasses.dataclass(frozen=True)
class TierStats:
    """Host-side counters (kept live even with ``RAFT_TPU_OBS=off`` —
    the bench row and the guardrail read these, not the registry)."""

    n_lists: int
    n_slots: int
    hot_lists: int
    probe_hits: int
    probe_misses: int
    fetches: int
    demotions: int
    invalidations: int
    fetch_ms_total: float
    overlapped_fetches: int
    hot_bytes: int
    epoch: int
    last_recall: Optional[float]

    @property
    def hit_rate(self) -> float:
        tot = self.probe_hits + self.probe_misses
        return self.probe_hits / tot if tot else 0.0

    @property
    def fetch_overlap_pct(self) -> float:
        return (100.0 * self.overlapped_fetches / self.fetches
                if self.fetches else 0.0)


@dataclasses.dataclass(frozen=True)
class StagedQueries:
    """A padded query batch staged for a tiered dispatch: the rows on the
    store's device and the host rows they were copied from (what
    :meth:`TieredListStore.search` accounts, with no copy back). Made by
    :meth:`TieredListStore.stage`, the executor's ``stage=`` hook."""

    device: torch.Tensor
    host: np.ndarray

    @property
    def shape(self) -> torch.Size:
        return self.device.shape


class TieredListStore:
    """Popularity-tiered list storage over one IVF-Flat (or SQ-coded)
    index — see the module docstring for the design.

    ``index``: an :class:`IVFFlatIndex` or
    :class:`~raft_tpu_torch.spatial.ann.ivf_sq.IVFSQIndex` (tiered
    through its int8 code view; ``dequant`` rides every scan). The
    index's rows, ids, offsets and sizes are snapshotted to host memory
    ONCE at construction — that copy IS the cold tier. The hot tier
    lives on the index's device.

    ``n_slots`` / ``hbm_budget_bytes``: the hot working set, as a slot
    count or as a byte budget for the hot data slab (``n_slots = budget
    // (max_list * d * itemsize)``, clamped to ``[1, n_lists]``).

    ``epoch``: the mutation epoch the snapshotted state reflects (pass
    ``mindex.epoch`` when tiering an already-mutated index, so the first
    :meth:`sync_mutations` is a no-op instead of a full invalidation).

    ``min_recall``: the measured recall guardrail — :meth:`measure_recall`
    records into the ``tier_recall`` gauge and counts a
    ``tier_recall_breaches_total`` below it.
    """

    def __init__(self, index, *, n_slots: Optional[int] = None,
                 hbm_budget_bytes: Optional[int] = None,
                 name: str = "tier", shard: int = 0,
                 epoch: int = 0,
                 min_recall: Optional[float] = None,
                 touch_decay: float = 0.9,
                 registry: "obs_metrics.MetricRegistry | None" = None,
                 flight=None,
                 clock: Callable[[], float] = time.monotonic):
        base, dequant, origin = _resolve_base(index)
        self._origin = origin
        self._dequant = dequant
        self.name = str(name)
        self.shard = int(shard)
        self.min_recall = min_recall
        self.flight = flight
        self._clock = clock
        self._device = base.centroids.device
        # on a card: the cold slab pinned, and the copy stream every
        # write of the hot tier runs on (installs and publishes stay in
        # order on it)
        self._pin = self._device.type == "cuda"
        self._copy_stream = (torch.cuda.Stream(self._device) if self._pin
                             else None)

        # -- the cold tier: ONE host snapshot of the list-sorted slab ----
        storage = base.storage
        self._data_host = _host_copy(base.data_sorted, self._pin)  # (n+1, d)
        self._sids_host = _host_copy(storage.sorted_ids, self._pin)
        self._offs_np = storage.list_offsets.cpu().numpy()
        self._szs_np = storage.list_sizes.cpu().numpy()
        self._cents_np = base.centroids.float().cpu().numpy()
        self._cn2_np = np.sum(self._cents_np ** 2, axis=1)
        self._n = int(storage.n)
        self._d = int(self._data_host.shape[1])
        self._L = int(storage.max_list)
        self._n_lists = int(storage.list_index.shape[0])
        self._metric = base.metric
        # the authoritative tombstone mask (refreshed by sync_mutations)
        self._mask_np = np.ones(self._n + 1, np.int8)

        n_slots = _resolve_slots(
            n_slots, hbm_budget_bytes, self._L, self._d,
            self._data_host.element_size(), self._n_lists,
        )
        self.n_slots = n_slots
        self._n_view = n_slots * self._L

        # -- host mirrors of the membership (under _install) -----------
        self._slot_of = np.full(self._n_lists, -1, np.int32)
        self._list_at = np.full(n_slots, -1, np.int32)
        # original sorted-slab position of each hot row (the mask
        # re-gather input); n = "points at the sentinel row"
        self._hot_pos = np.full(self._n_view, self._n, np.int64)
        self._offs_host = np.full(self._n_lists + 1, self._n_view,
                                  np.int32)
        self._szs_host = np.zeros(self._n_lists, np.int32)
        # the clones a membership transaction writes into (under
        # _install; swapped in by _publish)
        self._tx: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

        # -- device state ------------------------------------------------
        self._cents_dev = base.centroids
        # only ``.shape[0]`` of list_index is read by the grouped scan
        self._dummy_index = torch.zeros((self._n_lists, 1), dtype=torch.int32,
                                        device=self._device)
        with self._on_copy_stream():
            self._hot_data = torch.zeros((self._n_view + 1, self._d),
                                         dtype=self._data_host.dtype,
                                         device=self._device)
            self._hot_ids = torch.full((self._n_view,), -1,
                                       dtype=torch.int32, device=self._device)
        self._offs_dev = self._szs_dev = self._maskv_dev = None
        self._event = None

        # -- load signal + counters ------------------------------------
        self._touch = np.zeros(self._n_lists, np.float64)
        self._touch_decay = float(touch_decay)
        self._hits = 0
        self._misses = 0
        self._fetches = 0
        self._demotions = 0
        self._invalidations = 0
        self._fetch_ms = 0.0
        self._overlapped = 0
        self._version = 0
        self._seen_epoch = int(epoch)
        self.last_recall: Optional[float] = None
        self._fill_sink: Optional[Callable[[Sequence[int]], None]] = None

        # ``_install`` serializes EVERY membership/data change (promote,
        # demote, mask refresh, host refresh); ``_lock`` guards only the
        # published snapshot + counters. Order: _install -> _lock.
        self._install = lockcheck.make_lock("TieredListStore._install")
        self._lock = lockcheck.make_lock("TieredListStore._lock")

        reg = (obs_metrics.default_registry()
               if registry is None else registry)
        self._c_hits = reg.counter("tier_probe_hits_total", tier=name)
        self._c_misses = reg.counter("tier_probe_misses_total", tier=name)
        self._c_fetches = reg.counter("tier_fetches_total", tier=name)
        self._c_demotions = reg.counter("tier_demotions_total", tier=name)
        self._c_invalid = reg.counter("tier_invalidations_total",
                                      tier=name)
        self._c_breach = reg.counter("tier_recall_breaches_total",
                                     tier=name)
        self._g_hot = reg.gauge("tier_hot_lists", tier=name)
        self._g_bytes = reg.gauge("tier_hot_bytes", tier=name)
        self._g_recall = reg.gauge("tier_recall", tier=name)
        self._h_fetch = reg.histogram("tier_fetch_ms", tier=name)
        self._g_bytes.set(float(_nbytes(self._hot_data)))
        with self._install:
            self._publish()
        self._version = 0          # the initial upload is version 0

    # -- snapshots -------------------------------------------------------
    def runtime(self) -> Dict[str, TierRuntime]:
        """The runtime snapshot for a serving dispatch — shaped for
        :class:`~raft_tpu_torch.serving.ServingExecutor`'s
        ``runtime_provider`` hook (merged into every dispatch's keyword
        arguments outside the executor locks)."""
        with self._lock:
            view = IVFFlatIndex(
                centroids=self._cents_dev,
                data_sorted=self._hot_data,
                storage=ListStorage(
                    sorted_ids=self._hot_ids,
                    list_offsets=self._offs_dev,
                    list_index=self._dummy_index,
                    list_sizes=self._szs_dev,
                    n=self._n_view,
                    max_list=self._L,
                ),
                metric=self._metric,
            )
            return {"tier": TierRuntime(
                view=view, row_mask=self._maskv_dev,
                version=self._version, epoch=self._seen_epoch,
                dequant=self._dequant, event=self._event,
            )}

    def stats(self) -> TierStats:
        with self._lock:
            return TierStats(
                n_lists=self._n_lists, n_slots=self.n_slots,
                hot_lists=int((self._slot_of >= 0).sum()),
                probe_hits=self._hits, probe_misses=self._misses,
                fetches=self._fetches, demotions=self._demotions,
                invalidations=self._invalidations,
                fetch_ms_total=self._fetch_ms,
                overlapped_fetches=self._overlapped,
                hot_bytes=_nbytes(self._hot_data),
                epoch=self._seen_epoch, last_recall=self.last_recall,
            )

    def hot_lists(self) -> np.ndarray:
        """List ids currently hot, ascending (a host copy)."""
        with self._lock:
            return np.nonzero(self._slot_of >= 0)[0].astype(np.int32)

    def measured_load(self) -> np.ndarray:
        """The decayed per-list touch signal the promotion policy ranks
        by — same units as :func:`...replica.measured_list_load` rows
        (a host copy)."""
        with self._lock:
            return self._touch.copy()

    @property
    def host_bytes(self) -> int:
        """Bytes of the cold tier's host snapshot (rows and ids), of one
        consistent snapshot (``refresh_host`` swaps both under _lock)."""
        with self._lock:
            return _nbytes(self._data_host) + _nbytes(self._sids_host)

    # -- serving ---------------------------------------------------------
    def stage(self, queries: np.ndarray) -> StagedQueries:
        """The executor's ``stage=`` hook for tiered dispatches: the
        executor's default staging (a pinned host copy, then a
        ``non_blocking`` copy on the current stream) that also keeps the
        host rows, so :meth:`search` accounts them without copying the
        batch back from the card."""
        rows = np.asarray(queries, np.float32)
        if self._device.type != "cuda":
            return StagedQueries(torch.tensor(rows), rows)
        pinned = torch.empty(rows.shape, dtype=torch.float32,
                             pin_memory=True)
        pinned.numpy()[...] = rows
        return StagedQueries(pinned.to(self._device, non_blocking=True), rows)

    def search(self, queries, k: int, *, n_probes: int = 8,
               qcap: typing.Union[int, str, None] = None,
               list_block: int = 32,
               stream_partials: Optional[bool] = None,
               runtime: Optional[TierRuntime] = None,
               account: bool = True,
               fill: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """Grouped search over the HOT tier — the unchanged
        :func:`_grouped_impl` body on the hot-slot view, on the legacy
        engine. Probes landing on cold lists contribute nothing (the
        graceful degraded answer); when ``account`` they are counted,
        fed into the per-list load signal, and (when ``fill`` and a
        fetcher is attached) queued for async promotion.

        ``queries``: host rows (numpy or a CPU tensor), a tensor on the
        store's device, or a :class:`StagedQueries` from :meth:`stage`.
        The accounting replays the coarse probe on the host rows; a CUDA
        tensor without them is copied back for it — one device-to-host
        copy of the batch, and so a host sync (a wait for whatever
        produced the queries), per call; ``chip_smoke.py``'s tier phase
        times it.

        ``runtime``: an explicit :class:`TierRuntime` snapshot (what an
        executor dispatch received); default takes a fresh one.
        ``qcap`` resolves by shape only
        (:func:`...ann.common.static_qcap`). Beyond the accounting
        copy above, the search makes no host sync: the checks read
        shapes, never tensor values."""
        host = None
        if isinstance(queries, StagedQueries):
            queries, host = queries.device, queries.host
        elif not isinstance(queries, torch.Tensor):
            host = np.asarray(queries, np.float32)
            queries = host
        q = torch.as_tensor(queries, device=self._device)
        errors.check_matrix(q, "queries")
        errors.expects(
            q.shape[1] == self._d,
            "TieredListStore.search: queries d=%d != index d=%d",
            q.shape[1], self._d,
        )
        errors.expects(
            k <= self._L and k <= n_probes * self._L,
            "TieredListStore.search: k=%d exceeds the candidate pool "
            "(max_list=%d, n_probes=%d)", k, self._L, n_probes,
        )
        nq = int(q.shape[0])
        qc = static_qcap(qcap, nq, n_probes, self._n_lists)
        if account:
            if host is None:
                host = q.detach().float().cpu().numpy()
            self._account(np.asarray(host, np.float32), n_probes, fill)
        snap = runtime if runtime is not None \
            else self.runtime()["tier"]
        _read_on_current_stream(snap)
        list_block = max(1, min(list_block, self._n_lists))
        lockcheck.note_dispatch("TieredListStore.search")
        vals, ids = _grouped_impl(
            snap.view, q, k, n_probes, qc, list_block,
            stream_partials=stream_partials, row_mask=snap.row_mask,
            use_kernel=False, dequant=snap.dequant,
        )
        if self._metric == "l2":
            vals = _sqrt(vals)
        return vals, ids

    def _account(self, q_np: np.ndarray, n_probes: int,
                 fill: bool) -> None:
        """Host-side probe accounting: the coarse probe replayed in
        numpy (order-only — ties may break differently from the device
        probe, which only perturbs the LOAD signal, never an answer).
        Updates hit/miss counters, the decayed touch signal, the
        per-(shard, list) load feed, and queues cold probed lists for
        async fill.

        Exactly-zero rows are the executor's micro-batch padding and are
        not accounted (counting them would pin the origin's nearest
        lists hot and inflate the hit rate at low load); their answer
        is unaffected."""
        from raft_tpu_torch.resilience.replica import record_list_load

        live = np.any(q_np != 0.0, axis=1)
        if not live.all():
            q_np = q_np[live]
            if q_np.shape[0] == 0:
                return
        probes = self.host_probes(q_np, n_probes)
        counts = np.bincount(probes.ravel(),
                             minlength=self._n_lists).astype(np.float64)
        with self._lock:
            hot = self._slot_of[probes] >= 0
            hits = int(hot.sum())
            misses = int(hot.size - hits)
            self._hits += hits
            self._misses += misses
            self._touch *= self._touch_decay
            self._touch += counts
            miss_lists = (np.unique(probes[~hot])
                          if misses else np.empty(0, np.int64))
            sink = self._fill_sink
        self._c_hits.inc(hits)
        self._c_misses.inc(misses)
        record_list_load(counts, shard=self.shard)
        if fill and sink is not None and miss_lists.size:
            sink([int(x) for x in miss_lists])

    def host_probes(self, q_np: np.ndarray, n_probes: int) -> np.ndarray:
        """The coarse probe replayed in numpy: the ``(nq, n_probes)``
        lists each host query row probes (in no particular order)."""
        p = min(n_probes, self._n_lists)
        # order-only distance: |c|^2 - 2 q.c (the |q|^2 term is a
        # per-row constant)
        d2 = self._cn2_np[None, :] - 2.0 * (q_np @ self._cents_np.T)
        if p < self._n_lists:
            return np.argpartition(d2, p - 1, axis=1)[:, :p]
        return np.broadcast_to(np.arange(self._n_lists), d2.shape).copy()

    # -- membership ------------------------------------------------------
    def promote(self, list_ids: Sequence[int], *,
                busy=False) -> int:
        """Synchronously fetch + install the given lists into free hot
        slots (already-hot ids are no-ops), as one membership
        transaction. Returns the number installed; stops early when the
        hot set is full — pair with :meth:`demote` or let
        :meth:`rebalance` plan swaps. ``busy`` (bool or callable) stamps
        the fetch spans compute-overlapped (the async fetcher passes its
        executor-busy probe)."""
        done = 0
        with self._install:
            for lid in list_ids:
                self._check_list(lid)
                if self._slot_of[lid] >= 0:
                    continue
                free = np.nonzero(self._list_at < 0)[0]
                if free.size == 0:
                    break
                self._install_list(int(lid), int(free[0]), busy=busy)
                done += 1
            if done:
                self._publish()
        return done

    def demote(self, list_ids: Sequence[int]) -> int:
        """Flip the given hot lists cold — membership only, nothing is
        copied back (the host slab is the authority; a hot slab is
        never dirtied). Returns the number demoted."""
        done = 0
        with self._install:
            for lid in list_ids:
                self._check_list(lid)
                slot = int(self._slot_of[lid])
                if slot < 0:
                    continue
                self._evict_slot(slot)
                done += 1
                if self.flight is not None:
                    self.flight.record("tier_demote", list=int(lid),
                                       slot=slot)
            if done:
                self._publish()
        with self._lock:
            self._demotions += done
        self._c_demotions.inc(done)
        return done

    def apply_moves(self, moves: Sequence[Tuple[int, Optional[int]]],
                    *, busy=False) -> int:
        """Apply a promotion plan — ``(promote_list, victim_list|None)``
        pairs from :class:`~raft_tpu_torch.tier.policy.PromotionPolicy` —
        as one membership transaction (one clone, one publish, one
        version bump). Returns the number of lists promoted."""
        done = 0
        with self._install:
            for lid, victim in moves:
                self._check_list(lid)
                if self._slot_of[lid] >= 0:
                    continue
                if victim is not None and self._slot_of[victim] >= 0:
                    slot = int(self._slot_of[victim])
                    self._evict_slot(slot)
                    with self._lock:
                        self._demotions += 1
                    self._c_demotions.inc()
                else:
                    free = np.nonzero(self._list_at < 0)[0]
                    if free.size == 0:
                        continue
                    slot = int(free[0])
                self._install_list(int(lid), slot, busy=busy)
                done += 1
            if done:
                self._publish()
        return done

    def rebalance(self, policy, *, busy=False) -> int:
        """Plan against the current measured load and apply — the
        periodic promotion/demotion cycle."""
        with self._lock:
            slot_of = self._slot_of.copy()
        moves = policy.plan(self.measured_load(), slot_of, self.n_slots)
        return self.apply_moves(moves, busy=busy) if moves else 0

    def attach_fill_sink(
            self, sink: Optional[Callable[[Sequence[int]], None]],
    ) -> None:
        """Register the async-fill callback (the
        :class:`~raft_tpu_torch.tier.fetch.SlabFetcher` attaches itself);
        ``None`` detaches."""
        with self._lock:
            self._fill_sink = sink

    # -- mutation-epoch invalidation --------------------------------------
    def sync_mutations(self, mindex) -> Optional[set]:
        """Pull a :class:`MutableIndex`'s epoch journal forward.
        Upsert/delete change only tombstones — the view mask is
        re-gathered from the fresh ``row_mask`` and re-published.
        Compaction (journal answer ``None``) rewrites the slab: the host
        authority is re-snapshotted and EVERY hot slot is invalidated.
        A state whose epoch went back (a recovery that counts on from
        its base, below the epoch this store saw) answers an empty set
        and still re-publishes its mask, then its epoch is adopted.
        Returns the changed-list set (``None`` = all, empty = no-op or
        a step back)."""
        from raft_tpu_torch.spatial.ann.mutation import lists_changed_since

        with self._install:
            epoch = int(mindex.epoch)
            if epoch == self._seen_epoch:
                return set()
            changed = lists_changed_since(mindex, self._seen_epoch)
            # a host copy the store owns (never a view of the state's)
            mask = mindex.row_mask.cpu().numpy().copy()
            if changed is None:
                # full invalidation — but the CURRENT tombstones must
                # ride along (a journal-overflow None without a
                # compaction still has live deletes in row_mask)
                self._refresh_host_locked(mindex.index, row_mask=mask)
            else:
                with self._lock:
                    self._mask_np = mask
                self._publish()
            with self._lock:
                self._seen_epoch = epoch
            return changed

    def refresh_host(self, index) -> None:
        """Re-snapshot the host (cold-tier) authority from ``index``
        and invalidate every hot slot — the compaction path. The index
        must keep the tier's static geometry (n, max_list, n_lists,
        dtype); one that changes it needs a NEW store."""
        with self._install:
            self._refresh_host_locked(index)

    def _refresh_host_locked(self, index, row_mask=None) -> None:
        base, dequant, _ = _resolve_base(index)
        storage = base.storage
        errors.expects(
            int(storage.n) == self._n
            and int(storage.max_list) == self._L
            and int(storage.list_index.shape[0]) == self._n_lists
            and base.data_sorted.dtype == self._data_host.dtype,
            "refresh_host: index geometry changed "
            "(n=%d max_list=%d n_lists=%d vs store n=%d max_list=%d "
            "n_lists=%d) — build a new TieredListStore",
            int(storage.n), int(storage.max_list),
            int(storage.list_index.shape[0]),
            self._n, self._L, self._n_lists,
        )
        data = _host_copy(base.data_sorted, self._pin)
        sids = _host_copy(storage.sorted_ids, self._pin)
        offs = storage.list_offsets.cpu().numpy()
        szs = storage.list_sizes.cpu().numpy()
        with self._lock:
            # swap every host-authority ref in ONE critical section so
            # a concurrent fetch never mixes old offsets with a new slab
            self._data_host, self._sids_host = data, sids
            self._offs_np, self._szs_np = offs, szs
            self._mask_np = (np.ones(self._n + 1, np.int8)
                             if row_mask is None
                             else np.asarray(row_mask, np.int8))
            self._dequant = dequant
        n_inval = int((self._list_at >= 0).sum())
        for slot in range(self.n_slots):
            if self._list_at[slot] >= 0:
                self._evict_slot(slot)
        self._publish()
        with self._lock:
            self._invalidations += n_inval
        self._c_invalid.inc(n_inval)
        if self.flight is not None and n_inval:
            self.flight.record("tier_invalidate", reason="refresh_host",
                               n_slots=n_inval)

    # -- guardrail ---------------------------------------------------------
    def measure_recall(self, queries, k: int, *, n_probes: int = 8,
                       qcap: typing.Union[int, str, None] = None,
                       list_block: int = 32) -> float:
        """Measured id-overlap recall of the TIERED answer against the
        full (all-lists-resident) grouped search at the same probes and
        tombstones, on the same legacy engine — the degraded-probe
        guardrail. Records the ``tier_recall`` gauge; a measurement
        below ``min_recall`` counts a breach (and a flight event). The
        reference arm dispatches the ORIGINAL index: run this on a
        sampled cadence, not on the serving hot path."""
        q = torch.as_tensor(queries, device=self._device)
        nq = int(q.shape[0])
        qc = static_qcap(qcap, nq, n_probes, self._n_lists)
        _, tiered_ids = self.search(
            q, k, n_probes=n_probes, qcap=qc, list_block=list_block,
            account=False, fill=False,
        )
        base, dequant, _ = _resolve_base(self._origin)
        lb = max(1, min(list_block, self._n_lists))
        with self._lock:
            full_mask = torch.as_tensor(self._mask_np, device=self._device)
        _, full_ids = _grouped_impl(
            base, q, k, n_probes, qc, lb, row_mask=full_mask,
            use_kernel=False, dequant=dequant,
        )
        r = _id_recall(tiered_ids.cpu().numpy(), full_ids.cpu().numpy())
        with self._lock:
            self.last_recall = r
        self._g_recall.set(r)
        if self.min_recall is not None and r < self.min_recall:
            self._c_breach.inc()
            if self.flight is not None:
                self.flight.record(
                    "tier_recall_breach", recall=round(r, 4),
                    min_recall=self.min_recall,
                )
        return r

    @property
    def degraded(self) -> bool:
        """True when the LAST measured recall sits below the guardrail
        (never measured = not degraded — measure before trusting)."""
        with self._lock:
            lr = self.last_recall
        return (self.min_recall is not None and lr is not None
                and lr < self.min_recall)

    # -- internals (under _install) ----------------------------------------
    def _check_list(self, lid: int) -> None:
        errors.expects(
            0 <= int(lid) < self._n_lists,
            "tier: list id %d out of range [0, %d)", int(lid),
            self._n_lists,
        )

    def _on_copy_stream(self):
        return (contextlib.nullcontext() if self._copy_stream is None
                else torch.cuda.stream(self._copy_stream))

    def _authority(self):
        # one consistent host-authority snapshot (refresh_host swaps all
        # four refs under _lock; they are replaced, never written)
        with self._lock:
            return (self._data_host, self._sids_host, self._offs_np,
                    self._szs_np)

    def fetch_slab(self, lid: int) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
        """Read one list's slab from the host (cold) tier as numpy: the
        ``(max_list, d)`` zero-padded rows, the ``(max_list,)`` id map
        (-1 pad), and the ``(max_list,)`` original sorted positions
        (``n`` pad — the sentinel mask row). An install copies the same
        rows straight from the pinned slab, without this padded copy."""
        data, sids, offs, szs = self._authority()
        off = int(offs[lid])
        sz = int(szs[lid])
        slab = np.zeros((self._L, self._d), data.numpy().dtype)
        slab[:sz] = data[off:off + sz].numpy()
        ids = np.full(self._L, -1, np.int32)
        ids[:sz] = sids[off:off + sz].numpy()
        pos = np.full(self._L, self._n, np.int64)
        pos[:sz] = np.arange(off, off + sz)
        return slab, ids, pos

    def _install_list(self, lid: int, slot: int, *,
                      busy=False) -> None:
        """Copy ``lid``'s rows and ids into ``slot`` of this
        transaction's clones (made on the first install of the
        transaction; caller holds ``_install``) and update the host
        mirrors. On a card: ``non_blocking`` host-to-device copies from
        the pinned slab on the copy stream. The clones are PUBLISHED by
        the caller's :meth:`_publish`. ``busy`` — bool or zero-arg
        callable sampled around the span — stamps the fetch
        compute-overlapped (the ``fetch_overlap_pct`` numerator)."""
        t0 = self._clock()
        was_busy = bool(busy() if callable(busy) else busy)
        data, sids, offs, szs = self._authority()
        off = int(offs[lid])
        sz = int(szs[lid])
        r0 = slot * self._L
        with self._on_copy_stream():
            if self._tx is None:
                with self._lock:
                    cur_data, cur_ids = self._hot_data, self._hot_ids
                self._tx = (cur_data.clone(), cur_ids.clone())
            hot_data, hot_ids = self._tx
            hot_data[r0:r0 + sz].copy_(data[off:off + sz], non_blocking=True)
            hot_data[r0 + sz:r0 + self._L].zero_()
            hot_ids[r0:r0 + sz].copy_(sids[off:off + sz], non_blocking=True)
            hot_ids[r0 + sz:r0 + self._L].fill_(-1)
        ms = (self._clock() - t0) * 1e3
        if callable(busy):
            was_busy = was_busy or bool(busy())
        with self._lock:
            self._fetches += 1
            self._fetch_ms += ms
            if was_busy:
                self._overlapped += 1
        self._slot_of[lid] = slot
        self._list_at[slot] = lid
        pos = np.full(self._L, self._n, np.int64)
        pos[:sz] = np.arange(off, off + sz)
        self._hot_pos[r0:r0 + self._L] = pos
        self._offs_host[lid] = r0
        self._szs_host[lid] = sz
        self._c_fetches.inc()
        self._h_fetch.observe(ms)
        if self.flight is not None:
            self.flight.record(
                "tier_fetch", list=int(lid), slot=int(slot),
                ms=round(ms, 3), rows=sz, overlapped=was_busy,
            )

    def _evict_slot(self, slot: int) -> None:
        """Membership-only eviction (caller holds ``_install``): the
        slot's rows stay in the buffer but no offset points at them —
        the next snapshot can never scan them."""
        lid = int(self._list_at[slot])
        if lid >= 0:
            self._slot_of[lid] = -1
            self._offs_host[lid] = self._n_view
            self._szs_host[lid] = 0
        self._list_at[slot] = -1
        self._hot_pos[slot * self._L:(slot + 1) * self._L] = self._n

    def _publish(self) -> None:
        """Push the host mirrors to fresh device tensors, record the
        copy stream's event, and swap them — with this transaction's
        clones, if any — into the published snapshot atomically (caller
        holds ``_install``; readers hold ``_lock`` only)."""
        maskv = np.ones(self._n_view + 1, np.int8)
        maskv[:-1] = self._mask_np[np.minimum(self._hot_pos, self._n)]
        tx, self._tx = self._tx, None
        with self._on_copy_stream():
            offs = self._upload(self._offs_host)
            szs = self._upload(self._szs_host)
            maskv_dev = self._upload(maskv)
            event = None
            if self._copy_stream is not None:
                event = torch.cuda.Event()
                event.record(self._copy_stream)
        with self._lock:
            if tx is not None:
                self._hot_data, self._hot_ids = tx
            self._offs_dev = offs
            self._szs_dev = szs
            self._maskv_dev = maskv_dev
            self._event = event
            self._version += 1
            hot = int((self._slot_of >= 0).sum())
        self._g_hot.set(float(hot))

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A fresh copy of a host mirror on the device: from a pinned
        tensor of its own on a card (the mirror may be rewritten by the
        next publish before a ``non_blocking`` copy lands; the pinned
        block is not reused until the copy has completed)."""
        t = torch.from_numpy(arr.copy())
        if not self._pin:
            return t
        return t.pin_memory().to(self._device, non_blocking=True)

    def __repr__(self) -> str:
        st = self.stats()
        return (f"TieredListStore(name={self.name!r}, "
                f"hot={st.hot_lists}/{st.n_lists} lists in "
                f"{st.n_slots} slots, hit_rate={st.hit_rate:.3f}, "
                f"fetches={st.fetches}, epoch={st.epoch})")


# -- helpers -----------------------------------------------------------------
def _read_on_current_stream(snap: TierRuntime) -> None:
    """Order the current stream after the publish that made ``snap``, and
    mark the snapshot's tensors as used by it, so the caching allocator
    keeps them from a new owner until this stream's work on them is
    done (no host sync either way)."""
    if snap.event is None:
        return
    stream = torch.cuda.current_stream(snap.view.data_sorted.device)
    stream.wait_event(snap.event)
    st = snap.view.storage
    for t in (snap.view.data_sorted, st.sorted_ids, st.list_offsets,
              st.list_sizes, snap.row_mask):
        t.record_stream(stream)


def _host_copy(t: torch.Tensor, pin: bool) -> torch.Tensor:
    """A host copy of ``t`` (pinned when ``pin``)."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
    out.copy_(t)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel() * t.element_size())


def _resolve_base(index):
    """``(flat_view, dequant, origin)`` for an IVFFlatIndex or an
    IVFSQIndex (tiered through its int8 code view — bytes quarter in
    both tiers and on the bus)."""
    from raft_tpu_torch.spatial.ann.ivf_sq import IVFSQIndex, _flat_view

    if isinstance(index, IVFSQIndex):
        return _flat_view(index), (index.vmin.float(),
                                   index.vscale.float()), index
    errors.expects(
        isinstance(index, IVFFlatIndex),
        "TieredListStore: expected an IVFFlatIndex or IVFSQIndex, "
        "got %s", type(index).__name__,
    )
    return index, None, index


def _resolve_slots(n_slots, budget, L, d, itemsize, n_lists) -> int:
    errors.expects(
        (n_slots is None) != (budget is None),
        "TieredListStore: pass exactly one of n_slots / "
        "hbm_budget_bytes",
    )
    if n_slots is None:
        slab = L * d * itemsize
        n_slots = max(1, int(budget) // slab)
    errors.expects(int(n_slots) >= 1,
                   "TieredListStore: n_slots=%d < 1", int(n_slots))
    return min(int(n_slots), n_lists)


def _id_recall(got: np.ndarray, ref: np.ndarray) -> float:
    """Mean per-query id overlap |got ∩ ref| / |ref| (invalid -1 rows
    excluded from the reference — a reference that itself found fewer
    than k rows never penalizes the tier)."""
    n = got.shape[0]
    tot, denom = 0.0, 0
    for i in range(n):
        r = set(int(x) for x in ref[i] if int(x) >= 0)
        if not r:
            continue
        g = set(int(x) for x in got[i] if int(x) >= 0)
        tot += len(g & r) / len(r)
        denom += 1
    return tot / denom if denom else 1.0
