"""Replica-routed online mutation for the sharded IVF engines — the port
of ``raft_tpu/comms/mnmg_mutation.py``, the sharded tier of the mutation
subsystem (single-device tier: :mod:`raft_tpu_torch.spatial.ann.mutation`).

Write path (control plane, host-routed like the builds): an upsert is
assigned to its nearest global centroid (``kmeans_predict``, ties to the
lowest), and the row is appended to the owning shard's delta segment on
EVERY holder rank of that shard
(:class:`~raft_tpu_torch.resilience.ReplicaPlacement` — the striped
layout the slabs replicate under). A write is ACKNOWLEDGED only when
every LIVE holder recorded it, so an acknowledged upsert survives the
failure of any single rank mid-ingest: the surviving replica keeps
serving it through the same runtime ``failover`` route the main slabs
use, and :func:`resync_rank` copies the recovered rank's mutation slabs
back from a live replica peer — the mutation-tier sibling of
``recover_rank``'s checkpoint splice. Deletes tombstone the row on ALL
holder ranks (dead ones included — their state is resynced anyway), so a
delete routed while a rank is down masks the row on the serving replica
too.

Read path: every sharded search takes ``mutation=`` and its rank body
folds the rank's tombstone mask into the shard's scan and merges an
exact scan of the rank's delta segments before the cross-shard merge
(:func:`~.mnmg_ivf._merge_local_delta`). Every mutation operand is a
runtime value: upserts, tombstone flips and health or failover flips
change values only, never the search's code path.

The write path reads and writes every rank's state on the host, so it
runs where every rank is local (the in-process communicator). Compaction
at sharded scale is the rebuild/reshard path: drain the deltas through a
``mnmg_*_build_distributed``.

Durability: :class:`MnmgDurableIngest` fronts the write path with one
:class:`~raft_tpu_torch.durability.wal.WalWriter` per rank under a
shared root, a coordinator-assigned GLOBAL LSN stream, and quorum acks —
a row is acked only when its batch's frame is fsync-durable on the row's
primary holder AND a quorum of its live replica holders.
:func:`mnmg_recover` repairs every rank's torn tail, takes the UNION of
the per-rank logs (deduplicated by LSN — each batch replays once however
many holders journaled it), and replays in LSN order, which heals a rank
whose log stops early from any holder that got the frame down.
"""

from __future__ import annotations

import dataclasses
import os
import typing

import numpy as np
import torch

from raft_tpu_torch import errors
from raft_tpu_torch.analysis.threads import runtime as lockcheck
from raft_tpu_torch.cluster.kmeans import kmeans_predict
from raft_tpu_torch.comms.mnmg_ivf import _np, _place_sharded, _tensor
from raft_tpu_torch.durability import wal as _wal
from raft_tpu_torch.resilience.degraded import resolve_shard_mask
from raft_tpu_torch.resilience.replica import ReplicaPlacement

__all__ = [
    "MnmgDurableIngest",
    "MnmgMutationState",
    "MnmgMutableIndex",
    "mnmg_delete",
    "mnmg_mutable_search",
    "mnmg_recover",
    "mnmg_upsert",
    "resync_rank",
    "wrap_mnmg_mutable",
]


@dataclasses.dataclass
class MnmgMutationState:
    """Per-rank mutation slabs with a leading axis over the ranks, like
    every other sharded field. ``delta_vecs`` / ``delta_ids`` flatten
    each rank's ``(nl_pad, cap)`` delta segments to one ``(nl_pad *
    cap,)`` scan axis (``nl_pad`` already holds the R replica segments,
    so replica copies of a shard's delta rows sit at the same local-list
    offsets as its main slabs); ``-1`` ids are empty or tombstoned
    slots. ``row_mask`` is the per-rank live mask over main-slab
    positions."""

    row_mask: typing.Any      # (P, n_pad + 1) int8
    delta_vecs: typing.Any    # (P, nl_pad * cap, d) f32
    delta_ids: typing.Any     # (P, nl_pad * cap) int32
    delta_counts: typing.Any  # (P, nl_pad) int32
    cap: int


def _n_index_ranks(index) -> int:
    v = index.sorted_ids
    return len(v) if isinstance(v, (list, tuple)) else int(v.shape[0])


@dataclasses.dataclass
class MnmgMutableIndex:
    """A sharded index plus its mutation state (with the host-side map
    from row id to main-slab positions the write path routes deletes
    through). Pass it, or ``.state``, as the searches' ``mutation=``."""

    index: typing.Any
    state: MnmgMutationState

    def __post_init__(self):
        # (ids sorted, their ranks, their slab positions) over every
        # replica copy of the main slabs, built on first use
        self._id_loc: typing.Optional[tuple] = None

    @property
    def placement(self) -> ReplicaPlacement:
        return ReplicaPlacement(
            n_ranks=_n_index_ranks(self.index),
            replication=int(getattr(self.index, "replication", 1) or 1),
            offset=int(getattr(self.index, "replica_offset", 1) or 1),
        )

    def _locations(self):
        if self._id_loc is None:
            sids = _np(self.index.sorted_ids)
            offs = _np(self.index.list_offsets)
            ids, ranks, pos = [], [], []
            for r in range(sids.shape[0]):
                n = int(offs[r, -1])
                ids.append(sids[r, :n].astype(np.int64))
                ranks.append(np.full(n, r, np.int64))
                pos.append(np.arange(n, dtype=np.int64))
            ids = np.concatenate(ids)
            # stable: an id's copies stay in (rank, position) order
            order = np.argsort(ids, kind="stable")
            self._id_loc = (ids[order], np.concatenate(ranks)[order],
                            np.concatenate(pos)[order])
        return self._id_loc

    def locate(self, ids):
        """Every main-slab copy of each id in ``ids``: returns (the index
        into ``ids`` of each copy, its rank, its slab position), grouped
        by id in batch order, each id's copies in (rank, position)
        order (the reference's ``id_locations`` map, vectorized). Delta
        rows are matched by value instead. The main slabs never change
        between rebuilds, so the map is stable across upserts and
        deletes."""
        s_ids, rk, ps = self._locations()
        ids = np.asarray(ids, np.int64)
        lo = np.searchsorted(s_ids, ids, "left")
        cnt = np.searchsorted(s_ids, ids, "right") - lo
        which = np.repeat(np.arange(ids.shape[0]), cnt)
        start = np.repeat(np.cumsum(cnt) - cnt, cnt)
        at = np.repeat(lo, cnt) + np.arange(int(cnt.sum())) - start
        return which, rk[at], ps[at]


def _with_state(mindex: MnmgMutableIndex,
                state: MnmgMutationState) -> MnmgMutableIndex:
    out = MnmgMutableIndex(index=mindex.index, state=state)
    out._id_loc = mindex._id_loc            # main slabs unchanged
    return out


def _check_local(comms, what: str) -> None:
    errors.expects(
        len(comms.local_ranks) == comms.size,
        "%s: the sharded write path reads every rank's state on the host; "
        "run it where every rank is local (ranks %s of %d here)", what,
        tuple(comms.local_ranks), comms.size,
    )


def _place_state(comms, rm, dv, di, dc, cap) -> MnmgMutationState:
    return MnmgMutationState(
        row_mask=_place_sharded(comms, rm),
        delta_vecs=_place_sharded(comms, dv),
        delta_ids=_place_sharded(comms, di),
        delta_counts=_place_sharded(comms, dc),
        cap=int(cap),
    )


def wrap_mnmg_mutable(comms, index, *,
                      delta_cap: int = 16) -> MnmgMutableIndex:
    """Wrap a sharded (PQ, Flat or SQ) index for online mutation: empty
    per-rank delta slabs of ``delta_cap`` rows per local list and an
    all-live row mask, placed on the ranks' devices. The index's own
    slabs are shared, not copied. Delta rows are stored as exact f32 on
    every engine (SQ and PQ included: a fresh row serves at full
    precision until a rebuild folds it)."""
    errors.expects(delta_cap >= 1, "delta_cap=%d < 1", delta_cap)
    _check_local(comms, "wrap_mnmg_mutable")
    Pn = _n_index_ranks(index)
    errors.expects(
        Pn == comms.size,
        "wrap_mnmg_mutable: index has %d ranks, communicator %d", Pn,
        comms.size,
    )
    d = int(index.centroids.shape[1])
    nlp = int(index.nl_pad)
    state = _place_state(
        comms,
        np.ones((Pn, index.n_pad + 1), np.int8),
        np.zeros((Pn, nlp * delta_cap, d), np.float32),
        np.full((Pn, nlp * delta_cap), -1, np.int32),
        np.zeros((Pn, nlp), np.int32),
        delta_cap,
    )
    return MnmgMutableIndex(index=index, state=state)


def _pull_state(state: MnmgMutationState):
    """Host copies of the four slabs (the write path edits these)."""
    return tuple(np.array(_np(v)) for v in (
        state.row_mask, state.delta_vecs, state.delta_ids,
        state.delta_counts))


def _nearest_lists(index, vecs: np.ndarray) -> np.ndarray:
    """Each row's nearest global centroid (ties to the lowest), on the
    centroids' device."""
    cents = torch.as_tensor(index.centroids)
    lbl = kmeans_predict(_tensor(np.asarray(vecs, np.float32), cents.device),
                         cents.float())
    return lbl.cpu().numpy().astype(np.int64)


def mnmg_upsert(comms, mindex: MnmgMutableIndex, vectors, ids, *,
                alive=None):
    """Route an upsert batch to each row's owning shard AND its replica
    holders. Returns ``(new_mindex, accepted)``: ``accepted[i]`` is the
    ACK — the row is recorded on EVERY live holder of its shard (and at
    least one holder is live), so no single later rank failure can lose
    it. Rows routed to a full segment, to an unowned (owner -1) centroid,
    or with a negative id are rejected, and a rejected row is a strict
    no-op (its previous copy keeps serving).

    ``alive``: anything ``resolve_shard_mask`` accepts; writes skip dead
    holders, and :func:`resync_rank` brings a recovered rank's slabs
    back from a live peer. Functional: ``mindex`` is left as it was."""
    _check_local(comms, "mnmg_upsert")
    index = mindex.index
    vecs = np.asarray(_np(vectors), np.float32)
    ids_np = np.asarray(_np(ids)).astype(np.int32)
    errors.expects(
        vecs.ndim == 2 and vecs.shape[0] == ids_np.shape[0],
        "mnmg_upsert: vectors (%s) and ids (%s) disagree",
        tuple(vecs.shape), tuple(ids_np.shape),
    )
    B = ids_np.shape[0]
    Pn = comms.size
    alive_np = np.asarray(resolve_shard_mask(
        True if alive is None else alive, Pn))
    placement = mindex.placement
    R, off = placement.replication, placement.offset
    nlp_base = int(index.nl_pad) // R
    cap = mindex.state.cap
    owner = _np(index.owner)
    local_id = _np(index.local_id)
    lbl = _nearest_lists(index, vecs)
    own = owner[lbl]
    lid = local_id[lbl]
    valid = (ids_np >= 0) & (own >= 0)

    rm, dv, di, dc = _pull_state(mindex.state)

    # 1) plan acceptance first (no state touched): the ack needs a slot
    # on EVERY live holder and at least one live holder
    accepted = valid.copy()
    seen_live = np.zeros(B, bool)
    slot_of = np.full((B, R), -1, np.int64)
    fill: dict = {}                   # (rank, local list) -> next slot
    for i in range(B):
        if not accepted[i]:
            continue
        for j in range(R):
            rj = (int(own[i]) + j * off) % Pn
            if not alive_np[rj]:
                continue
            seen_live[i] = True
            ll = j * nlp_base + int(lid[i])
            base = fill.get((rj, ll), int(dc[rj, ll]))
            if base >= cap:
                accepted[i] = False
                break
            slot_of[i, j] = base
            fill[(rj, ll)] = base + 1
    accepted &= seen_live

    # 2) tombstone the previous MAIN copies of accepted ids (all holders)
    _, r_m, p_m = mindex.locate(ids_np[accepted])
    rm[r_m, p_m] = 0
    # 3) supersede the previous DELTA copies of accepted ids (all ranks)
    di[np.isin(di, ids_np[accepted])] = -1

    # 4) append to every live holder
    for i in np.nonzero(accepted)[0]:
        for j in range(R):
            s = int(slot_of[i, j])
            if s < 0:
                continue
            rj = (int(own[i]) + j * off) % Pn
            ll = j * nlp_base + int(lid[i])
            dv[rj, ll * cap + s] = vecs[i]
            di[rj, ll * cap + s] = ids_np[i]
            dc[rj, ll] += 1
    return (_with_state(mindex, _place_state(comms, rm, dv, di, dc, cap)),
            accepted)


def mnmg_delete(comms, mindex: MnmgMutableIndex, ids):
    """Tombstone-delete ids on EVERY replica copy — main-slab mask flips
    on all holder ranks and delta matches on all ranks, so the delete is
    visible whichever copy the failover route serves. Returns
    ``(new_mindex, found)``; an id repeated in the batch is found by its
    first occurrence in the main slabs (as deleting one at a time)."""
    _check_local(comms, "mnmg_delete")
    ids_np = np.asarray(_np(ids)).astype(np.int32)
    errors.expects(
        ids_np.ndim == 1, "mnmg_delete: expected a 1-d id batch, got %s",
        tuple(ids_np.shape),
    )
    rm, dv, di, dc = _pull_state(mindex.state)
    found = np.zeros(ids_np.shape[0], bool)
    pos = np.nonzero(ids_np >= 0)[0]
    which, r_m, p_m = mindex.locate(ids_np[pos])
    # only an id's first occurrence can find its live rows (the later
    # ones see them tombstoned already)
    _, first = np.unique(ids_np[pos], return_index=True)
    is_first = np.zeros(pos.shape[0], bool)
    is_first[first] = True
    hit = is_first[which] & (rm[r_m, p_m] != 0)
    found[pos[which[hit]]] = True
    rm[r_m, p_m] = 0
    dmatch = np.isin(di, ids_np[pos])
    if dmatch.any():
        found |= np.isin(ids_np, np.unique(di[dmatch]))
        di[dmatch] = -1
    return (_with_state(mindex, _place_state(comms, rm, dv, di, dc,
                                             mindex.state.cap)),
            found)


def resync_rank(comms, mindex: MnmgMutableIndex,
                rank: int) -> MnmgMutableIndex:
    """Restore one recovered rank's MUTATION slabs from a live replica
    peer — the companion of :func:`~.mnmg_ivf.recover_rank`, which
    splices the main slabs from a checkpoint: for every slab segment the
    rank holds, copy the logical shard's delta rows, counts and per-list
    tombstone mask from another holder of that shard. After
    ``recover_rank`` + ``resync_rank`` the healed rank equals its peers
    byte for byte, and the route can flip back to primaries with no
    acknowledged write lost."""
    _check_local(comms, "resync_rank")
    index = mindex.index
    Pn = comms.size
    errors.expects(0 <= rank < Pn,
                   "resync_rank: rank %d out of range [0, %d)", rank, Pn)
    placement = mindex.placement
    R = placement.replication
    errors.expects(
        R > 1,
        "resync_rank: index is unreplicated (R=1) — a lost rank's "
        "mutation state has no surviving copy; restore it from a delta "
        "checkpoint instead",
    )
    nlp_base = int(index.nl_pad) // R
    cap = mindex.state.cap
    rm, dv, di, dc = _pull_state(mindex.state)
    loffs = _np(index.list_offsets)
    lszs = _np(index.list_sizes)
    for j, s in enumerate(placement.segments(rank)):
        holders = placement.holders(s)
        donor = next((int(r) for r in holders if int(r) != rank), None)
        errors.expects(donor is not None,
                       "resync_rank: shard %d has no other holder", s)
        j2 = holders.index(donor)
        for lid_ in range(nlp_base):
            ll, ll2 = j * nlp_base + lid_, j2 * nlp_base + lid_
            dv[rank, ll * cap:(ll + 1) * cap] = \
                dv[donor, ll2 * cap:(ll2 + 1) * cap]
            di[rank, ll * cap:(ll + 1) * cap] = \
                di[donor, ll2 * cap:(ll2 + 1) * cap]
            dc[rank, ll] = dc[donor, ll2]
            sz = int(lszs[rank, ll])
            o_d, o_s = int(loffs[rank, ll]), int(loffs[donor, ll2])
            rm[rank, o_d:o_d + sz] = rm[donor, o_s:o_s + sz]
    return _with_state(mindex, _place_state(comms, rm, dv, di, dc, cap))


def mnmg_mutable_search(comms, mindex: MnmgMutableIndex, queries, k: int,
                        **kw):
    """Search a mutable sharded index: the engine's search with
    ``mutation=`` engaged (tombstones folded into each shard's scan,
    delta segments exactly scanned and merged before the cross-shard
    merge). Every other knob — ``shard_mask`` / ``failover``, ``qcap``,
    ``merge_ways``, ``use_kernel`` — passes through unchanged."""
    from raft_tpu_torch.comms.mnmg_ivf import (
        MnmgIVFPQIndex,
        mnmg_ivf_pq_search,
    )
    from raft_tpu_torch.comms.mnmg_ivf_flat import (
        MnmgIVFSQIndex,
        mnmg_ivf_flat_search,
        mnmg_ivf_sq_search,
    )

    if isinstance(mindex.index, MnmgIVFPQIndex):
        search = mnmg_ivf_pq_search
    elif isinstance(mindex.index, MnmgIVFSQIndex):
        search = mnmg_ivf_sq_search
    else:
        search = mnmg_ivf_flat_search
    return search(comms, mindex.index, queries, k, mutation=mindex.state,
                  **kw)


# ----------------------------------------------------------- durability
def _rank_wal_dir(root, rank: int) -> str:
    return os.path.join(root, f"rank-{rank:02d}")


def _row_holders(index, placement, vecs: np.ndarray) -> np.ndarray:
    """(B, R) holder ranks per row (owner first, then replicas; -1 for an
    unowned centroid) — the durability quorum's membership."""
    R, off = placement.replication, placement.offset
    Pn = _n_index_ranks(index)
    own = _np(index.owner)[_nearest_lists(
        index, np.asarray(vecs, np.float32))]
    holders = np.full((vecs.shape[0], R), -1, np.int64)
    for j in range(R):
        holders[:, j] = np.where(own >= 0, (own + j * off) % Pn, -1)
    return holders


class MnmgDurableIngest:
    """Per-rank WAL and quorum-acked ingest for a sharded mutable index.

    One :class:`~raft_tpu_torch.durability.wal.WalWriter` per rank under
    ``wal_root/rank-XX``; the coordinator assigns one GLOBAL LSN per
    batch and journals the batch on every LIVE holder rank it touches
    (per-rank logs are sparse: gaps are fine, replay is monotone). A
    row's ack needs its frame fsync-durable on the row's PRIMARY holder
    (its first live holder, the rank that serves it) and on at least
    ``quorum`` of its other live holders (default: all of them, as
    :func:`mnmg_upsert` accepts); a rank whose WAL has failed stops
    counting toward quorums. Recovery is :func:`mnmg_recover`. Host-side
    control plane only: the serving read path is untouched."""

    def __init__(self, comms, mindex: MnmgMutableIndex, wal_root, *,
                 quorum: typing.Optional[int] = None,
                 name: str = "mnmg-wal", flight=None, **wal_kw):
        R = mindex.placement.replication
        self._quorum = (R - 1) if quorum is None else int(quorum)
        errors.expects(
            0 <= self._quorum <= R - 1,
            "MnmgDurableIngest: quorum=%d outside [0, R-1=%d]",
            self._quorum, R - 1,
        )
        self._comms = comms
        self._mindex = mindex
        self._name = name
        self._flight = flight
        self._lock = lockcheck.make_lock("MnmgDurableIngest._lock")
        self._wals = {
            r: _wal.WalWriter(_rank_wal_dir(wal_root, r),
                              name=f"{name}-r{r:02d}", flight=flight,
                              **wal_kw)
            for r in range(comms.size)
        }
        frontier = max(w.durable_lsn for w in self._wals.values())
        self._next_lsn = frontier + 1
        self._applied_lsn = frontier

    @property
    def mindex(self) -> MnmgMutableIndex:
        with self._lock:
            return self._mindex

    @property
    def applied_lsn(self) -> int:
        with self._lock:
            return self._applied_lsn

    def frontiers(self) -> dict:
        """Per-rank durable LSN frontier: lagging ranks (a dead WAL, a
        crash before fsync) show here; :func:`mnmg_recover` reconciles
        them from the union of the healthy logs."""
        return {r: w.durable_lsn for r, w in self._wals.items()}

    def _journal(self, ranks, op: int, payload: bytes, lsn: int):
        """Append one frame to each rank's WAL; a rank whose writer
        raises (failed disk, closed) is absent from the returned
        ``{rank: ack}`` map — it can no longer hold quorum."""
        acks = {}
        for r in sorted(ranks):
            try:
                acks[r] = self._wals[r].append(op, payload, lsn=lsn,
                                               epoch=0)
            except Exception:
                continue
        return acks

    @staticmethod
    def _durable_ranks(acks: dict, timeout_s: float = 30.0) -> set:
        durable = set()
        for r, ack in acks.items():
            try:
                if ack.wait(timeout_s):
                    durable.add(r)
            except Exception:
                continue
        return durable

    def upsert(self, vectors, ids, *, alive=None) -> np.ndarray:
        """Journal and apply one upsert batch; returns the ACK mask:
        accepted by :func:`mnmg_upsert` AND fsync-durable on the primary
        and a quorum of live replica holders. A row applied but not
        acked is not half-applied: recovery replays it in full from
        whichever holder journaled it, or not at all; the caller retries
        un-acked rows (an upsert supersedes its own previous copy)."""
        vecs = np.ascontiguousarray(np.asarray(_np(vectors), np.float32))
        ids_np = np.asarray(_np(ids)).astype(np.int32)
        payload = _wal.encode_upsert(vecs, ids_np)
        Pn = self._comms.size
        alive_np = np.asarray(resolve_shard_mask(
            True if alive is None else alive, Pn))
        with self._lock:
            holders = _row_holders(self._mindex.index,
                                   self._mindex.placement, vecs)
            involved = {int(r) for r in np.unique(holders)
                        if r >= 0 and alive_np[int(r)]}
            lsn = self._next_lsn
            self._next_lsn += 1
            acks = self._journal(involved, _wal.OP_UPSERT, payload, lsn)
            self._mindex, accepted = mnmg_upsert(
                self._comms, self._mindex, vecs, ids_np, alive=alive_np)
            self._applied_lsn = lsn
        durable = self._durable_ranks(acks)
        acked = np.asarray(accepted, bool).copy()
        for i in np.nonzero(acked)[0]:
            live_h = [int(r) for r in holders[i]
                      if r >= 0 and alive_np[int(r)]]
            if not live_h:
                acked[i] = False
                continue
            need = min(1 + self._quorum, len(live_h))
            n_dur = sum(1 for r in live_h if r in durable)
            acked[i] = live_h[0] in durable and n_dur >= need
        return acked

    def delete(self, ids, *, alive=None) -> np.ndarray:
        """Journal and apply one delete batch; returns ``found`` masked
        by durability (a tombstone is acked only when journaled on a
        quorum of live ranks — a delete touches every holder, so the
        batch is journaled on every live rank)."""
        ids_np = np.asarray(_np(ids)).astype(np.int32)
        payload = _wal.encode_delete(ids_np)
        Pn = self._comms.size
        alive_np = np.asarray(resolve_shard_mask(
            True if alive is None else alive, Pn))
        live = [r for r in range(Pn) if alive_np[r]]
        with self._lock:
            lsn = self._next_lsn
            self._next_lsn += 1
            acks = self._journal(live, _wal.OP_DELETE, payload, lsn)
            self._mindex, found = mnmg_delete(self._comms, self._mindex,
                                              ids_np)
            self._applied_lsn = lsn
        durable = self._durable_ranks(acks)
        need = min(1 + self._quorum, max(len(live), 1))
        if len(durable) < need:
            return np.zeros_like(np.asarray(found, bool))
        return np.asarray(found, bool)

    def close(self) -> None:
        for w in self._wals.values():
            try:
                w.close()
            except Exception:
                continue


def mnmg_recover(comms, mindex: MnmgMutableIndex, wal_root, *,
                 start_lsn: int = 0, name: str = "mnmg-wal", flight=None):
    """Fleet crash recovery: repair every rank's WAL tail, take the UNION
    of the per-rank logs (a batch journaled on several holders replays
    once), and replay in LSN order onto ``mindex`` (the re-placed base
    state). The union reconciles per-rank frontiers: a rank whose log
    stops early (crashed before its fsync) is healed by any holder that
    got the frame down — the quorum the ack demanded. Returns
    ``(mindex, frontiers, n_replayed)`` with the per-rank frontier map
    before repair, for audit."""
    frontiers = {}
    union: dict = {}
    for r in range(comms.size):
        d = _rank_wal_dir(wal_root, r)
        if not os.path.isdir(d):
            frontiers[r] = 0
            continue
        records, frontier = _wal.repair_wal(d, name=f"{name}-r{r:02d}",
                                            flight=flight)
        frontiers[r] = frontier
        for rec in records:
            union.setdefault(rec.lsn, rec)
    last = int(start_lsn)
    n = 0
    for lsn in sorted(union):
        if lsn <= last:
            continue
        rec = union[lsn]
        if rec.op == _wal.OP_UPSERT:
            vecs, ids = _wal.decode_upsert(rec.payload)
            mindex, _ = mnmg_upsert(comms, mindex, vecs, ids)
        elif rec.op == _wal.OP_DELETE:
            mindex, _ = mnmg_delete(comms, mindex,
                                    _wal.decode_delete(rec.payload))
        else:
            raise errors.CorruptIndexError(
                f"mnmg_recover: unknown op {rec.op} at lsn {rec.lsn}",
                field="op",
            )
        last = lsn
        n += 1
    _wal.series(name)["replayed"].inc(n)
    return mindex, frontiers, n
