"""Set-associative vector cache — the port of ``raft_tpu/cache/cache.py``,
analog of cpp/include/raft/cache/cache_util.cuh:45-334 (``get_vecs``,
``store_vecs``, ``assign_cache_idx``, ``rank_set_entries``): an LRU-ish
cache of feature vectors keyed by integer id, used to avoid recomputing
expensive per-vector work (the reference's use case is SVM kernel
columns; the serving tier's is the hot-traffic result cache,
raft_tpu_torch/serving/result_cache.py).

State is three tensors on the cache's device — ``keys`` and ``time``
(n_sets, assoc) int32, ``store`` (n_sets, assoc, dim) — and each operation
(probe, insert with LRU victims, evict) is a short run of tensor
operations on that device with no host branching, the JAX package's
three jitted bodies as plain PyTorch. The JAX bodies rebind their
results out of place; the port writes its scatters in place.

Scatter order is made explicit: where two rows of one call write the
same (set, lane) slot, the LATER row's values land (the order the JAX
package's scatters apply on its CPU reference), on every device — a
CUDA ``index_put_`` with duplicate indices would pick a winner at
random, so each scatter first keeps only the last writer of a slot.

Thread safety: this class holds NO lock on purpose; concurrent callers
serialize externally — the result cache does it under
``ResultCache._lock``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.device import resolve_device

__all__ = ["VectorCache"]

_INT32_MAX = torch.iinfo(torch.int32).max


def _last_writers(sets, lane, assoc: int, n_slots: int):
    """Rows of a scatter to (sets, lane) that no later row overwrites."""
    slot = sets.long() * assoc + lane.long()
    order = torch.arange(slot.shape[0], device=slot.device)
    last = torch.full((n_slots,), -1, dtype=torch.long, device=slot.device)
    last.scatter_reduce_(0, slot, order, reduce="amax")
    return last[slot] == order


def _scatter(dst, sets, lane, vals):
    """``dst[sets, lane] = vals`` with the later row winning a shared slot
    (the write is made in place)."""
    keep = _last_writers(sets, lane, dst.shape[1], dst.shape[0] * dst.shape[1])
    dst[sets[keep].long(), lane[keep].long()] = vals[keep]


def _first_true(mask):
    """Index of the first True along the last axis (0 when none is),
    like ``jnp.argmax`` of a boolean row."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def _get_impl(keys, time, store, q, clock: int):
    """(vecs, found): gather hits + LRU touch of ``time`` in place."""
    n_sets = keys.shape[0]
    sets = torch.remainder(q, n_sets)
    lane_keys = keys[sets.long()]                   # (q, assoc)
    hit = lane_keys == q[:, None]
    found = hit.any(dim=1)
    lane = _first_true(hit)
    vecs = store[sets.long(), lane]
    vecs = torch.where(found[:, None], vecs, torch.zeros_like(vecs))
    touched = torch.where(found, torch.full_like(q, clock),
                          time[sets.long(), lane])
    _scatter(time, sets, lane, touched)
    return vecs, found


def _store_impl(keys, time, store, k, v, clock: int):
    """Ranked placement of (k, v), in place."""
    n_sets, assoc = keys.shape
    b = k.shape[0]
    dev = keys.device
    sets = torch.remainder(k, n_sets)
    lane_keys = keys[sets.long()]
    hit = lane_keys == k[:, None]
    found = hit.any(dim=1)
    hit_lane = _first_true(hit)
    # lanes being UPDATED by this batch are not victims: a key-update
    # and a new-key insert in the same set must never write one slot
    hit_mask = torch.zeros(keys.shape, dtype=torch.bool, device=dev)
    hit_mask[sets[found].long(), hit_lane[found]] = True
    time_rank = torch.where(hit_mask, torch.full_like(time, _INT32_MAX),
                            time)
    # within-batch rank among NEW keys targeting the same set (the
    # two-pass stable-sort idiom; update rows sort into a sentinel group
    # so they consume no victim rank) -> the rank-th LRU lane, so two
    # colliding inserts never overwrite each other's slot
    sets_rank = torch.where(found, torch.full_like(sets, n_sets), sets)
    ss, order = torch.sort(sets_rank, stable=True)
    starts = torch.searchsorted(
        ss, torch.arange(n_sets, dtype=ss.dtype, device=dev)
    ).to(torch.int32)
    within = torch.empty((b,), dtype=torch.int32, device=dev)
    within[order] = (torch.arange(b, dtype=torch.int32, device=dev)
                     - starts[torch.clamp(ss, 0, n_sets - 1).long()])
    lru = torch.sort(time_rank[sets.long()], dim=1, stable=True).indices
    victim = torch.gather(
        lru, 1, torch.remainder(within, assoc).long()[:, None])[:, 0]
    lane = torch.where(found, hit_lane, victim)
    # duplicate keys collapse: later occurrences write the FIRST
    # occurrence's lane (the last write lands there)
    first_idx = _first_true(k[None, :] == k[:, None])
    lane = lane[first_idx]              # (duplicates share a set too)
    _scatter(keys, sets, lane, k)
    _scatter(time, sets, lane, torch.full_like(k, clock))
    _scatter(store, sets, lane, v)


def _evict_impl(keys, k):
    n_sets = keys.shape[0]
    sets = torch.remainder(k, n_sets)
    hit = keys[sets.long()] == k[:, None]
    lane = _first_true(hit)
    found = hit.any(dim=1)
    cur = keys[sets.long(), lane]
    _scatter(keys, sets, lane, torch.where(found, torch.full_like(cur, -1),
                                           cur))


class VectorCache:
    """n_sets × associativity cache of (dim,) vectors on ``device``.

    Keys map to set ``key % n_sets``; victims are chosen by least-recent
    use within the set (reference rank_set_entries ranks by time).
    ``device=None`` is the CUDA card (raises without one); pass
    ``device="cpu"`` to keep the cache on the host.
    """

    def __init__(self, dim: int, n_sets: int = 256, associativity: int = 8,
                 dtype=torch.float32, device=None):
        self.dim = dim
        self.n_sets = n_sets
        self.assoc = associativity
        self.device = resolve_device(device)
        self.keys = torch.full((n_sets, associativity), -1,
                               dtype=torch.int32, device=self.device)
        self.time = torch.zeros((n_sets, associativity), dtype=torch.int32,
                                device=self.device)
        self.store = torch.zeros((n_sets, associativity, dim), dtype=dtype,
                                 device=self.device)
        self.clock = 0

    def _keys(self, keys) -> torch.Tensor:
        return torch.as_tensor(keys, device=self.device).to(
            torch.int32).reshape(-1)

    @property
    def n_cached(self) -> int:
        return int((self.keys >= 0).sum())

    def get_vecs(self, query_keys) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fetch vectors for ``query_keys``; returns (vecs (q, dim), found
        (q,) bool) on the cache's device (reference get_vecs: gathers
        hits, reports misses)."""
        q = self._keys(query_keys)
        self.clock += 1
        return _get_impl(self.keys, self.time, self.store, q, self.clock)

    def store_vecs(self, store_keys, vecs) -> None:
        """Insert vectors, evicting least-recently-used entries of each
        target set (reference store_vecs + assign_cache_idx). DISTINCT
        keys mapping to the same set within one call claim DISTINCT
        victim lanes (their within-batch rank indexes the set's LRU
        order — the reference's rank_set_entries/assign_cache_idx
        contract; beyond the associativity they wrap and overwrite).
        Duplicate keys within one call collapse to a single slot, which
        holds the last occurrence's vector."""
        k = self._keys(store_keys)
        v = torch.as_tensor(vecs, device=self.device).to(self.store.dtype)
        self.clock += 1
        _store_impl(self.keys, self.time, self.store, k, v, self.clock)

    def evict(self, keys) -> None:
        """Invalidate entries (no direct reference analog; utility)."""
        _evict_impl(self.keys, self._keys(keys))
