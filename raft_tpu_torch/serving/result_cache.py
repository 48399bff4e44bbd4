"""Semantic query-result cache for the hot-traffic serving tier — the
port of ``raft_tpu/serving/result_cache.py`` (docs/serving.md "Hot
traffic"), over the port's :class:`~raft_tpu_torch.cache.VectorCache`,
whose tiers live on the cache's device (the host by default).

Real million-user traffic is Zipf-skewed: a small set of hot queries
recurs constantly, yet the serving path re-runs the full IVF pipeline
for every arrival. This module caches FINISHED ``(dists, ids)`` results
keyed on a quantized query signature, in two tiers:

* **Exact tier** — a 64-bit content hash of the query's float32 bytes:
  a hit is bitwise the same query, so serving the cached rows is
  result-identical to re-dispatching (no recall question).
* **Semantic tier** — the coarse-probe SUPER-CENTROID ids
  (:class:`CentroidSigner`, the key of the JAX package's
  ``two_level_probe``): two queries whose top super clusters agree
  land in the same cache line, so a near-duplicate of a hot query hits
  too. Semantic hits return ANOTHER query's rows, so they are gated
  behind a MEASURED recall guardrail (:meth:`ResultCache.
  calibrate_semantic`) and disabled by default.

Both tiers are backed by :class:`raft_tpu_torch.cache.VectorCache` — the
set-associative LRU of the reference's ``cache_util.cuh`` lineage,
repurposed: one cached result is one fixed-width int32 payload vector
``[sig_lo, sig_hi, epoch, dists_bits(k), ids(k)]`` (float32 distance
bits are stored BIT-CAST so the round trip is exact; the full 64-bit
signature rides in the payload, so a 31-bit set-key collision can
never serve another query's rows — the payload verifies before a hit
counts). A bounded per-request **L1 hash front** sits above the exact
tier: the VectorCache probe is a run of device operations and a copy
back, cheap next to a big serving dispatch but NOT next to a saturated
program's per-row cost — the hot-head exact path is a host hash map,
with the tiers underneath catching regrouped rows, L1
evictions, and everything semantic.

**Invalidation is by mutation epoch**, not by key: every entry is
stamped with the writer's epoch (the JAX package's
``MutableIndex.epoch`` — bumped by every applied upsert/delete batch and
by compaction; a frozen index serves at a constant 0), and a lookup that presents a NEWER epoch treats the
entry as stale: counted, evicted, and re-served fresh. One integer
compare makes every pre-write result die on the first post-write
lookup — no enumeration of affected keys, no cross-thread flush.

Counters (``serving_result_cache_total{cache,result=hit|semantic_hit|
miss|stale}``, ``serving_result_cache_inserts_total``) land in the
:mod:`raft_tpu_torch.obs` registry; the executor adds span events per hit
(docs/observability.md).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import errors
from raft_tpu_torch.analysis.threads import runtime as lockcheck
from raft_tpu_torch.cache import VectorCache
from raft_tpu_torch.obs import metrics as obs_metrics

__all__ = [
    "CentroidSigner",
    "ResultCache",
    "ResultCacheStats",
    "exact_signatures",
    "semantic_recall",
]

# payload layout (int32 words): full 64-bit signature (2 words, the
# collision guard), the writer's mutation epoch (1 word), then k
# bit-cast float32 distances and k int32 ids
_N_META = 3


def _fold_key(sig_lo: np.ndarray) -> np.ndarray:
    """The VectorCache set key for a signature: low word masked into
    [0, 2^31) — non-negative (−1 is the cache's empty sentinel), full
    64 bits still verified against the payload on every hit."""
    return (sig_lo & np.int32(0x7FFFFFFF)).astype(np.int32)


def exact_signatures(rows: np.ndarray, salt: bytes = b"") -> np.ndarray:
    """Per-row 64-bit content signatures of a ``(m, d)`` float32 batch:
    ``blake2b`` over each row's bytes (plus ``salt`` — the cache mixes
    its ``k`` in, so the same vector asked at a different k can never
    alias). Returns ``(m, 2)`` int32 — the (lo, hi) words stored in and
    verified against the payload."""
    rows = np.ascontiguousarray(rows, np.float32)
    errors.expects(rows.ndim == 2,
                   "exact_signatures: expected (m, d) rows, got %s",
                   tuple(rows.shape))
    out = np.empty((rows.shape[0], 2), np.int32)
    for i in range(rows.shape[0]):
        dig = hashlib.blake2b(rows[i].tobytes() + salt,
                              digest_size=8).digest()
        out[i] = np.frombuffer(dig, np.int32)
    return out


class CentroidSigner:
    """The semantic signature: a query row's top super-centroid ids.

    Scores rows against the ``(n_super, d)`` super-centroid set on the
    host (numpy — the set is ~sqrt(n_centroids) small, and the signer
    runs per submit, off the device hot path) and hashes the SORTED top
    ``n_probes`` super ids: two queries probing the same super clusters
    share a signature, which is exactly the granularity at which the
    IVF pipeline itself would have scanned the same lists. Coarser
    ``n_probes=1`` buckets more aggressively (higher hit rate, lower
    semantic recall); the guardrail decides whether that trade is
    servable (docs/serving.md "Hot traffic")."""

    def __init__(self, super_cents, n_probes: int = 2):
        sc = np.ascontiguousarray(super_cents, np.float32)
        errors.expects(sc.ndim == 2 and sc.shape[0] >= 1,
                       "CentroidSigner: expected (n_super, d) "
                       "super-centroids, got %s", tuple(sc.shape))
        errors.expects(n_probes >= 1,
                       "CentroidSigner: n_probes=%d < 1", n_probes)
        self.super_cents = sc
        self.n_probes = int(min(n_probes, sc.shape[0]))
        self._norms = np.einsum("sd,sd->s", sc, sc)

    @classmethod
    def from_coarse(cls, coarse, n_probes: int = 2) -> "CentroidSigner":
        """Build from any object with a ``super_cents`` array or tensor
        (on any device) — the port's or the JAX package's
        ``CoarseIndex``, the serving index's own two-level probe geometry
        (the signature then matches what the probe would scan)."""
        sc = coarse.super_cents
        if isinstance(sc, torch.Tensor):
            sc = sc.detach().cpu().numpy()
        return cls(np.asarray(sc), n_probes=n_probes)

    def super_ids(self, rows: np.ndarray) -> np.ndarray:
        """``(m, n_probes)`` SORTED top super ids per row (sorted so the
        signature is order-free — ties at equal distance cannot flip
        the key between two evaluations of the same vector)."""
        rows = np.ascontiguousarray(rows, np.float32)
        d2 = (
            self._norms[None, :]
            - 2.0 * rows @ self.super_cents.T
        )  # ||q||^2 is row-constant: drop it, argpartition is invariant
        p = self.n_probes
        if p >= d2.shape[1]:
            ids = np.tile(np.arange(d2.shape[1], dtype=np.int32),
                          (rows.shape[0], 1))
        else:
            ids = np.argpartition(d2, p - 1, axis=1)[:, :p]
        return np.sort(ids.astype(np.int32), axis=1)

    def __call__(self, rows: np.ndarray, salt: bytes = b"") -> np.ndarray:
        """Per-row 64-bit semantic signatures, ``(m, 2)`` int32."""
        ids = self.super_ids(rows)
        out = np.empty((ids.shape[0], 2), np.int32)
        for i in range(ids.shape[0]):
            dig = hashlib.blake2b(ids[i].tobytes() + b"sem" + salt,
                                  digest_size=8).digest()
            out[i] = np.frombuffer(dig, np.int32)
        return out


@dataclasses.dataclass(frozen=True)
class ResultCacheStats:
    """Point-in-time cache counters (monotonic)."""

    hits: int            # exact-tier row hits served
    semantic_hits: int   # semantic-tier row hits served
    misses: int          # rows that fell through to a real dispatch
    stale: int           # rows whose entry died on an epoch mismatch
    inserts: int         # rows written

    @property
    def hit_rate(self) -> float:
        served = self.hits + self.semantic_hits
        total = served + self.misses
        return served / total if total else 0.0


def semantic_recall(queries, search_fn, signer: CentroidSigner,
                    k: int) -> Optional[float]:
    """The MEASURED semantic-hit recall guardrail: for every pair of
    sample queries sharing a semantic signature, serve one query the
    OTHER's fresh top-k (exactly what a semantic hit does) and score
    id-overlap recall@k against its own fresh top-k. Returns the mean
    over all such ordered pairs, or None when no two sample queries
    collide (an unskewed sample cannot certify the tier — leave it
    disabled). ``search_fn(rows) -> (dists, ids)`` is the real warmed
    search; eager host work, an audit — never the serving path."""
    q = np.ascontiguousarray(queries, np.float32)
    _, ids = search_fn(q)
    ids = np.asarray(ids)[:, :k]
    sigs = signer(q)
    groups: dict = {}
    for i in range(q.shape[0]):
        groups.setdefault(tuple(sigs[i]), []).append(i)
    recalls = []
    for members in groups.values():
        for a in members:
            for b in members:
                if a == b:
                    continue
                mine = set(ids[a].tolist()) - {-1}
                if not mine:
                    continue
                served = set(ids[b].tolist())
                recalls.append(len(mine & served) / len(mine))
    return float(np.mean(recalls)) if recalls else None


class ResultCache:
    """The two-tier query-result cache (module docstring).

    ``k`` — the cached result width; lookups and inserts must use the
    same k (it is salted into every signature, so a k-8 entry can never
    answer a k-16 ask even across cache instances sharing storage).

    ``n_sets`` / ``associativity`` — the :class:`VectorCache` geometry
    of EACH tier (capacity = n_sets x associativity results; LRU within
    a set). ``signer`` — the semantic signer (None = exact tier only).

    ``semantic_min_recall`` — the guardrail floor
    :meth:`calibrate_semantic` must measure before semantic hits are
    served. The tier starts DISABLED: an uncalibrated semantic hit is
    an unbounded recall loss, and docs/serving.md lists the workloads
    where it should stay off.

    Thread-safe (one lock — submit threads look up while the drain
    thread inserts). Every lookup takes ``epoch`` as a required keyword
    so the call site visibly threads the current mutation epoch. Frozen
    serving threads a constant 0 and nothing ever goes stale.

    ``device`` — where both tiers' :class:`VectorCache` tensors live.
    The host (``"cpu"``, the default) is the faster place on an H100: a
    miss lookup takes 0.23 ms there against 0.73 ms on the card, an
    insert 0.53 against 1.58 ms (``tools/profile_executor.py``), since
    each call is a handful of small operations plus, on the card, a copy
    back. ``"cuda"`` (or ``None``, the card, raising without one) puts
    them where the JAX package keeps its cache, on the accelerator; the
    executor then fills them from a thread of its own. The L1 front is
    host memory either way.
    """

    def __init__(self, k: int, *, n_sets: int = 512,
                 associativity: int = 8,
                 signer: Optional[Callable] = None,
                 semantic_min_recall: float = 0.9,
                 name: str = "serving",
                 registry: "obs_metrics.MetricRegistry | None" = None,
                 device="cpu"):
        errors.expects(k >= 1, "ResultCache: k=%d < 1", k)
        self.k = int(k)
        self.dim = _N_META + 2 * self.k
        self.name = str(name)
        self.signer = signer
        self.semantic_min_recall = float(semantic_min_recall)
        self.semantic_enabled = False
        self.measured_semantic_recall: Optional[float] = None
        self._salt = b"k%d" % self.k
        self._lock = lockcheck.make_lock("ResultCache._lock")
        self._exact = VectorCache(self.dim, n_sets=n_sets,
                                  associativity=associativity,
                                  dtype=torch.int32, device=device)
        self.device = self._exact.device
        self._semantic = (
            VectorCache(self.dim, n_sets=n_sets,
                        associativity=associativity, dtype=torch.int32,
                        device=device)
            if signer is not None else None
        )
        # the L1 exact front: a bounded per-REQUEST OrderedDict-LRU of
        # (epoch, dists, ids) keyed on the request's signature bytes.
        # The VectorCache tiers are device operations and a copy back —
        # cheaper than a big serving dispatch, but NOT cheaper than a
        # saturated program's per-row cost, so the hot-head exact path
        # is a host hash map. The L1
        # mirrors every insert; misses (different request grouping of
        # cached rows, L1 evictions) still fall through to the per-row
        # exact tier, and the semantic tier lives only in its
        # VectorCache. Same capacity as one tier, same lock.
        self._l1: "collections.OrderedDict[bytes, tuple]" = \
            collections.OrderedDict()
        self._l1_cap = int(n_sets) * int(associativity)
        reg = (obs_metrics.default_registry()
               if registry is None else registry)
        self._c = {
            res: reg.counter("serving_result_cache_total",
                             cache=self.name, result=res)
            for res in ("hit", "semantic_hit", "miss", "stale")
        }
        self._c_inserts = reg.counter(
            "serving_result_cache_inserts_total", cache=self.name)
        self._hits = 0
        self._semantic_hits = 0
        self._misses = 0
        self._stale = 0
        self._inserts = 0

    # -- signatures ----------------------------------------------------------
    def signatures(self, rows) -> np.ndarray:
        """The per-row exact signatures of a request — also the
        COALESCING key material (the executor keys its in-flight
        duplicate map on these, so cache and coalescer can never
        disagree about what "the same query" means)."""
        return exact_signatures(np.asarray(rows, np.float32), self._salt)

    # -- the serving surface -------------------------------------------------
    def _l1_put(self, key: bytes, epoch: int, dists: np.ndarray,
                ids: np.ndarray) -> None:
        """Under _lock: (re)front one request in the L1 LRU. Stores
        private copies — callers own what lookup hands them."""
        self._l1[key] = (int(epoch), dists.copy(), ids.copy())
        self._l1.move_to_end(key)
        while len(self._l1) > self._l1_cap:
            self._l1.popitem(last=False)

    def _probe_tier(self, cache: VectorCache, sigs: np.ndarray,
                    epoch: int):
        """One tier's batched probe: returns (dists, ids, ok, stale_keys)
        — ok rows verified sig-exact AND epoch-fresh; stale_keys are the
        set keys whose entry matched the signature at an OLD epoch."""
        keys = _fold_key(sigs[:, 0])
        vecs, found = cache.get_vecs(keys)
        vecs = vecs.cpu().numpy()
        found = found.cpu().numpy()
        m = sigs.shape[0]
        k = self.k
        sig_ok = (found
                  & (vecs[:, 0] == sigs[:, 0])
                  & (vecs[:, 1] == sigs[:, 1]))
        fresh = vecs[:, 2] == np.int32(epoch)
        ok = sig_ok & fresh
        dists = vecs[:, _N_META:_N_META + k].view(np.float32)
        ids = vecs[:, _N_META + k:].copy()
        stale_keys = keys[sig_ok & ~fresh]
        return dists, ids, ok, stale_keys

    def lookup(self, rows, *, epoch: int,
               sigs: Optional[np.ndarray] = None,
               ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Serve a ``(m, d)`` request from cache: ``(dists (m, k) f32,
        ids (m, k) i32)`` when EVERY row hits one tier (exact first,
        then — only when calibrated on — semantic), else None. A
        signature match stamped with an older ``epoch`` is STALE: the
        entry is evicted, the stale counter ticks, and the request
        falls through to a real dispatch — this is the invalidation
        path every mutation relies on (docs/serving.md "Hot traffic").
        ``sigs`` re-uses :meth:`signatures` the caller already computed
        (the executor computes them once for coalescing + lookup)."""
        rows = np.asarray(rows, np.float32)
        if sigs is None:
            sigs = self.signatures(rows)
        m = rows.shape[0]
        l1_key = sigs.tobytes()
        with self._lock:
            ent = self._l1.get(l1_key)
            if ent is not None:
                e_epoch, e_dists, e_ids = ent
                if e_epoch == epoch and e_dists.shape[0] == m:
                    self._l1.move_to_end(l1_key)
                    self._hits += m
                    self._c["hit"].inc(m)
                    return e_dists.copy(), e_ids.copy()
                # stale or shape-drifted: drop and fall through (the
                # exact-tier probe below does the stale accounting for
                # these same rows)
                del self._l1[l1_key]
            dists, ids, ok, stale_keys = self._probe_tier(
                self._exact, sigs, epoch)
            n_stale = int(stale_keys.size)
            if stale_keys.size:
                self._exact.evict(stale_keys)
            if bool(ok.all()):
                # a sig-matching-but-stale row has ok=False, so the
                # all-hit branch is by construction stale-free; promote
                # the request back into the L1 front
                dists = dists.copy()
                self._l1_put(l1_key, epoch, dists, ids)
                self._hits += m
                self._c["hit"].inc(m)
                return dists, ids
            want_sem = self._semantic is not None and \
                self.semantic_enabled
            if not want_sem:
                self._misses += m
                self._stale += n_stale
                self._c["miss"].inc(m)
                self._c["stale"].inc(n_stale)
                return None
        # the semantic signer is a host matmul over the super-centroid
        # set — pure in ``rows``, so it runs OUTSIDE the lock (under
        # it, every submit thread would serialize behind it; the brief
        # unlock is fine, the cache is best-effort state)
        ssigs = self.signer(rows, self._salt)
        with self._lock:
            sd, si, sok, s_stale = self._probe_tier(
                self._semantic, ssigs, epoch)
            if s_stale.size:
                self._semantic.evict(s_stale)
            n_stale += int(s_stale.size)
            served = ok | sok
            if bool(served.all()):
                dists = np.where(ok[:, None], dists, sd)
                ids = np.where(ok[:, None], ids, si)
                nex = int(ok.sum())
                self._hits += nex
                self._semantic_hits += m - nex
                self._stale += n_stale
                self._c["hit"].inc(nex)
                self._c["semantic_hit"].inc(m - nex)
                self._c["stale"].inc(n_stale)
                return dists.copy(), ids
            self._misses += m
            self._stale += n_stale
            self._c["miss"].inc(m)
            self._c["stale"].inc(n_stale)
        return None

    def insert(self, rows, dists, ids, *, epoch: int,
               sigs: Optional[np.ndarray] = None) -> None:
        """Cache one request's finished rows, stamped with the epoch the
        DISPATCH ran under (the executor captures it before dispatch —
        stamping with a later epoch would resurrect pre-write data as
        fresh; stamping earlier only costs an extra miss)."""
        rows = np.asarray(rows, np.float32)
        dists = np.asarray(dists, np.float32)
        ids = np.asarray(ids, np.int32)
        m = rows.shape[0]
        errors.expects(
            dists.shape == (m, self.k) and ids.shape == (m, self.k),
            "ResultCache.insert: expected (m=%d, k=%d) results, got "
            "dists %s ids %s", m, self.k, tuple(dists.shape),
            tuple(ids.shape),
        )
        if sigs is None:
            sigs = self.signatures(rows)
        payload = np.empty((m, self.dim), np.int32)
        payload[:, 0] = sigs[:, 0]
        payload[:, 1] = sigs[:, 1]
        payload[:, 2] = np.int32(epoch)
        payload[:, _N_META:_N_META + self.k] = dists.view(np.int32)
        payload[:, _N_META + self.k:] = ids
        spay = None
        if self._semantic is not None:
            # signer outside the lock, like lookup's semantic probe
            ssigs = self.signer(rows, self._salt)
            spay = payload.copy()
            spay[:, 0] = ssigs[:, 0]
            spay[:, 1] = ssigs[:, 1]
        with self._lock:
            self._l1_put(sigs.tobytes(), epoch, dists, ids)
            self._exact.store_vecs(_fold_key(sigs[:, 0]), payload)
            if spay is not None:
                self._semantic.store_vecs(_fold_key(spay[:, 0]), spay)
            self._inserts += m
        self._c_inserts.inc(m)

    # -- the guardrail -------------------------------------------------------
    def calibrate_semantic(self, queries, search_fn, *,
                           min_recall: Optional[float] = None) -> bool:
        """Measure :func:`semantic_recall` on a sample of the REAL
        workload and enable semantic hits iff it clears the floor.
        Returns the enable decision; the measured value lands in
        :attr:`measured_semantic_recall` (None = no colliding pair in
        the sample — the tier stays off, docs/serving.md says when to
        widen the sample vs when that answer is final)."""
        errors.expects(self.signer is not None,
                       "calibrate_semantic: this cache has no signer — "
                       "construct with signer=CentroidSigner(...)")
        floor = (self.semantic_min_recall if min_recall is None
                 else float(min_recall))
        r = semantic_recall(queries, search_fn, self.signer, self.k)
        self.measured_semantic_recall = r
        self.semantic_enabled = r is not None and r >= floor
        return self.semantic_enabled

    def stats(self) -> ResultCacheStats:
        with self._lock:
            return ResultCacheStats(
                hits=self._hits, semantic_hits=self._semantic_hits,
                misses=self._misses, stale=self._stale,
                inserts=self._inserts,
            )
