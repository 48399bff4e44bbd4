"""Replica placement, failover routing and the per-shard / per-list load
feed — the port of ``raft_tpu/resilience/replica.py``, host numpy
over the port's :mod:`~raft_tpu_torch.obs.metrics` registry.

* :class:`ReplicaPlacement` — the striped shard -> ranks map of an R-way
  replicated sharded index: logical shard ``s`` lives on ranks
  ``{(s + j*offset) % P}``, the slab layout
  :func:`raft_tpu_torch.comms.mnmg_ivf.replicate_index` builds
  (``place_index(..., replication=R)``);
* :class:`FailoverPlan` — a health mask and a placement mapped to the
  ``(P,)`` int32 ``route`` the degraded sharded search takes as a
  runtime operand (``route[s]`` = the copy index serving shard ``s``;
  -1 = its whole replica group is down), and :func:`resolve_route`,
  which normalizes a search's ``failover=`` argument;
* :func:`popularity_replication` — a copy budget apportioned over shards
  by measured load;
* the load feed: :func:`record_shard_load`, :func:`measured_shard_load`,
  :func:`record_list_load` and :func:`measured_list_load`. A tiered
  search records its probe histogram into the
  ``serving_list_rows_total{shard,list}`` counters; the promotion
  policy ranks lists by the same counts. A shard mints at most 64
  per-list series (first-come, which under Zipf traffic is about the
  head) and folds the rest into ``list="other"``: total traffic is
  conserved and the catalog stays bounded.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np

from raft_tpu_torch import errors
from raft_tpu_torch.obs import metrics as obs_metrics

__all__ = [
    "FailoverPlan",
    "ReplicaPlacement",
    "measured_list_load",
    "measured_shard_load",
    "popularity_replication",
    "record_list_load",
    "record_shard_load",
    "resolve_route",
]

_SHARD_LOAD_METRIC = "serving_shard_rows_total"
_LIST_LOAD_METRIC = "serving_list_rows_total"
_LIST_SERIES_CAP = 64

# failover-routing telemetry: every plan built counts, and the two gauges
# show the current routing posture — shards served off-primary (a flip
# in effect) and shards with no live holder (coverage loss)
_reg = obs_metrics.default_registry()
_M_PLANS = _reg.counter("failover_plans_total")
_G_REROUTED = _reg.gauge("failover_rerouted_shards")
_G_UNSERVED = _reg.gauge("failover_unserved_shards")
del _reg


@dataclasses.dataclass(frozen=True)
class ReplicaPlacement:
    """The striped shard→ranks map of an R-way replicated sharded index.

    Logical shard ``s`` (one per rank; the unit of LPT ownership)
    is stored on ranks ``{(s + j*offset) % n_ranks for j in range(R)}``
    — copy 0 is the PRIMARY (the rank that serves it on a healthy
    communicator), copies 1..R-1 are standbys. Rank ``r`` therefore stores the
    segments of shards ``{(r - j*offset) % n_ranks}``, primary first —
    exactly the slab order :func:`raft_tpu_torch.comms.mnmg_ivf.replicate_index`
    lays out.
    """

    n_ranks: int
    replication: int
    offset: int
    # chips per host: >1 records (and enforces) HOST-AWARE placement —
    # rank r lives on host r // inner_size, and every shard's R copies
    # must land on R distinct hosts 
    inner_size: int = 1

    @classmethod
    def striped(cls, n_ranks: int, replication: int,
                offset: "int | None" = None, *,
                inner_size: "int | None" = None) -> "ReplicaPlacement":
        """The standard placement. ``offset`` defaults to
        ``max(1, n_ranks // replication)`` — for R=2 that pairs rank
        ``r`` with ``r + P/2``, so a correlated failure of ADJACENT
        ranks (one host's chips) never takes out both copies of a
        shard. Any offset is accepted as long as every shard's R
        holders are distinct ranks.

        ``inner_size`` (chips per host) engages the HOST axis: the
        default offset becomes the host-aware stripe
        ``inner_size * max(1, n_hosts // R)`` — copies step WHOLE
        hosts, so a whole dead host (all its chips at once, the
        realistic multi-host failure unit) still leaves every shard a
        live copy — and ANY offset (default or explicit) is validated
        to land each shard's R copies on R distinct hosts. Requires
        R ≤ n_hosts: more copies than hosts cannot be host-disjoint
        (:func:`raft_tpu_torch.comms.multihost.host_aware_offset` is the
        comms-level sibling of the same stripe)."""
        inner = 1 if inner_size is None else int(inner_size)
        errors.expects(
            inner >= 1 and (inner == 1 or n_ranks % inner == 0),
            "inner_size=%d: n_ranks=%d is not a whole number of hosts",
            inner, n_ranks,
        )
        if offset is None:
            if inner > 1:
                n_hosts = n_ranks // inner
                errors.expects(
                    replication <= n_hosts,
                    "replication=%d copies cannot land on distinct "
                    "hosts (%d hosts of %d chips) — pass an explicit "
                    "offset to accept same-host copies",
                    replication, n_hosts, inner,
                )
                offset = inner * max(1, n_hosts // max(replication, 1))
            else:
                offset = max(1, n_ranks // max(replication, 1))
        errors.expects(
            1 <= replication <= n_ranks,
            "replication=%d out of range [1, n_ranks=%d] — a rank "
            "cannot hold two copies of the same shard",
            replication, n_ranks,
        )
        errors.expects(offset >= 1, "offset=%d < 1", offset)
        for delta in range(1, replication):
            errors.expects(
                (delta * offset) % n_ranks != 0,
                "offset=%d collides copies %d apart on a %d-rank communicator "
                "(two copies of one shard would land on the same rank)",
                offset, delta, n_ranks,
            )
        p = cls(n_ranks=n_ranks, replication=replication, offset=offset,
                inner_size=inner)
        if inner > 1:
            # the stripe validation above is necessary but not
            # sufficient (offsets near a host boundary can wrap two
            # copies onto one host) — check the actual holder sets
            for s in range(n_ranks):
                hosts = [r // inner for r in p.holders(s)]
                errors.expects(
                    len(set(hosts)) == replication,
                    "offset=%d places shard %d's copies on hosts %s — "
                    "not host-disjoint (inner_size=%d)",
                    offset, s, hosts, inner,
                )
        return p

    @classmethod
    def of_index(cls, index) -> "ReplicaPlacement":
        """The placement a replicated sharded index was built with
        (``place_index(..., replication=R)`` stamps the statics)."""
        return cls(
            n_ranks=int(index.sorted_ids.shape[0]),
            replication=int(getattr(index, "replication", 1) or 1),
            offset=int(getattr(index, "replica_offset", 1) or 1),
        )

    def holders(self, shard: int) -> Tuple[int, ...]:
        """The ranks storing ``shard``'s lists, primary (copy 0) first."""
        errors.expects(
            0 <= shard < self.n_ranks,
            "shard %d out of range [0, %d)", shard, self.n_ranks,
        )
        return tuple(
            (shard + j * self.offset) % self.n_ranks
            for j in range(self.replication)
        )

    def segments(self, rank: int) -> Tuple[int, ...]:
        """The logical shards stored on ``rank``, in slab-segment order
        (segment 0 = the rank's own primary shard)."""
        errors.expects(
            0 <= rank < self.n_ranks,
            "rank %d out of range [0, %d)", rank, self.n_ranks,
        )
        return tuple(
            (rank - j * self.offset) % self.n_ranks
            for j in range(self.replication)
        )

    def holder_hosts(self, shard: int) -> Tuple[int, ...]:
        """The hosts storing ``shard``'s copies, primary first (host =
        rank // inner_size; all zeros when the placement carries no
        host axis)."""
        return tuple(
            r // max(self.inner_size, 1) for r in self.holders(shard)
        )

    @property
    def host_disjoint(self) -> bool:
        """True iff every shard's R copies land on R distinct hosts —
        the whole-host-failure survival contract (a host-aware
        ``striped(..., inner_size=)`` placement guarantees it at
        construction)."""
        if self.inner_size <= 1:
            return self.replication == 1
        return all(
            len(set(self.holder_hosts(s))) == self.replication
            for s in range(self.n_ranks)
        )

    @property
    def memory_factor(self) -> int:
        """Slab-memory multiplier vs the unreplicated index (exactly R:
        lists, rows, and codes are stored R times; quantizers and
        ownership maps were already replicated)."""
        return self.replication


def record_shard_load(shard_rows, *, registry=None,
                      name: str = _SHARD_LOAD_METRIC) -> None:
    """Accumulate a per-shard dispatched-row count vector into the
    ``{name}{shard=s}`` counters. Callers hand in whatever granularity
    they have (per-batch probe-to-owner histograms, a bench's offered
    template mix); the counters sum it process-wide.
    ``RAFT_TPU_OBS=off`` no-ops it like every recorder."""
    rows = np.asarray(shard_rows)
    errors.expects(rows.ndim == 1,
                   "record_shard_load: expected a (P,) vector, got %s",
                   tuple(rows.shape))
    reg = obs_metrics.default_registry() if registry is None else registry
    for s in range(rows.shape[0]):
        n = int(rows[s])
        if n:
            reg.counter(name, shard=s).inc(n)


def measured_shard_load(n_shards: int, *, registry=None,
                        name: str = _SHARD_LOAD_METRIC) -> np.ndarray:
    """The accumulated per-shard load, ``(P,)`` float64 (zeros where no
    traffic was recorded)."""
    errors.expects(n_shards >= 1,
                   "measured_shard_load: n_shards=%d < 1", n_shards)
    reg = obs_metrics.default_registry() if registry is None else registry
    load = np.zeros(n_shards, np.float64)
    for inst in reg.series(name):
        s = inst.labels.get("shard")
        if s is None:
            continue
        s = int(s)
        if 0 <= s < n_shards:
            load[s] += float(inst.value)
    return load


def record_list_load(list_rows, *, shard: int = 0, registry=None,
                     name: str = _LIST_LOAD_METRIC,
                     max_series: int = _LIST_SERIES_CAP) -> None:
    """Accumulate a ``(n_lists,)`` per-list dispatched-row vector (a
    probe histogram, a touch snapshot) into the bounded-cardinality
    ``{name}{shard=s,list=l}`` counters. Lists that already own a series
    always record to it; new series are minted only while the shard
    holds fewer than ``max_series``, after which the remainder lands in
    ``list="other"``. ``RAFT_TPU_OBS=off`` no-ops it like every
    recorder."""
    rows = np.asarray(list_rows)
    errors.expects(rows.ndim == 1,
                   "record_list_load: expected a (n_lists,) vector, "
                   "got %s", tuple(rows.shape))
    reg = obs_metrics.default_registry() if registry is None else registry
    shard_l = str(int(shard))
    minted = set()
    for inst in reg.series(name):
        if (inst.labels.get("shard") == shard_l
                and inst.labels.get("list") not in (None, "other")):
            minted.add(inst.labels["list"])
    other = 0
    for lid in np.nonzero(rows)[0]:
        n = int(rows[lid])
        key = str(int(lid))
        if key in minted or len(minted) < max_series:
            minted.add(key)
            reg.counter(name, shard=shard_l, list=key).inc(n)
        else:
            other += n
    if other:
        reg.counter(name, shard=shard_l, list="other").inc(other)


def measured_list_load(n_lists: int, *, shard: "int | None" = None,
                       registry=None,
                       name: str = _LIST_LOAD_METRIC) -> np.ndarray:
    """The accumulated per-list load, ``(n_lists,)`` float64.
    ``shard=None`` sums every shard's series; the ``list="other"``
    bucket is left out (it names no list)."""
    errors.expects(n_lists >= 1,
                   "measured_list_load: n_lists=%d < 1", n_lists)
    reg = obs_metrics.default_registry() if registry is None else registry
    load = np.zeros(n_lists, np.float64)
    want = None if shard is None else str(int(shard))
    for inst in reg.series(name):
        lid = inst.labels.get("list")
        if lid in (None, "other"):
            continue
        if want is not None and inst.labels.get("shard") != want:
            continue
        lid = int(lid)
        if 0 <= lid < n_lists:
            load[lid] += float(inst.value)
    return load


def popularity_replication(load, *, budget: int, r_min: int = 1,
                           r_max: "int | None" = None) -> np.ndarray:
    """Distribute a fixed copy ``budget`` over shards proportionally to
    measured load (largest-remainder apportionment): every shard keeps
    at least ``r_min`` copies (availability floor — a cold shard must
    still survive a failure), hot shards absorb the surplus up to
    ``r_max`` (default: the shard count, i.e. uncapped). Returns the
    ``(P,)`` int replication vector, summing exactly to ``budget``.

    This is a PLANNING output: the slab layout stays the uniform-R
    :class:`ReplicaPlacement` (the sharded search depends on its
    statics), and the vector says where the NEXT capacity decision —
    which R to rebuild with, which shards to pin an extra standby for,
    which copies a load-weighted route should prefer — pays off.
    With uniform load it degenerates to uniform replication."""
    load = np.asarray(load, np.float64)
    p = load.shape[0]
    errors.expects(load.ndim == 1 and p >= 1,
                   "popularity_replication: expected a (P,) load "
                   "vector, got %s", tuple(load.shape))
    r_max = p if r_max is None else int(r_max)
    errors.expects(
        1 <= r_min <= r_max,
        "popularity_replication: need 1 <= r_min=%d <= r_max=%d",
        r_min, r_max,
    )
    errors.expects(
        p * r_min <= budget <= p * r_max,
        "popularity_replication: budget=%d cannot satisfy %d shards "
        "with copies in [%d, %d]", budget, p, r_min, r_max,
    )
    copies = np.full(p, r_min, np.int64)
    spare = budget - p * r_min
    total = float(load.sum())
    share = (load / total if total > 0
             else np.full(p, 1.0 / p)) * spare
    grant = np.minimum(np.floor(share).astype(np.int64),
                       r_max - r_min)
    copies += grant
    left = budget - int(copies.sum())
    # largest remainders first (ties: lower shard id — deterministic)
    rem = np.where(copies < r_max, share - np.floor(share), -1.0)
    for s in np.lexsort((np.arange(p), -rem)):
        if left == 0:
            break
        if copies[s] < r_max:
            copies[s] += 1
            left -= 1
    # r_max clamping can strand budget; spread it over the coldest
    # shards that still have headroom
    while left > 0:
        open_s = np.nonzero(copies < r_max)[0]
        take = open_s[np.argsort(load[open_s], kind="stable")]
        for s in take[:left]:
            copies[s] += 1
        left = budget - int(copies.sum())
    return copies.astype(np.int32)


def _alive_mask(health: Any, n_ranks: int) -> np.ndarray:
    # local import: degraded.py imports this package's health module;
    # keep the load feed importable on its own
    from raft_tpu_torch.resilience.degraded import resolve_shard_mask

    return resolve_shard_mask(health, n_ranks)


@dataclasses.dataclass(frozen=True)
class FailoverPlan:
    """A routing decision: which replica copy serves each logical shard.

    ``route`` is the ``(P,)`` int32 RUNTIME input of the degraded
    sharded search programs: ``route[s]`` is the copy index ``j`` such
    that rank ``(s + j*offset) % P`` serves shard ``s``'s lists; ``-1``
    means every holder is down and the shard goes unserved (the search
    degrades to the partial result for exactly those probes). A
    healthy communicator routes everything to copy 0 — the all-zeros route is
    the default when no plan is passed.

    Each shard is served by EXACTLY ONE rank under any plan, so merged
    results carry no duplicates and — whenever ``fully_covered`` — are
    identical to the healthy communicator's (every list is scored by the same
    kernel over an identical replica of its rows; only which allgather
    part carries the contribution changes).
    """

    placement: ReplicaPlacement
    route: np.ndarray

    @classmethod
    def from_health(cls, placement: ReplicaPlacement,
                    health: Any) -> "FailoverPlan":
        """Route every shard to its FIRST live holder (primary wins when
        up, so a healthy communicator yields the all-zeros route and flipping a
        rank back up restores primary serving). ``health`` is anything
        :func:`raft_tpu_torch.resilience.resolve_shard_mask` accepts — a
        :class:`ShardHealth`, a :class:`HealthReport`, a ``(P,)``
        array-like, or ``True``."""
        alive = _alive_mask(health, placement.n_ranks)
        route = np.full(placement.n_ranks, -1, np.int32)
        for s in range(placement.n_ranks):
            for j, r in enumerate(placement.holders(s)):
                if alive[r]:
                    route[s] = j
                    break
        _M_PLANS.inc()
        _G_REROUTED.set(int((route > 0).sum()))
        _G_UNSERVED.set(int((route < 0).sum()))
        return cls(placement=placement, route=route)

    @classmethod
    def from_host_health(cls, placement: ReplicaPlacement,
                         host_alive: Any,
                         inner_size: "int | None" = None) -> "FailoverPlan":
        """The HOST-failure form of :meth:`from_health`: ``host_alive``
        is a per-HOST mask (host h covers ranks
        ``[h*inner_size, (h+1)*inner_size)`` — the row-major rank order
        of the two-level communicator), expanded to the flat rank mask and routed
        exactly as rank failures are. With a host-aware placement
        (``striped(..., inner_size=)``) and R=2, any single whole dead
        host keeps every shard served (``fully_covered``) — the
        multi-host failure contract. ``inner_size`` defaults to the placement's own."""
        inner = placement.inner_size if inner_size is None else int(inner_size)
        errors.expects(
            inner >= 1 and placement.n_ranks % inner == 0,
            "from_host_health: inner_size=%d does not tile n_ranks=%d",
            inner, placement.n_ranks,
        )
        host_alive = np.asarray(host_alive)
        errors.expects(
            host_alive.shape == (placement.n_ranks // inner,),
            "from_host_health: expected a (%d,) per-host mask, got "
            "shape %s", placement.n_ranks // inner,
            tuple(host_alive.shape),
        )
        alive = np.repeat((host_alive != 0).astype(np.int32), inner)
        return cls.from_health(placement, alive)

    @classmethod
    def load_balanced(cls, placement: ReplicaPlacement, health: Any,
                      load=None, *, registry=None) -> "FailoverPlan":
        """The LOAD-WEIGHTED route: among each shard's live
        holders, pick the copy that keeps the per-rank served load most
        even — hot shards claim their least-loaded live holder FIRST
        (descending measured load, so the ranks that must also absorb
        their hedged re-dispatches stay coolest), cold shards fill in
        around them. ``load`` is the ``(P,)`` measured per-shard load
        (default: :func:`measured_shard_load` from the registry's
        dispatch counters). Ties prefer the lower copy index, so a
        healthy communicator under uniform load yields exactly
        :meth:`from_health`'s all-zeros route.

        Route VALUES only: the result is an ordinary
        :class:`FailoverPlan` over the same placement, consumed by the
        same ``(P,)`` runtime route input — a popularity-driven
        re-route never changes the search's code path."""
        alive = _alive_mask(health, placement.n_ranks)
        p = placement.n_ranks
        if load is None:
            load = measured_shard_load(p, registry=registry)
        load = np.asarray(load, np.float64)
        errors.expects(
            load.shape == (p,),
            "load_balanced: expected a (%d,) load vector, got %s",
            p, tuple(load.shape),
        )
        route = np.full(p, -1, np.int32)
        rank_load = np.zeros(p, np.float64)
        # hottest shards pick first (stable ties by shard id)
        for s in np.lexsort((np.arange(p), -load)):
            best_j, best_r = -1, -1
            for j, r in enumerate(placement.holders(int(s))):
                if not alive[r]:
                    continue
                if best_j < 0 or rank_load[r] < rank_load[best_r]:
                    best_j, best_r = j, r
            if best_j >= 0:
                route[s] = best_j
                rank_load[best_r] += load[s]
        _M_PLANS.inc()
        _G_REROUTED.set(int((route > 0).sum()))
        _G_UNSERVED.set(int((route < 0).sum()))
        return cls(placement=placement, route=route)

    @property
    def fully_covered(self) -> bool:
        """True iff every logical shard has a live serving rank — the
        zero-coverage-loss regime (≤ R-1 failures per replica group)."""
        return bool((self.route >= 0).all())

    @property
    def unserved_shards(self) -> list:
        """Logical shards with no live holder (whole group dead)."""
        return np.nonzero(self.route < 0)[0].tolist()

    def serving_rank(self, shard: int) -> int:
        """The rank currently serving ``shard`` (-1 = unserved)."""
        j = int(self.route[shard])
        if j < 0:
            return -1
        return self.placement.holders(shard)[j]

    def serving_load(self) -> np.ndarray:
        """Shards served per rank, ``(P,)`` int — 1 everywhere on a
        healthy communicator; a failover rank carries 2+ (its grouped search
        scans more non-empty lists, so size ``qcap``/latency budgets
        for the failover load, not the healthy one)."""
        load = np.zeros(self.placement.n_ranks, np.int64)
        for s in range(self.placement.n_ranks):
            r = self.serving_rank(s)
            if r >= 0:
                load[r] += 1
        return load

    def __repr__(self) -> str:  # compact operator-facing summary
        moved = np.nonzero(self.route > 0)[0].tolist()
        dead = self.unserved_shards
        return (
            f"FailoverPlan(P={self.placement.n_ranks}, "
            f"R={self.placement.replication}, failed_over={moved}, "
            f"unserved={dead})"
        )


def resolve_route(failover: Any, n_ranks: int, replication: int,
                  offset: int) -> np.ndarray:
    """Normalize a search's ``failover=`` argument to the ``(P,)`` int32
    route array the degraded search consumes. Accepts ``None``
    (healthy: all copy 0), a :class:`FailoverPlan` (its placement must
    match the index's replication geometry — a plan built for a
    different stripe would route probes into the wrong slab segments),
    or an explicit ``(P,)`` array of copy indices in ``[-1, R)``."""
    if failover is None:
        return np.zeros(n_ranks, np.int32)
    if isinstance(failover, FailoverPlan):
        p = failover.placement
        errors.expects(
            p.n_ranks == n_ranks and p.replication == replication
            and (replication == 1 or p.offset == offset),
            "failover plan placement (P=%d, R=%d, offset=%d) does not "
            "match the index layout (P=%d, R=%d, offset=%d)",
            p.n_ranks, p.replication, p.offset,
            n_ranks, replication, offset,
        )
        arr = failover.route
    else:
        arr = np.asarray(failover)
    errors.expects(
        arr.shape == (n_ranks,),
        "failover route: expected shape (%d,), got %s",
        n_ranks, tuple(arr.shape),
    )
    arr = arr.astype(np.int32)
    errors.expects(
        bool(((arr >= -1) & (arr < replication)).all()),
        "failover route entries must be replica copy indices in "
        "[-1, %d)", replication,
    )
    return arr
