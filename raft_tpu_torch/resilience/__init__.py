"""Resilience layer for the serving path — the port of
``raft_tpu/resilience``:

* deadlines + retries: :class:`Deadline`, :class:`RetryPolicy`,
  :func:`dispatch_with_deadline` — bounded waits over
  ``Interruptible.synchronize(timeout_s=)``, which polls CUDA events;
* tail-latency hedging: :class:`HedgePolicy`, :func:`dispatch_hedged`,
  :func:`wait_first` — a backup dispatch after a percentile-derived
  delay, first ready answer wins, loser abandoned (cooperative);
* admission control: :class:`AdmissionController` — bounded queue +
  concurrency + token limiter, shedding with
  :class:`raft_tpu_torch.errors.RaftOverloadError` instead of
  collapsing;
* shard health (:mod:`.health`): :class:`ShardHealth`, the per-rank
  mask of the degraded sharded search, :class:`HealthMonitor`'s flap
  suppression, and :func:`health_check`, the timed communicator
  self-test sweep;
* degraded results (:mod:`.degraded`): :class:`PartialSearchResult` and
  :func:`resolve_shard_mask`;
* replica placement and failover (:mod:`.replica`):
  :class:`ReplicaPlacement`, :class:`FailoverPlan`,
  :func:`resolve_route`, :func:`popularity_replication`, and the
  per-shard and per-list load feed (:func:`record_list_load` /
  :func:`measured_list_load` and their per-shard counterparts, the cold
  tier's promotion signal).

The self-healing supervisor is not ported yet.
"""

from raft_tpu_torch.resilience.admission import (
    AdmissionController,
    AdmissionStats,
)
from raft_tpu_torch.resilience.deadline import (
    Deadline,
    HedgePolicy,
    RetryPolicy,
    dispatch_hedged,
    dispatch_with_deadline,
    wait_first,
)
from raft_tpu_torch.resilience.degraded import (
    PartialSearchResult,
    resolve_shard_mask,
)
from raft_tpu_torch.resilience.health import (
    HealthMonitor,
    HealthProbe,
    HealthReport,
    ShardHealth,
    health_check,
)
from raft_tpu_torch.resilience.replica import (
    FailoverPlan,
    ReplicaPlacement,
    measured_list_load,
    measured_shard_load,
    popularity_replication,
    record_list_load,
    record_shard_load,
    resolve_route,
)

__all__ = [
    "AdmissionController",
    "AdmissionStats",
    "Deadline",
    "FailoverPlan",
    "HealthMonitor",
    "HealthProbe",
    "HealthReport",
    "HedgePolicy",
    "PartialSearchResult",
    "ReplicaPlacement",
    "RetryPolicy",
    "ShardHealth",
    "dispatch_hedged",
    "dispatch_with_deadline",
    "health_check",
    "measured_list_load",
    "measured_shard_load",
    "popularity_replication",
    "record_list_load",
    "record_shard_load",
    "resolve_route",
    "resolve_shard_mask",
    "wait_first",
]
