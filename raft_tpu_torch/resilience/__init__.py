"""Resilience layer for the serving path — the port of
``raft_tpu/resilience``, as far as the serving executor needs it:

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
* the per-shard and per-list load feed (:mod:`.replica`):
  :func:`record_list_load` / :func:`measured_list_load` and their
  per-shard counterparts, the cold tier's promotion signal.

Shard health, replica placement and failover (the rest of
``replica.py``: ``ReplicaPlacement``, ``popularity_replication``,
``FailoverPlan``, ``resolve_route``), degraded results and the
self-healing supervisor are not ported yet.
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
from raft_tpu_torch.resilience.replica import (
    measured_list_load,
    measured_shard_load,
    record_list_load,
    record_shard_load,
)

__all__ = [
    "AdmissionController",
    "AdmissionStats",
    "Deadline",
    "HedgePolicy",
    "RetryPolicy",
    "dispatch_hedged",
    "dispatch_with_deadline",
    "measured_list_load",
    "measured_shard_load",
    "record_list_load",
    "record_shard_load",
    "wait_first",
]
