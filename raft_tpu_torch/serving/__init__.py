"""Open-loop serving of the port — ``raft_tpu/serving`` on PyTorch:

* :class:`~raft_tpu_torch.serving.batching.BucketSet` /
  :func:`~raft_tpu_torch.serving.batching.pack_requests` — shape-bucketed
  micro-batching into exactly the warmed ``warmup(nq)`` batch sizes;
* :class:`~raft_tpu_torch.serving.executor.ServingExecutor` — the
  open-loop executor: pinned host→device staging, a bounded in-flight
  window of batches on the card, completion-order demux (CUDA events
  recorded at dispatch, results read from pinned host buffers) back to
  per-request futures, with
  :class:`~raft_tpu_torch.resilience.AdmissionController` shedding at the
  door and :class:`~raft_tpu_torch.resilience.HedgePolicy`-driven
  straggler hedging onto a backup closure on a second stream;
* :class:`~raft_tpu_torch.serving.result_cache.ResultCache` /
  :class:`~raft_tpu_torch.serving.result_cache.CentroidSigner` — the
  exact + semantic query-result cache over the set-associative
  :class:`~raft_tpu_torch.cache.VectorCache`, invalidated by mutation
  epoch, feeding the executor's submit-side cache hits and request
  coalescing;
* :mod:`raft_tpu_torch.serving.open_loop` — the open-loop row
  (saturation against the raw search, then p50/p99 at fractions of it),
  driven by the seeded Poisson schedules of
  :mod:`raft_tpu_torch.testing.load`.
"""

from raft_tpu_torch.serving.batching import (
    BucketSet,
    MicroBatch,
    PendingRequest,
    pack_requests,
)
from raft_tpu_torch.serving.executor import (
    STAGES,
    ExecutorStats,
    ServingExecutor,
)
from raft_tpu_torch.serving.result_cache import (
    CentroidSigner,
    ResultCache,
    ResultCacheStats,
    semantic_recall,
)

__all__ = [
    "BucketSet",
    "MicroBatch",
    "PendingRequest",
    "pack_requests",
    "STAGES",
    "ExecutorStats",
    "ServingExecutor",
    "CentroidSigner",
    "ResultCache",
    "ResultCacheStats",
    "semantic_recall",
]
