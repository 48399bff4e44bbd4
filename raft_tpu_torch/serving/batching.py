"""Shape-bucketed micro-batching — the port of
``raft_tpu/serving/batching.py`` (numpy only, same behaviour).

Serving warms one batch size per bucket (`index.warmup(nq)` returns the
qcap for that size) and dispatches only those sizes, so every batch runs
a warmed shape with its warmed qcap. This module is the host-side
arithmetic of that discipline:

* :class:`BucketSet` — the warmed batch sizes (exactly the
  ``warmup(nq)``/``static_qcap`` set), with smallest-fitting-bucket
  selection;
* :class:`PendingRequest` — one submitted request: its query rows, its
  arrival stamp, and the future its caller is holding;
* :func:`pack_requests` — coalesce whole pending requests (arrival
  order, never splitting a request across batches) into one
  bucket-shaped :class:`MicroBatch`, zero-padding the tail rows —
  padded rows are dispatched (the program's shape demands them) but
  never demuxed into any caller's result.

Everything here is numpy on the host.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from raft_tpu_torch import errors

__all__ = ["BucketSet", "PendingRequest", "MicroBatch", "pack_requests"]


@dataclasses.dataclass(frozen=True)
class BucketSet:
    """The warmed micro-batch sizes, ascending and distinct.

    ``select(n)`` returns the smallest bucket that fits ``n`` query
    rows — or the LARGEST bucket when ``n`` exceeds it (the caller
    packs what fits and leaves the rest pending; arrivals straddling a
    bucket boundary become two batches, never an unwarmed shape).
    """

    sizes: Tuple[int, ...]

    def __post_init__(self):
        errors.expects(len(self.sizes) >= 1, "BucketSet: no sizes")
        errors.expects(
            all(isinstance(s, int) and not isinstance(s, bool) and s >= 1
                for s in self.sizes),
            "BucketSet: sizes must be positive ints, got %r", self.sizes,
        )
        errors.expects(
            all(a < b for a, b in zip(self.sizes, self.sizes[1:])),
            "BucketSet: sizes must be strictly ascending, got %r",
            self.sizes,
        )

    @classmethod
    def of(cls, sizes: Sequence[int]) -> "BucketSet":
        return cls(tuple(sorted(int(s) for s in set(sizes))))

    @property
    def smallest(self) -> int:
        return self.sizes[0]

    @property
    def largest(self) -> int:
        return self.sizes[-1]

    def select(self, n_rows: int) -> int:
        """Smallest bucket >= ``n_rows`` (the largest when none fits)."""
        errors.expects(n_rows >= 1, "BucketSet.select: n_rows=%d < 1",
                       n_rows)
        for s in self.sizes:
            if s >= n_rows:
                return s
        return self.largest


@dataclasses.dataclass
class PendingRequest:
    """One submitted request, waiting to be packed into a micro-batch."""

    queries: np.ndarray        # (m, d) float32, m >= 1
    future: object             # concurrent.futures.Future
    t_arrival: float           # executor-clock stamp (flush deadline)
    ticket: Optional[object] = None   # opaque admission bookkeeping
    # correlation id: the executor stamps a per-process sequence at
    # submit so one request's events (submit, pack, dispatch, demux) join
    req_id: int = -1
    # hot-traffic shaping: the request's per-row exact
    # signatures (computed once at submit — the coalescing key AND the
    # cache-fill key), the coalescing-leader map key this request
    # registered under (None = not a leader), and the futures of
    # requests COALESCED onto this one. Followers are resolved from
    # the demuxed batch result directly — NOT by mirroring this
    # request's own future, so a caller cancelling the leader can
    # never cancel an unrelated follower.
    sigs: Optional[np.ndarray] = None
    sig_key: Optional[tuple] = None
    followers: List[object] = dataclasses.field(default_factory=list)

    @property
    def n_rows(self) -> int:
        return int(self.queries.shape[0])


@dataclasses.dataclass
class MicroBatch:
    """One bucket-shaped batch: the padded host buffer plus the demux
    map back to the requests it carries."""

    queries: np.ndarray                      # (bucket, d) float32
    entries: List[Tuple[PendingRequest, int]]  # (request, start row)
    n_valid: int                             # valid rows; rest is padding
    batch_id: int = -1                       # flight-recorder correlation

    @property
    def bucket(self) -> int:
        return int(self.queries.shape[0])

    @property
    def n_requests(self) -> int:
        return len(self.entries)

    @property
    def n_padded(self) -> int:
        return self.bucket - self.n_valid


def pack_requests(pending: List[PendingRequest], buckets: BucketSet,
                  dim: int) -> Tuple[Optional[MicroBatch],
                                     List[PendingRequest]]:
    """Pack a prefix of ``pending`` (arrival order) into one micro-batch.

    Whole requests only: a request's rows always land contiguously in a
    single batch (its caller gets one result array), so a request that
    would overflow the chosen bucket stays pending for the NEXT batch —
    that is the bucket-straddling case, and it yields two warmed-shape
    dispatches instead of one unwarmed one. Returns
    ``(batch_or_None, still_pending)``; None only when ``pending`` is
    empty or its first request alone exceeds the largest bucket
    (rejected at submit, so not reachable through the executor).
    """
    if not pending:
        return None, pending
    total = sum(r.n_rows for r in pending)
    bucket = buckets.select(min(total, buckets.largest))
    taken: List[Tuple[PendingRequest, int]] = []
    used = 0
    for req in pending:
        if used + req.n_rows > bucket:
            break
        taken.append((req, used))
        used += req.n_rows
    if not taken:
        return None, pending
    # re-select on the rows that actually packed: the whole-request
    # constraint can leave `used` far below the total-row bucket guess
    # (buckets (4, 8), pending [3-row, 6-row] -> only 3 rows fit), and
    # dispatching them in the smaller warmed shape beats padding the
    # larger one
    bucket = buckets.select(used)
    out = np.zeros((bucket, dim), np.float32)
    for req, start in taken:
        out[start:start + req.n_rows] = req.queries
    batch = MicroBatch(queries=out, entries=taken, n_valid=used)
    return batch, pending[len(taken):]
