"""The open-loop serving executor: dynamic micro-batching + async
pipelined dispatch over the warmed one-dispatch searches — the port of
``raft_tpu/serving/executor.py`` to PyTorch on a CUDA card.

The grouped searches are fast enough that dispatch GAPS, not the card,
bound open-loop throughput: a loop that batches, dispatches, and then
blocks for the result leaves the card idle for the whole host round trip
of every batch. This executor closes those gaps (docs/serving.md
"Open-loop serving"):

* **Shape-bucketed coalescing** — arrivals are packed into micro-batches
  whose sizes are EXACTLY the ``index.warmup(nq)`` bucket set
  (:class:`raft_tpu_torch.serving.batching.BucketSet`), so every batch
  runs a warmed size with its warmed qcap.
* **Pipelined staging** — the batcher thread copies the NEXT padded host
  batch into a pinned host buffer and enqueues its host→device copy
  (``non_blocking``) on the executor's stream while earlier batches
  compute; the pinned buffer rides in the batch's in-flight record until
  the batch is demuxed.
* **A bounded in-flight window** — up to ``max_in_flight`` dispatched
  batches are enqueued on the card at once; the window bounds device
  memory and keeps worst-case queueing delay
  ``max_in_flight × service_time``.
* **Completion-order demux** — right after ``dispatch`` returns, the
  batcher thread enqueues a ``non_blocking`` copy of every output tensor
  into pinned host buffers and records a ``torch.cuda.Event`` after
  those copies, on the dispatching stream. A drain thread polls the
  in-flight set's events (``Event.query()`` — readiness, not dispatch
  order), reads each finished batch's pinned buffers, and slices
  per-request rows back into the per-request futures callers hold. The
  drain thread makes no other CUDA call. Padded rows never surface.
  (An event recorded at poll time instead would also wait for every
  batch dispatched since on the shared stream, and demux would become
  dispatch order.)
* **The resilience stack is wired in** — an
  :class:`~raft_tpu_torch.resilience.AdmissionController` gates
  ``submit`` (non-blocking ``enqueue``: open-loop arrivals are shed,
  never slowed), a :class:`~raft_tpu_torch.resilience.HedgePolicy` +
  ``backup_dispatch`` hedges straggling batches (the batch's HOST copy
  is re-staged and dispatched by a hedge thread on a second stream — on
  the primary's stream the backup could never finish first), and
  **runtime inputs** flow through ``set_runtime`` into every later
  dispatch.

The executor is engine-agnostic: ``dispatch(staged_batch, **runtime)``
is any callable returning a tree (:mod:`raft_tpu_torch.core.tree`) of
tensors whose leading-axis-``bucket`` leaves are per-row results (a
``(dists, ids)`` tuple). It must be warmed for every bucket size before
``submit`` traffic arrives, and it enqueues its work on the current
stream without a host sync.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from concurrent.futures import Future, InvalidStateError, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from raft_tpu_torch import errors
from raft_tpu_torch.analysis.threads import runtime as lockcheck
from raft_tpu_torch.core import tree as _tree
from raft_tpu_torch.core.device import resolve_device
from raft_tpu_torch.core.interruptible import Interruptible
from raft_tpu_torch.obs import crash as obs_crash
from raft_tpu_torch.obs import metrics as obs_metrics
from raft_tpu_torch.obs.flight import FlightRecorder
from raft_tpu_torch.resilience.admission import AdmissionController
from raft_tpu_torch.resilience.deadline import HedgePolicy
from raft_tpu_torch.serving.batching import (
    BucketSet,
    MicroBatch,
    PendingRequest,
    pack_requests,
)
from raft_tpu_torch.serving.result_cache import ResultCache, exact_signatures

__all__ = ["ServingExecutor", "ExecutorStats", "STAGES"]

# the serving pipeline's named stages, in hop order — each is a
# ``serving_stage_ms{executor,stage,bucket}`` histogram recorded from
# timestamps the executor already takes (docs/observability.md "Stage
# timing"): queue_wait (submit → packed), batch_build (pack + pad),
# staging (pinned copy + enqueued host→device copy), dispatch_ready
# (dispatch → the drain loop sees the batch's event done — the polling
# gives it for free, no synchronize), demux (reading the pinned results
# + per-request slicing), e2e (submit → future resolved)
STAGES = ("queue_wait", "batch_build", "staging", "dispatch_ready",
          "demux", "e2e")


@dataclasses.dataclass(frozen=True)
class ExecutorStats:
    """Point-in-time executor counters (monotonic except the gauges)."""

    submitted: int            # requests accepted into the pending queue
    completed: int            # request futures resolved successfully
    failed: int               # request futures resolved with an error
    batches: int              # micro-batches dispatched
    flushes_full: int         # batches flushed because a bucket filled
    flushes_deadline: int     # batches flushed by the coalescing deadline
    valid_rows: int           # real query rows dispatched
    padded_rows: int          # zero rows dispatched for shape only
    hedged_batches: int       # batches that dispatched a backup
    backup_wins: int          # hedged batches the backup answered first
    pending: int              # gauge: requests waiting to be batched
    in_flight: int            # gauge: batches dispatched, not demuxed
    # histogram-derived per-stage latency quantiles: stage name ->
    # milliseconds, pooled across this executor's buckets via the
    # registry's log2 histograms (the JAX package's field order)
    stage_p50_ms: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    stage_p99_ms: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # hot-traffic shaping (docs/serving.md "Hot traffic"): requests
    # answered by subscribing to an identical in-flight
    # request's future (they never consumed micro-batch rows), requests
    # served straight from the result cache, and cached ROW entries
    # that died on an epoch mismatch (the invalidation counter)
    coalesced_requests: int = 0
    cache_hits: int = 0
    cache_stale: int = 0

    @property
    def pad_fraction(self) -> float:
        """Padding overhead of the bucket discipline (padded rows over
        all dispatched rows) — the knob-tuning signal for bucket sizes
        vs ``flush_age_s`` (docs/serving.md)."""
        total = self.padded_rows + self.valid_rows
        return self.padded_rows / total if total else 0.0


class _Result:
    """One dispatch's output on its way to the host: ``host`` is the
    output tree with every CUDA tensor replaced by the pinned host tensor
    its copy lands in, ``event`` the event recorded on the dispatching
    stream after those copies (None for outputs already on the host), and
    ``staged`` the pinned staging buffer of the dispatch's input, kept
    until the batch is demuxed. Readiness is the event's ``query()`` and
    that of any readiness gate among the leaves (an object with
    ``query()`` — and its result in ``.value``)."""

    __slots__ = ("host", "event", "staged", "_gates", "_done")

    def __init__(self, host: Any, event, staged=None):
        self.host = host
        self.event = event
        self.staged = staged
        self._gates = [leaf for leaf in _tree.leaves(host)
                       if callable(getattr(leaf, "query", None))]
        self._done = False

    def ready(self) -> bool:
        if not self._done:
            self._done = ((self.event is None or self.event.query())
                          and all(g.query() for g in self._gates))
        return self._done


class _InFlight:
    """One dispatched micro-batch awaiting demux."""

    __slots__ = ("batch", "candidates", "t_dispatch", "ticket",
                 "runtime", "hedged", "hedge_pending", "t_hedge_attempt",
                 "epoch", "finished")

    def __init__(self, batch: MicroBatch, out: _Result, t_dispatch: float,
                 ticket: Optional[int], runtime: Dict[str, Any],
                 epoch: int = 0):
        self.batch = batch
        self.candidates: List[_Result] = [out]   # [primary, backup?]
        self.t_dispatch = t_dispatch
        self.ticket = ticket
        self.runtime = runtime
        self.hedged = False
        # a backup dispatch handed to the hedge thread and not yet back
        self.hedge_pending = False
        self.t_hedge_attempt: Optional[float] = None
        # the mutation epoch the dispatch ran under — cache fills are
        # stamped with THIS value, captured with the runtime snapshot
        # (stamping the completion-time epoch would mark pre-write
        # results fresh after a mid-flight write)
        self.epoch = epoch
        # set (under the executor lock) when the drain thread takes the
        # batch: a backup that lands later is abandoned
        self.finished = False


def _host_array(leaf: Any) -> Any:
    """A demuxed leaf as host numpy: a (pinned or CPU) tensor is copied
    out — no device call, the data is already on the host — so callers'
    results never pin the executor's buffers."""
    if isinstance(leaf, torch.Tensor):
        return np.array(leaf.detach().numpy())
    return leaf


class ServingExecutor:
    """Open-loop serving front end over warmed bucket searches.

    ``dispatch(staged, **runtime)`` — the warmed serving closure; it
    receives a device-staged ``(bucket, dim)`` float32 batch and the
    current runtime-input snapshot, enqueues its work on the current
    stream, and returns device outputs whose leading-axis-``bucket``
    tensors are per-row results.

    ``buckets`` — the warmed batch sizes (a :class:`BucketSet` or a
    sequence of ints); ``submit`` rejects requests larger than the
    largest bucket (``RaftLogicError`` — warm a bigger bucket instead:
    an unwarmed size would run with an unwarmed qcap).

    ``flush_age_s`` — the coalescing deadline: a partial batch is
    flushed once its OLDEST request has waited this long (latency floor
    at light load; bigger values fill bigger buckets).

    ``max_in_flight`` — the async dispatch window, in batches.

    ``admission`` — optional :class:`AdmissionController`; its queue
    bound sheds ``submit`` callers with
    :class:`~raft_tpu_torch.errors.RaftOverloadError` and its occupancy feeds
    ``retry_after_s`` pricing. ``max_queue`` counts REQUESTS waiting to
    be batched — size it to the queueing delay you will tolerate.

    ``hedge`` / ``backup_dispatch`` — optional straggler cover: a batch
    not ready ``hedge.hedge_delay_s()`` (or a fixed float) after
    dispatch is re-dispatched through ``backup_dispatch`` (the OTHER
    replica's warmed closure) from its retained host buffer, by a hedge
    thread on a second stream; the first ready answer is demuxed, the
    loser is abandoned cooperatively (its device work completes).

    ``runtime_inputs`` — initial runtime-operand snapshot passed as
    keyword arguments to every dispatch (e.g. ``shard_mask=``,
    ``failover=``); :meth:`set_runtime` swaps values mid-stream.

    ``runtime_provider`` — optional per-dispatch runtime source
    (docs/tiering.md): a zero-arg callable returning a dict overlaid
    onto the runtime snapshot once per batch, sampled outside the
    executor's locks just before staging. The sampled overlay rides in
    the batch's in-flight record: a hedge re-dispatch reuses the exact
    snapshot the primary saw.

    ``stage`` — host→device staging of the padded numpy batch (default:
    a copy into a pinned host buffer, then a ``non_blocking`` copy to
    ``device`` on the dispatching stream; the buffer is kept with the
    batch until it is demuxed). Override to pin placement. The JAX
    package's buffer donation has no counterpart here: the executor
    always re-stages hedged batches from the host copy.

    ``device`` — the device the executor serves on: ``None`` is the CUDA
    card (raising without one), ``"cpu"`` runs the same pipeline on the
    host (no streams, no events: CPU outputs are ready when ``dispatch``
    returns). On a card the batcher thread dispatches on one stream of
    its own and the hedge thread on a second.

    ``registry`` — the :class:`~raft_tpu_torch.obs.MetricRegistry` the
    per-stage latency histograms (:data:`STAGES`), hedge counters, and
    the coverage gauge record into (default: the process-wide
    registry; ``RAFT_TPU_OBS=off`` no-ops every recorder).
    ``flight`` — an optional :class:`~raft_tpu_torch.obs.FlightRecorder`;
    when given, every request's span (submit→pack→dispatch→hedge→
    demux) is traced by id and the ring is auto-dumped as JSONL when a
    batch fails or ``close()`` finds failures outstanding
    (docs/observability.md "Flight recorder").

    ``result_cache`` / ``epoch_fn`` / ``coalesce`` — hot-traffic
    shaping (docs/serving.md "Hot traffic"): a
    :class:`~raft_tpu_torch.serving.ResultCache` serves repeated queries
    before they reach admission or a micro-batch (fills are stamped
    with the dispatch-time mutation epoch from ``epoch_fn``, default
    constant 0 for frozen indexes; ``set_runtime`` re-samples it with
    every state swap), and coalescing (on by default whenever a cache
    is given) subscribes an identical same-epoch in-flight duplicate
    to the original's future instead of dispatching it again. The
    dispatch closures are untouched. Fills run after each batch's
    callers are resolved: on the drain thread when the cache's tiers are
    on the host (its default), on a cache-fill thread of their own when
    they are on the card (the drain thread makes no device call beyond
    ``Event.query()``); ``close()`` waits for them.
    """

    def __init__(
        self,
        dispatch: Callable[..., Any],
        buckets: "BucketSet | Sequence[int]",
        *,
        dim: int,
        flush_age_s: float = 0.002,
        max_in_flight: int = 4,
        admission: Optional[AdmissionController] = None,
        hedge: "HedgePolicy | float | None" = None,
        backup_dispatch: Optional[Callable[..., Any]] = None,
        runtime_inputs: Optional[Dict[str, Any]] = None,
        runtime_provider: Optional[Callable[[], Dict[str, Any]]] = None,
        stage: Optional[Callable[[np.ndarray], Any]] = None,
        clock: Callable[[], float] = time.monotonic,
        name: str = "serving",
        registry: "obs_metrics.MetricRegistry | None" = None,
        flight: Optional[FlightRecorder] = None,
        result_cache: Optional[ResultCache] = None,
        epoch_fn: Optional[Callable[[], int]] = None,
        coalesce: Optional[bool] = None,
        device=None,
    ):
        errors.expects(dim >= 1, "ServingExecutor: dim=%d < 1", dim)
        errors.expects(
            flush_age_s >= 0.0,
            "ServingExecutor: flush_age_s=%s < 0", flush_age_s,
        )
        errors.expects(
            max_in_flight >= 1,
            "ServingExecutor: max_in_flight=%d < 1", max_in_flight,
        )
        errors.expects(
            backup_dispatch is None or hedge is not None,
            "ServingExecutor: backup_dispatch without a hedge policy "
            "would never fire; pass hedge=",
        )
        self._dispatch = dispatch
        self.buckets = (
            buckets if isinstance(buckets, BucketSet)
            else BucketSet.of(buckets)
        )
        self.dim = int(dim)
        self.flush_age_s = float(flush_age_s)
        self.max_in_flight = int(max_in_flight)
        self.admission = admission
        self.hedge = hedge
        self._backup = backup_dispatch
        self._stage = stage
        self.device = resolve_device(device)
        on_card = self.device.type == "cuda"
        # PyTorch's current stream is per thread: the batcher thread
        # enqueues every batch on this one, the hedge thread its backups
        # on the second
        self._stream = torch.cuda.Stream(self.device) if on_card else None
        self._hedge_stream = (torch.cuda.Stream(self.device)
                              if on_card and backup_dispatch is not None
                              else None)
        self._hedger = (
            ThreadPoolExecutor(max_workers=1,
                               thread_name_prefix=f"{name}-hedge")
            if backup_dispatch is not None else None
        )
        # fills of a cache whose VectorCache tiers are on the card run
        # here, not in the drain thread: they are device calls, and the
        # drain thread makes none but Event.query()
        self._filler = (
            ThreadPoolExecutor(max_workers=1,
                               thread_name_prefix=f"{name}-cache-fill")
            if result_cache is not None
            and result_cache.device.type == "cuda" else None
        )
        self._clock = clock
        self.name = name
        # observability (docs/observability.md): per-stage
        # log2 latency histograms keyed (stage, bucket) — handles are
        # cached here so the hot path never touches the registry lock —
        # plus the optional flight recorder tracing request ids through
        # every hop. All recording honors the RAFT_TPU_OBS gate.
        self._registry = (obs_metrics.default_registry()
                          if registry is None else registry)
        self.flight = flight
        self._stage_hist: Dict[tuple, obs_metrics.Histogram] = {}
        self._c_completed = self._registry.counter(
            "serving_requests_total", executor=name, outcome="completed")
        self._c_failed = self._registry.counter(
            "serving_requests_total", executor=name, outcome="failed")
        self._c_hedges = self._registry.counter(
            "serving_hedges_total", executor=name)
        self._c_backup_wins = self._registry.counter(
            "serving_backup_wins_total", executor=name)
        # created on FIRST coverage sighting: a single-chip executor
        # never demuxes a PartialSearchResult, and a coverage gauge
        # stuck at its 0.0 initial value would read as total loss
        self._g_coverage: Optional[obs_metrics.Gauge] = None
        # hot-traffic shaping (docs/serving.md "Hot traffic"): the
        # optional result cache, the mutation-epoch
        # source (default: constant 0 — a frozen index never goes
        # stale), and request coalescing (on whenever a cache supplies
        # the signature scheme, or forced with coalesce=True)
        self._rcache = result_cache
        self._epoch_fn: Callable[[], int] = (
            (lambda: 0) if epoch_fn is None else epoch_fn
        )
        self._coalesce_on = (
            result_cache is not None if coalesce is None else bool(coalesce)
        )
        self._c_coalesced = self._registry.counter(
            "serving_coalesced_total", executor=name)
        self._sig_leaders: Dict[tuple, tuple] = {}   # key -> (req, epoch)
        self._coalesced = 0
        self._cache_hits = 0
        self._req_seq = 0
        self._batch_seq = 0
        # the epoch every dispatch is stamped with: sampled at init and
        # re-sampled by set_runtime (the serialization point at which
        # mutated state becomes visible to later dispatches) — see
        # docs/serving.md "Hot traffic" for the install ordering rule
        self._rt_epoch = int(self._epoch_fn())

        self._lock = lockcheck.make_lock("ServingExecutor._lock")
        self._work = lockcheck.make_condition(self._lock)  # batcher wake
        self._done = lockcheck.make_condition(self._lock)  # drain wake
        self._pending: List[PendingRequest] = []
        self._inflight: List[_InFlight] = []
        self._closed = False
        self._batcher_exited = False
        # counters (under _lock)
        self._submitted = 0
        self._completed = 0
        self._failed = 0
        self._batches = 0
        self._flushes_full = 0
        self._flushes_deadline = 0
        self._valid_rows = 0
        self._padded_rows = 0
        self._hedged_batches = 0
        self._backup_wins = 0
        self._runtime: Dict[str, Any] = dict(runtime_inputs or {})
        # per-dispatch runtime source (docs/tiering.md): a callable
        # sampled once per batch, OUTSIDE the executor lock, whose dict
        # overlays self._runtime. The sampled snapshot is kept in the
        # batch's _InFlight record so a hedge re-uses the exact operands
        # the primary saw.
        self._runtime_provider = runtime_provider

        # a dead batcher/drainer must not vanish silently: route
        # uncaught thread exceptions to thread_uncaught_total + a
        # flight event (docs/observability.md "Thread crashes")
        obs_crash.install_excepthook()
        if self.flight is not None:
            obs_crash.set_flight_sink(self.flight)
        self._batcher = threading.Thread(
            target=self._batch_loop, name=f"{name}-batcher", daemon=True,
        )
        self._drainer = threading.Thread(
            target=self._drain_loop, name=f"{name}-drain", daemon=True,
        )
        self._batcher.start()
        self._drainer.start()

    # -- the request surface -------------------------------------------------
    def submit(self, queries) -> Future:
        """Queue one request (``(d,)`` or ``(m, d)`` float32 rows) and
        return its :class:`~concurrent.futures.Future`. The result is
        the dispatch output's pytree with every leading-axis-bucket
        array sliced to THIS request's ``m`` rows (host numpy).

        Never blocks on the server: a full admission queue sheds with
        :class:`~raft_tpu_torch.errors.RaftOverloadError` immediately
        (``retry_after_s`` priced from occupancy), an oversized request
        fails loudly instead of running an unwarmed size, and
        otherwise the request is pending when this returns.
        """
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        errors.expects(
            q.ndim == 2 and q.shape[1] == self.dim,
            "submit: expected (m, %d) query rows, got %s",
            self.dim, tuple(q.shape),
        )
        errors.expects(
            1 <= q.shape[0] <= self.buckets.largest,
            "submit: %d rows exceed the largest warmed bucket (%d) — "
            "warm a bigger bucket or split the request",
            q.shape[0], self.buckets.largest,
        )
        # hot-traffic shaping (docs/serving.md "Hot traffic"): a cache
        # hit or a coalesce answers BEFORE admission — neither consumes
        # a queue slot or a micro-batch row
        sigs = None
        epoch_now = 0
        if self._rcache is not None or self._coalesce_on:
            epoch_now = int(self._epoch_fn())
            sigs = (self._rcache.signatures(q)
                    if self._rcache is not None
                    else exact_signatures(q))
        if self._rcache is not None:
            cached = self._rcache.lookup(q, epoch=epoch_now, sigs=sigs)
            if cached is not None:
                return self._resolve_from_cache(q, cached)
        if self._coalesce_on:
            fut = self._try_coalesce(q, sigs, epoch_now)
            if fut is not None:
                return fut
        if self.admission is not None:
            try:
                self.admission.enqueue()   # may shed: RaftOverloadError
            except errors.RaftOverloadError:
                if self.flight is not None:
                    self.flight.record("shed", rows=int(q.shape[0]))
                raise
        fut: Future = Future()
        req = PendingRequest(queries=q, future=fut,
                             t_arrival=self._clock())
        with self._work:
            if self._closed:
                if self.admission is not None:
                    self.admission.cancel_queued()
                errors.fail("submit on a closed ServingExecutor")
            req.req_id = self._req_seq
            self._req_seq += 1
            if self.flight is not None:
                # record BEFORE the batcher can see the request: a
                # 'pack' preceding its own 'submit' in the ring would
                # invert causality in the postmortem artifact (the
                # recorder lock is a leaf — no ordering hazard)
                self.flight.record("submit", request_id=req.req_id,
                                   rows=int(q.shape[0]))
            req.sigs = sigs
            self._pending.append(req)
            self._submitted += 1
            if self._coalesce_on and sigs is not None:
                # this request becomes the signature's LEADER: later
                # identical submits (same rows, same epoch) attach as
                # followers instead of consuming batch rows. The entry
                # is released (identity-checked) when the request's
                # batch demuxes or fails — a stale-epoch leader is
                # simply replaced.
                key = (int(q.shape[0]), sigs.tobytes())
                prev = self._sig_leaders.get(key)
                if prev is None or prev[1] != epoch_now:
                    self._sig_leaders[key] = (req, epoch_now)
                    req.sig_key = key
            self._work.notify()
        return fut

    def _resolve_from_cache(self, q: np.ndarray, cached: Any) -> Future:
        """Resolve a submit straight from the result cache: the future
        completes before this returns, no queue slot, no batch row."""
        fut: Future = Future()
        with self._lock:
            if self._closed:
                errors.fail("submit on a closed ServingExecutor")
            rid = self._req_seq
            self._req_seq += 1
            self._submitted += 1
            self._completed += 1
            self._cache_hits += 1
        if self.flight is not None:
            self.flight.record("submit", request_id=rid,
                               rows=int(q.shape[0]))
            self.flight.record("cache_hit", request_id=rid,
                               rows=int(q.shape[0]))
        self._c_completed.inc()
        fut.set_result(cached)
        return fut

    def _try_coalesce(self, q: np.ndarray, sigs: np.ndarray,
                      epoch_now: int) -> Optional[Future]:
        """Attach this request as a FOLLOWER of an identical in-flight
        leader (same per-row signatures, same row count, same mutation
        epoch — an epoch mismatch means a write landed since the leader
        was submitted, and its answer may be pre-write). The follower's
        future is resolved from the leader's demuxed BATCH rows, not
        from the leader's own future — a caller cancelling the leader
        cancels only itself. Returns None when there is no compatible
        leader."""
        key = (int(q.shape[0]), sigs.tobytes())
        fut: Future = Future()
        with self._work:
            if self._closed:
                return None
            leader = self._sig_leaders.get(key)
            if leader is None or leader[1] != epoch_now:
                return None
            leader[0].followers.append(fut)
            rid = self._req_seq
            self._req_seq += 1
            self._submitted += 1
            self._coalesced += 1
        if self.flight is not None:
            self.flight.record("submit", request_id=rid,
                               rows=int(q.shape[0]))
            self.flight.record("coalesce", request_id=rid,
                               rows=int(q.shape[0]))
        self._c_coalesced.inc()
        return fut

    def _release_followers(self, batch: MicroBatch) -> Dict[int, list]:
        """Atomically retire the batch's leader registrations and
        snapshot their followers (by request id). After the map entry
        is gone no new follower can attach (attachment happens under
        the same lock), so the snapshot is complete — every follower is
        resolved exactly once, by whoever demuxes or fails the batch."""
        subs: Dict[int, list] = {}
        with self._work:
            for req, _start in batch.entries:
                if req.sig_key is not None:
                    cur = self._sig_leaders.get(req.sig_key)
                    if cur is not None and cur[0] is req:
                        del self._sig_leaders[req.sig_key]
                if req.followers:
                    subs[req.req_id] = list(req.followers)
                    req.followers = []
        return subs

    def set_runtime(self, **updates: Any) -> None:
        """Swap runtime-operand values (``shard_mask=``, ``failover=``,
        mutation slabs, ...) for every LATER dispatch; in-flight batches
        keep the snapshot they were dispatched with (``None`` removes a
        key)."""
        with self._lock:
            for key, val in updates.items():
                if val is None:
                    self._runtime.pop(key, None)
                else:
                    self._runtime[key] = val
            # re-sample the mutation epoch WITH the state swap: later
            # dispatches see the new values and stamp cache fills with
            # the new epoch atomically. Mutators that hand state to the
            # dispatch closure by other means call set_runtime() with
            # no updates after installing it (docs/serving.md "Hot
            # traffic")
            self._rt_epoch = int(self._epoch_fn())
        if self.flight is not None:
            # the failover-flip postmortem breadcrumb: a FailoverPlan's
            # route array is tiny and names exactly which replica copy
            # serves each shard from here on
            fields: Dict[str, Any] = {"keys": sorted(updates)}
            for key, val in updates.items():
                route = getattr(val, "route", None)
                if route is not None:
                    # a (P,) routing array at flip time — not the
                    # per-batch hot path
                    fields[f"{key}_route"] = (
                        route.tolist() if isinstance(route, torch.Tensor)  # jaxlint: disable=sync-in-hot-path
                        else np.asarray(route).tolist())  # jaxlint: disable=sync-in-hot-path
            self.flight.record("runtime_update", **fields)

    def _hist(self, stage_name: str, bucket: int) -> obs_metrics.Histogram:
        """The (stage, bucket) latency histogram, registry-created once
        and cached on this executor (the hot path's one-dict-lookup)."""
        key = (stage_name, bucket)
        h = self._stage_hist.get(key)
        if h is None:
            h = self._registry.histogram(
                "serving_stage_ms", executor=self.name,
                stage=stage_name, bucket=bucket,
            )
            self._stage_hist[key] = h
        return h

    def stage_quantile(self, stage_name: str, q: float,
                       ) -> Optional[float]:
        """One stage's latency quantile in ms, pooled across buckets
        (None before any observation) — what :meth:`stats` reads."""
        # snapshot first: the batcher/drain threads insert new bucket
        # keys concurrently and dict iteration must not see the resize
        hists = [h for (s, _b), h in list(self._stage_hist.items())
                 if s == stage_name]
        return obs_metrics.merged_quantile(hists, q)

    def stats(self) -> ExecutorStats:
        p50: Dict[str, float] = {}
        p99: Dict[str, float] = {}
        for stage_name in STAGES:
            v50 = self.stage_quantile(stage_name, 50.0)
            if v50 is None:
                continue
            p50[stage_name] = v50
            p99[stage_name] = self.stage_quantile(stage_name, 99.0)
        with self._lock:
            return ExecutorStats(
                submitted=self._submitted,
                completed=self._completed,
                failed=self._failed,
                batches=self._batches,
                flushes_full=self._flushes_full,
                flushes_deadline=self._flushes_deadline,
                valid_rows=self._valid_rows,
                padded_rows=self._padded_rows,
                hedged_batches=self._hedged_batches,
                backup_wins=self._backup_wins,
                pending=len(self._pending),
                in_flight=len(self._inflight),
                stage_p50_ms=p50,
                stage_p99_ms=p99,
                coalesced_requests=self._coalesced,
                cache_hits=self._cache_hits,
                cache_stale=(self._rcache.stats().stale
                             if self._rcache is not None else 0),
            )

    def close(self, timeout_s: float = 30.0) -> None:
        """Flush remaining pending requests, drain in-flight batches,
        and stop both loops. Idempotent."""
        with self._work:
            self._closed = True
            self._work.notify_all()
            self._done.notify_all()
        self._batcher.join(timeout_s)
        self._drainer.join(timeout_s)
        for pool in (self._hedger, self._filler):
            if pool is not None:
                pool.shutdown(wait=True)
        if self.flight is not None:
            with self._lock:
                failed = self._failed
            if failed:
                # shutdown with failures outstanding: the third
                # automatic dump trigger (docs/observability.md)
                self.flight.record("close", failed=failed)
                try:
                    self.flight.dump("close-with-failures")
                except Exception:   # noqa: BLE001 — close() must
                    pass            # complete even when the sink can't

    def __enter__(self) -> "ServingExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- the batcher thread --------------------------------------------------
    def _flush_wait_s(self) -> Optional[float]:
        """Under _lock: seconds until the oldest pending request's
        coalescing deadline, 0 when a flush is due NOW, None when there
        is nothing to flush."""
        if not self._pending:
            return None
        rows = sum(r.n_rows for r in self._pending)
        if rows >= self.buckets.largest or self._closed:
            return 0.0
        age = self._clock() - self._pending[0].t_arrival
        return max(0.0, self.flush_age_s - age)

    def _batch_loop(self) -> None:
        while True:
            with self._work:
                wait_s = self._flush_wait_s()
                while not (wait_s == 0.0 or (self._closed
                                             and not self._pending)):
                    self._work.wait(
                        timeout=0.05 if wait_s is None else wait_s
                    )
                    wait_s = self._flush_wait_s()
                if self._closed and not self._pending:
                    break
                rows = sum(r.n_rows for r in self._pending)
                t_pack0 = self._clock()
                batch, self._pending = pack_requests(
                    self._pending, self.buckets, self.dim
                )
                if batch is None:      # unreachable via submit; be safe
                    continue
                batch.batch_id = self._batch_seq
                self._batch_seq += 1
                runtime = dict(self._runtime)
                epoch = self._rt_epoch
                full = batch.n_padded == 0 and rows >= batch.bucket
            # stage metrics from stamps this loop already holds: the
            # pack wall time, and each packed request's queue wait
            now = self._clock()
            self._hist("batch_build", batch.bucket).observe(
                (now - t_pack0) * 1e3)
            qw = self._hist("queue_wait", batch.bucket)
            for req, start in batch.entries:
                qw.observe((now - req.t_arrival) * 1e3)
                if self.flight is not None:
                    self.flight.record(
                        "pack", request_id=req.req_id,
                        batch_id=batch.batch_id, bucket=batch.bucket,
                        start=start,
                    )
            self._dispatch_batch(batch, runtime, full, epoch)
        with self._done:
            self._batcher_exited = True
            self._done.notify_all()

    def _dispatch_batch(self, batch: MicroBatch,
                        runtime: Dict[str, Any], full: bool,
                        epoch: int = 0) -> None:
        # window check OUTSIDE the lock: the batcher blocks here (not
        # the submitters) when max_in_flight programs are queued
        while True:
            with self._done:
                if len(self._inflight) < self.max_in_flight:
                    break
                self._done.wait(0.05)
        ticket = None
        try:
            if self.admission is not None:
                ticket = self.admission.begin_service(batch.n_requests)
            # sample the per-dispatch runtime source (tier snapshots
            # etc.) outside every lock — a provider may itself take a
            # store lock, and must never nest under _done/_lock
            if self._runtime_provider is not None:
                runtime = {**runtime, **self._runtime_provider()}
            # stage the padded host buffer, then dispatch, then enqueue
            # the copy back and record the batch's event: all of it is
            # enqueued on the executor's stream behind earlier batches
            # still computing — this IS the double buffer (hedges
            # re-stage from batch.queries, never reuse this buffer)
            with self._on(self._stream):
                t_s0 = self._clock()
                staged, pinned = self._stage_batch(batch.queries)
                t0 = self._clock()
                lockcheck.note_dispatch("ServingExecutor._dispatch")
                out = self._to_host(self._dispatch(staged, **runtime),
                                    pinned)
            # staging is the host-side cost of the pinned copy and the
            # enqueued transfer — the transfer itself overlaps compute
            # (that's the point); a blocking stage override shows up here
            self._hist("staging", batch.bucket).observe(
                (t0 - t_s0) * 1e3)
            if self.flight is not None:
                self.flight.record(
                    "dispatch", batch_id=batch.batch_id,
                    bucket=batch.bucket, n_requests=batch.n_requests,
                    requests=[r.req_id for r, _ in batch.entries],
                )
        except Exception as exc:   # noqa: BLE001 — fail THIS batch only
            if ticket is not None:
                # abort, not finish: a crashed dispatch must not feed
                # its ~0 held-time into the service EWMA or count its
                # failed requests as completed
                self.admission.abort_service(ticket)
            elif self.admission is not None:
                self.admission.cancel_queued(batch.n_requests)
            self._fail_batch(batch, exc)
            return
        fl = _InFlight(batch, out, t0, ticket, runtime, epoch)
        with self._done:
            self._inflight.append(fl)
            self._batches += 1
            if full:
                self._flushes_full += 1
            else:
                self._flushes_deadline += 1
            self._valid_rows += batch.n_valid
            self._padded_rows += batch.n_padded
            self._done.notify_all()

    # -- staging and the copy back ------------------------------------------
    @staticmethod
    def _on(stream):
        """Make ``stream`` the calling thread's current stream (a no-op
        off the card)."""
        return (contextlib.nullcontext() if stream is None
                else torch.cuda.stream(stream))

    def _stage_batch(self, queries: np.ndarray):
        """``(staged, pinned)``: the padded batch on ``device`` and the
        pinned host buffer its copy reads (None when nothing must be
        kept). Runs on the calling thread's current stream."""
        if self._stage is not None:
            return self._stage(queries), None
        if self._stream is None:
            return torch.tensor(queries), None
        pinned = torch.empty(queries.shape, dtype=torch.float32,
                             pin_memory=True)
        pinned.numpy()[...] = queries
        return pinned.to(self.device, non_blocking=True), pinned

    def _to_host(self, out: Any, staged=None) -> _Result:
        """Enqueue, on the current stream, a ``non_blocking`` copy of
        every CUDA tensor of ``out`` into a pinned host tensor, then
        record the event that says they have landed — so the drain
        thread needs no device call to read them."""
        if self._stream is None:
            return _Result(out, None, staged)

        def copy(leaf):
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                host = torch.empty(leaf.shape, dtype=leaf.dtype,
                                   pin_memory=True)
                host.copy_(leaf, non_blocking=True)
                return host
            return leaf

        host = _tree.tree_map(copy, out)
        event = torch.cuda.Event()
        event.record()
        return _Result(host, event, staged)

    # -- the drain (demux) thread --------------------------------------------
    def _hedge_delay_s(self) -> Optional[float]:
        if self.hedge is None or self._backup is None:
            return None
        if isinstance(self.hedge, HedgePolicy):
            return self.hedge.hedge_delay_s()
        return float(self.hedge)

    def _maybe_hedge(self, fl: _InFlight, delay: float) -> None:
        now = self._clock()
        if fl.hedged or fl.hedge_pending or now - fl.t_dispatch < delay:
            return
        # a batch whose answer is already in is no straggler: the sweep
        # checks hedges before readiness, and a dispatch that ran
        # synchronously past the delay (a CPU dispatch, a slow launch)
        # must not be hedged on its way to the demux
        if any(c.ready() for c in fl.candidates):
            return
        # space retries by the hedge delay: a transiently-failing
        # backup gets another shot next window, not every 0.5 ms sweep
        if (fl.t_hedge_attempt is not None
                and now - fl.t_hedge_attempt < delay):
            return
        fl.t_hedge_attempt = now
        # the drain thread makes no device call: the hedge thread stages
        # and dispatches the backup on the second stream
        fl.hedge_pending = True
        self._hedger.submit(self._hedge, fl, now)

    def _hedge(self, fl: _InFlight, now: float) -> None:
        """The hedge thread: re-stage the batch's host copy and dispatch
        it through ``backup_dispatch`` on the hedge stream."""
        try:
            with self._on(self._hedge_stream):
                staged, pinned = self._stage_batch(fl.batch.queries)
                backup = self._to_host(
                    self._backup(staged, **fl.runtime), pinned)
        except Exception as exc:   # noqa: BLE001 — primary still owes
            fl.hedge_pending = False           # the answer
            if self.flight is not None:
                self.flight.record(
                    "hedge_fail", batch_id=fl.batch.batch_id,
                    error=type(exc).__name__,
                )
            return
        # mark hedged only on a SUCCESSFUL backup dispatch: the flag
        # drives the primary_wins/backup_wins accounting in _finish,
        # and a failed attempt must leave the batch re-hedgeable. A
        # backup landing after the drain thread took the batch still
        # counts as dispatched load, but is not a candidate any more.
        with self._lock:
            if not fl.finished:
                fl.hedged = True
                fl.candidates.append(backup)
            fl.hedge_pending = False
            self._hedged_batches += 1
        self._c_hedges.inc()
        if self.flight is not None:
            # this event NAMES the straggler: the batch that sat
            # unready past the hedge delay, and for how long
            self.flight.record(
                "hedge", batch_id=fl.batch.batch_id,
                age_ms=round((now - fl.t_dispatch) * 1e3, 3),
            )
        if isinstance(self.hedge, HedgePolicy):
            with self.hedge._lock:
                self.hedge.hedges += 1

    def _drain_loop(self) -> None:
        poll_s = 0.0005
        while True:
            with self._done:
                while not self._inflight and not (
                    self._closed and self._batcher_exited
                ):
                    self._done.wait(0.05)
                if not self._inflight:
                    if self._closed and self._batcher_exited \
                            and not self._pending:
                        return
                    continue
                snapshot = list(self._inflight)
            # hedge-delay check EVERY iteration: near saturation some
            # batch is almost always ready, and a straggler must not
            # wait for an idle poll loop to be covered. The delay is
            # batch-independent — compute it once per sweep, not per
            # batch (HedgePolicy.hedge_delay_s takes its lock and runs
            # a percentile over the sample window)
            delay = self._hedge_delay_s()
            if delay is not None:
                for fl in snapshot:
                    self._maybe_hedge(fl, delay)
            finished = None
            for fl in snapshot:                # completion order, not FIFO
                for cand in list(fl.candidates):
                    if cand.ready():
                        finished = (fl, cand)
                        break
                if finished is not None:
                    break
            if finished is None:
                Interruptible.yield_now()
                time.sleep(poll_s)
                poll_s = min(poll_s * 2.0, 0.02)
                continue
            poll_s = 0.0005
            fl, winner = finished
            with self._done:
                self._inflight.remove(fl)
                fl.finished = True
                self._done.notify_all()
            self._finish(fl, winner)

    def _finish(self, fl: _InFlight, winner: Any) -> None:
        if fl.ticket is not None:
            self.admission.finish_service(fl.ticket)
        held = self._clock() - fl.t_dispatch
        bucket = fl.batch.bucket
        # dispatch→ready straight from the drain loop's own readiness
        # polling — the stamp pair already existed, no new sync
        self._hist("dispatch_ready", bucket).observe(held * 1e3)
        backup_won = fl.hedged and len(fl.candidates) > 1 \
            and winner is fl.candidates[1]
        winner = winner.host
        if isinstance(self.hedge, HedgePolicy):
            self.hedge.record(held)
            with self.hedge._lock:
                if not fl.hedged:
                    self.hedge.unhedged += 1
                elif backup_won:
                    self.hedge.backup_wins += 1
                else:
                    self.hedge.primary_wins += 1
        # readiness gates carry the real output in .value — demux the
        # underlying tree
        while callable(getattr(winner, "query", None)) \
                and hasattr(winner, "value") and not hasattr(winner, "shape"):
            winner = winner.value
        t_demux0 = self._clock()
        try:
            # the winner's event is done: its pinned buffers hold the
            # result, and reading them is no device call
            host = _tree.tree_map(_host_array, winner)
        except Exception as exc:   # noqa: BLE001
            self._fail_batch(fl.batch, exc)
            return
        # mnmg coverage, read off the ALREADY-converted host result (a
        # PartialSearchResult-shaped pytree carries .coverage) — the
        # degraded-serving gauge, no extra sync
        cov = getattr(host, "coverage", None)
        if cov is not None:
            try:
                cov_min = float(np.min(cov))
            except (TypeError, ValueError):
                cov_min = None
            if cov_min is not None:
                if self._g_coverage is None:
                    self._g_coverage = self._registry.gauge(
                        "serving_coverage_min", executor=self.name)
                self._g_coverage.set(cov_min)
        # retire the batch's coalescing leaders FIRST: once released,
        # no new follower can attach, so this demux resolves exactly
        # the snapshot — including followers of a leader whose own
        # caller cancelled (their rows are right here in the batch)
        subs = self._release_followers(fl.batch)
        delivered = 0
        n_followers = 0
        fills = []
        for req, start in fl.batch.entries:
            followers = subs.get(req.req_id, ())
            if req.future.done() and not followers:
                continue              # caller cancelled while queued
            rows = slice(start, start + req.n_rows)
            result = _tree.tree_map(
                lambda a, rows=rows: a[rows] if (
                    isinstance(a, np.ndarray) and a.ndim >= 1
                    and a.shape[0] == bucket
                ) else a,
                host,
            )
            if not req.future.done():
                try:
                    req.future.set_result(result)
                    delivered += 1
                except InvalidStateError:
                    pass              # cancel raced the done() check
            for f in followers:
                try:
                    f.set_result(result)
                    n_followers += 1
                except InvalidStateError:
                    pass              # the follower's caller cancelled
            if self._rcache is not None:
                fills.append((req, result))
        if fills:
            # fill AFTER resolving the callers (cache writes are off the
            # latency path), stamped with the DISPATCH epoch, re-using
            # the submit-time signatures; close() waits for them
            if self._filler is None:
                self._cache_fill(fills, fl.epoch)
            else:
                self._filler.submit(self._cache_fill, fills, fl.epoch)
        now = self._clock()
        self._hist("demux", bucket).observe((now - t_demux0) * 1e3)
        e2e = self._hist("e2e", bucket)
        for req, _start in fl.batch.entries:
            e2e.observe((now - req.t_arrival) * 1e3)
        delivered += n_followers
        self._c_completed.inc(delivered)
        if backup_won:
            self._c_backup_wins.inc()
        if self.flight is not None:
            self.flight.record(
                "demux", batch_id=fl.batch.batch_id,
                winner=("backup" if backup_won
                        else "primary" if fl.hedged else "unhedged"),
                held_ms=round(held * 1e3, 3), delivered=delivered,
            )
        with self._lock:
            self._completed += delivered
            self._backup_wins += int(backup_won)

    def _cache_fill(self, fills: list, epoch: int) -> None:
        """Insert a batch's demuxed requests (the drain thread for host
        tiers, the cache-fill thread for tiers on the card)."""
        for req, result in fills:
            self._cache_fill_one(req, result, epoch)

    def _cache_fill_one(self, req: PendingRequest, result: Any,
                        epoch: int) -> None:
        """Insert one demuxed request into the result cache when the
        result has the standard search shape — a ``(dists, ids)`` pair
        of ``(m, k)`` arrays at the cache's k. Anything else (a
        PartialSearchResult pytree, a mutation-tier triple, a
        different k) is silently not cached: the cache accelerates the
        common search path, it never constrains the dispatch contract."""
        try:
            if not isinstance(result, (tuple, list)) or len(result) != 2:
                return
            dists, ids = result
            m = req.n_rows
            k = self._rcache.k
            if not (isinstance(dists, np.ndarray)
                    and isinstance(ids, np.ndarray)
                    and dists.shape == (m, k) and ids.shape == (m, k)
                    and np.issubdtype(dists.dtype, np.floating)
                    and np.issubdtype(ids.dtype, np.integer)):
                return
            # req.sigs was computed at submit with this cache's salt —
            # re-using it keeps the per-row hashing off this thread
            self._rcache.insert(req.queries, dists, ids, epoch=epoch,
                                sigs=req.sigs)
        except Exception:   # noqa: BLE001 — a cache-write failure must
            pass            # never fail a delivered request

    def _fail_batch(self, batch: MicroBatch, exc: BaseException) -> None:
        if self.flight is not None:
            # the postmortem path: record the failure, then dump the
            # ring BEFORE resolving futures — the file shows what the
            # doomed batch looked like when it died (deadline trips
            # arrive here too: a timed-out dispatch raises)
            self.flight.record(
                "batch_fail", batch_id=batch.batch_id,
                bucket=batch.bucket, error=type(exc).__name__,
                message=str(exc)[:200],
                requests=[r.req_id for r, _ in batch.entries],
            )
            try:
                self.flight.dump("batch-fail")
            except Exception:   # noqa: BLE001 — a failed DUMP (bad
                pass            # dir, disk full) must not escape this
                                # handler: the futures below still owe
                                # their callers the real exception, and
                                # an escape would kill the worker thread
        subs = self._release_followers(batch)
        n_failed = batch.n_requests
        for req, _ in batch.entries:
            if not req.future.done():
                try:
                    req.future.set_exception(exc)
                except InvalidStateError:
                    pass              # cancel raced the done() check
            for f in subs.get(req.req_id, ()):
                n_failed += 1
                try:
                    f.set_exception(exc)
                except InvalidStateError:
                    pass              # the follower's caller cancelled
        self._c_failed.inc(n_failed)
        with self._lock:
            self._failed += n_failed
