"""Admission control for the serving path — shed early, never collapse.
The port of ``raft_tpu/resilience/admission.py`` (host code, same
behaviour).

An overloaded queue is the quiet killer of tail latency: past the
sustainable rate, every admitted request makes EVERY later request
slower, latency grows without bound, and by the time clients time out
the server has burned its capacity computing answers nobody is waiting
for. The cure is ancient and boring: bound the queue, and REJECT at the
door once it is full — a shed request costs microseconds and tells the
client exactly when to retry, while an admitted-then-late request costs
a full dispatch and tells nobody anything (docs/serving.md "Overload
and shedding").

:class:`AdmissionController` is that door for the serving
dispatches:

* a **concurrency bound** (``max_concurrent``) — how many dispatches
  may be in flight at once (usually 1 per mesh: the device serializes
  them anyway, and queueing host-side keeps the deadline machinery in
  charge);
* a **queue bound** (``max_queue``) — how many requests may WAIT for a
  slot; arrivals beyond it are shed immediately with
  :class:`raft_tpu_torch.errors.RaftOverloadError` carrying ``retry_after_s``
  (estimated from the measured service time — the queue ahead of the
  client, priced);
* an optional **token limiter** (``rate`` tokens/s, ``burst`` bucket
  depth) — an absolute request-rate ceiling independent of measured
  service time, for capping a tenant or protecting a cold cache;
* **counters** (:meth:`AdmissionController.stats`): admitted / shed /
  completed / queue depth / peak depth — the shed-rate observability
  the overload bench row reports.

Two entry styles share the same bounds, counters, and pricing:

* the **blocking** context manager (``with ctrl.admit(): dispatch()``)
  — one thread per request, the queue wait happens inside ``admit``;
* the **asynchronous** triple :meth:`AdmissionController.enqueue` /
  :meth:`~AdmissionController.begin_service` /
  :meth:`~AdmissionController.finish_service` — the open-loop serving
  executor's path (:mod:`raft_tpu_torch.serving`), where a request is queued
  by the arrival thread, dispatched inside a micro-batch by the batcher
  thread, and completed by the demux thread. ``enqueue`` NEVER blocks:
  an open-loop arrival stream must be answered shed-or-queued
  immediately, not slowed to the service rate. Its bound is the
  blocking path's TOTAL capacity — queued + in-service requests vs
  ``max_queue + max_concurrent`` — because a request the blocking
  world would have handed a free slot immediately sits in the async
  queue until the batcher picks it up. ``max_concurrent`` is not
  re-checked at :meth:`~AdmissionController.begin_service`: the
  executor coalesces queued requests into micro-batches (its
  ``max_in_flight`` window bounds device concurrency), so in-service
  REQUEST count legitimately exceeds concurrent program count.

``retry_after_s`` pricing is occupancy-aware: the per-request service
estimate is the completion-measured EWMA *or the age of the oldest
request still in service, whichever is larger*. The EWMA alone is
updated only on completions, so a burst landing after an idle stretch
(or a service-time regression) would price retries from stale history
while the evidence of the true current service time — how long the
in-flight work has already been running — sits unread in the occupancy
(regression-tested with an injected clock).

Everything is host-side and thread-safe; the injected ``clock`` makes
the limiter and the pricing deterministic under test. Timeouts while
QUEUED raise :class:`raft_tpu_torch.errors.RaftTimeoutError` (the caller's
deadline expired — same classification as a slow dispatch), never an
overload.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Callable, Optional

from raft_tpu_torch import errors
from raft_tpu_torch.analysis.threads import runtime as lockcheck
from raft_tpu_torch.obs import metrics as obs_metrics
from raft_tpu_torch.resilience.deadline import Deadline

__all__ = ["AdmissionController", "AdmissionStats"]


@dataclasses.dataclass(frozen=True)
class AdmissionStats:
    """A point-in-time snapshot of an :class:`AdmissionController`'s
    counters (all monotonic except the two depth gauges)."""

    admitted: int
    completed: int
    shed_queue: int
    shed_rate: int
    timed_out: int
    in_flight: int
    queue_depth: int
    peak_queue_depth: int

    @property
    def shed(self) -> int:
        """Total requests rejected at the door (queue + rate)."""
        return self.shed_queue + self.shed_rate

    @property
    def offered(self) -> int:
        """Total requests that reached the controller."""
        return self.admitted + self.shed + self.timed_out

    @property
    def shed_fraction(self) -> float:
        off = self.offered
        return self.shed / off if off else 0.0


class AdmissionController:
    """Bounded-depth admission for serving dispatches (thread-safe).

    ``with ctrl.admit(timeout_s=...):`` brackets one request: it either
    acquires an in-flight slot (waiting in the bounded queue if
    necessary), sheds immediately with
    :class:`~raft_tpu_torch.errors.RaftOverloadError` (queue full or token
    limiter empty), or raises
    :class:`~raft_tpu_torch.errors.RaftTimeoutError` when the caller's wait
    budget expires while queued. The body runs the dispatch; slot
    release and the service-time EWMA (which prices ``retry_after_s``
    for later sheds) happen on exit, success or failure.

    ``retry_after_s``: fallback retry-after for sheds before any
    service time has been measured (None = omit the estimate).
    ``clock``: monotonic-seconds source, injectable for deterministic
    token-limiter tests.
    ``registry`` / ``name``: where the live shed/occupancy series
    (``admission_shed_total{controller=name, reason}``, the
    queue/in-flight/service-EWMA gauges) record — default the
    process-wide :func:`raft_tpu_torch.obs.default_registry`
    (docs/observability.md; ``RAFT_TPU_OBS=off`` no-ops them).
    """

    def __init__(self, *, max_concurrent: int = 1, max_queue: int = 0,
                 rate: Optional[float] = None,
                 burst: Optional[int] = None,
                 retry_after_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 registry: "obs_metrics.MetricRegistry | None" = None,
                 name: str = "admission"):
        errors.expects(
            max_concurrent >= 1,
            "AdmissionController: max_concurrent=%d < 1", max_concurrent,
        )
        errors.expects(
            max_queue >= 0,
            "AdmissionController: max_queue=%d < 0", max_queue,
        )
        errors.expects(
            rate is None or rate > 0,
            "AdmissionController: rate=%s must be > 0 (or None)", rate,
        )
        self.max_concurrent = int(max_concurrent)
        self.max_queue = int(max_queue)
        self.rate = None if rate is None else float(rate)
        self.burst = (
            None if self.rate is None
            else max(1, int(burst if burst is not None else 1))
        )
        self.retry_after_s = retry_after_s
        self._clock = clock
        self._lock = lockcheck.make_lock("AdmissionController._lock")
        self._slot_free = lockcheck.make_condition(self._lock)
        self._in_flight = 0
        self._queue_depth = 0
        self._peak_queue = 0
        self._admitted = 0
        self._completed = 0
        self._shed_queue = 0
        self._shed_rate = 0
        self._timed_out = 0
        self._service_ewma_s: Optional[float] = None
        # requests currently IN SERVICE: ticket -> (start stamp, n).
        # The stamps feed occupancy-aware retry_after pricing (the age
        # of the oldest in-flight work bounds the estimate from below)
        self._inflight_started: dict = {}
        self._next_ticket = 0
        # token bucket state (continuous refill at `rate`/s up to burst)
        self._tokens = float(self.burst or 0)
        self._token_stamp = clock()
        # live shed/occupancy metrics (docs/observability.md):
        # the same counters stats() snapshots, but readable by a scrape
        # while the overload is HAPPENING. Handles cached here; every
        # recorder honors the RAFT_TPU_OBS gate.
        reg = (obs_metrics.default_registry() if registry is None
               else registry)
        self.name = name
        self._m_shed = {
            "queue": reg.counter("admission_shed_total",
                                 controller=name, reason="queue"),
            "rate": reg.counter("admission_shed_total",
                                controller=name, reason="rate"),
        }
        self._m_timeout = reg.counter("admission_timeouts_total",
                                      controller=name)
        self._g_queue = reg.gauge("admission_queue_depth",
                                  controller=name)
        self._g_inflight = reg.gauge("admission_in_flight",
                                     controller=name)
        self._g_service = reg.gauge("admission_service_ewma_ms",
                                    controller=name)

    # -- observability -------------------------------------------------------
    def stats(self) -> AdmissionStats:
        with self._lock:
            return AdmissionStats(
                admitted=self._admitted,
                completed=self._completed,
                shed_queue=self._shed_queue,
                shed_rate=self._shed_rate,
                timed_out=self._timed_out,
                in_flight=self._in_flight,
                queue_depth=self._queue_depth,
                peak_queue_depth=self._peak_queue,
            )

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return self._queue_depth

    @property
    def in_flight(self) -> int:
        with self._lock:
            return self._in_flight

    def _service_estimate(self) -> Optional[float]:
        """Per-request service-time estimate for pricing: the
        completion-measured EWMA, floored by the AGE of the oldest
        request still in service. The EWMA only moves on completions, so
        after an idle stretch (or a service-time regression) it is stale
        exactly when a burst arrives — but the in-flight occupancy
        already shows the truth: work that has been running for 80 ms is
        evidence the next slot will not free in the 2 ms the old EWMA
        remembers."""
        est = self._service_ewma_s
        if self._inflight_started:
            # PER-REQUEST age: a ticket is a whole micro-batch, and
            # pricing a 64-request batch's 80 ms age as 80 ms/request
            # would overprice retries by the batch size — amortize
            # exactly like finish_service does for the EWMA
            now = self._clock()
            floor = max(
                (now - t0) / max(n, 1)
                for t0, n in self._inflight_started.values()
            )
            est = max(est or 0.0, floor)
        return est

    def _retry_after(self, waiters: int) -> Optional[float]:
        """Price the queue ahead of a shed client: (queued + in-flight)
        service times at the occupancy-floored EWMA
        (:meth:`_service_estimate`); the configured fallback before any
        service evidence exists. Before the FIRST completion the
        fallback also floors the occupancy price — a request that
        started microseconds ago is not evidence service is fast."""
        est = self._service_estimate()
        if est is None:
            return self.retry_after_s
        priced = (waiters + self._in_flight) * est
        if self._service_ewma_s is None and self.retry_after_s is not None:
            priced = max(priced, self.retry_after_s)
        return priced

    def _sync_gauges(self) -> None:
        """Mirror the two depth gauges into the registry (lock held by
        the caller; gauge locks are leaves, no ordering hazard)."""
        self._g_queue.set(self._queue_depth)
        self._g_inflight.set(self._in_flight)

    def _refill_tokens(self, now: float) -> None:
        self._tokens = min(
            float(self.burst),
            self._tokens + (now - self._token_stamp) * self.rate,
        )
        self._token_stamp = now

    # -- the admission gate --------------------------------------------------
    @contextlib.contextmanager
    def admit(self, *, timeout_s: Optional[float] = None,
              deadline: Optional[Deadline] = None):
        """Admit one request (context manager). Sheds with
        :class:`RaftOverloadError` when the queue is at ``max_queue`` or
        the token limiter is empty; raises :class:`RaftTimeoutError` if
        no in-flight slot frees within ``timeout_s`` /
        ``deadline.remaining()`` (the tighter) while queued."""
        if deadline is not None:
            rem = deadline.remaining()
            timeout_s = rem if timeout_s is None else min(timeout_s, rem)
        if timeout_s is not None and not math.isfinite(timeout_s):
            # an unbounded Deadline (remaining() = +inf) means wait
            # forever — Condition.wait(inf) would OverflowError
            timeout_s = None
        with self._lock:
            # queue bound first (stateless check), then the token bucket
            # (which consumes): a queue-shed request must not burn a token
            if (
                self._in_flight >= self.max_concurrent
                and self._queue_depth >= self.max_queue
            ):
                self._shed_queue += 1
                self._m_shed["queue"].inc()
                raise errors.RaftOverloadError(
                    f"admission queue full ({self._queue_depth} waiting, "
                    f"{self._in_flight} in flight; max_queue="
                    f"{self.max_queue})",
                    retry_after_s=self._retry_after(self._queue_depth),
                )
            if self.rate is not None:
                self._refill_tokens(self._clock())
                if self._tokens < 1.0:
                    self._shed_rate += 1
                    self._m_shed["rate"].inc()
                    raise errors.RaftOverloadError(
                        f"rate limit exhausted ({self.rate}/s, burst "
                        f"{self.burst})",
                        retry_after_s=(1.0 - self._tokens) / self.rate,
                    )
                self._tokens -= 1.0
            self._queue_depth += 1
            self._peak_queue = max(self._peak_queue, self._queue_depth)
            self._sync_gauges()
            wait_until = (
                None if timeout_s is None
                else time.monotonic() + timeout_s
            )
            try:
                while self._in_flight >= self.max_concurrent:
                    wait = (
                        None if wait_until is None
                        else wait_until - time.monotonic()
                    )
                    if wait is not None and wait <= 0:
                        self._timed_out += 1
                        self._m_timeout.inc()
                        raise errors.RaftTimeoutError(
                            "admission wait expired after "
                            f"{timeout_s:.3g}s ({self._queue_depth - 1} "
                            "still queued ahead)"
                        )
                    self._slot_free.wait(wait)
            finally:
                self._queue_depth -= 1
                # re-sync HERE, not only in _begin_locked: the timeout
                # path leaves through the exception, and a stale depth
                # gauge during sustained overload is exactly when the
                # gauge matters
                self._sync_gauges()
            ticket = self._begin_locked(1)
        try:
            yield self
        finally:
            self.finish_service(ticket)

    # -- the asynchronous (executor) path ------------------------------------
    def _begin_locked(self, n: int) -> int:
        """Move ``n`` requests into service (lock held): counters, and
        the in-flight start stamp that feeds occupancy pricing."""
        self._in_flight += n
        self._admitted += n
        ticket = self._next_ticket
        self._next_ticket += 1
        self._inflight_started[ticket] = (self._clock(), n)
        self._sync_gauges()
        return ticket

    def enqueue(self, n: int = 1) -> None:
        """NON-BLOCKING admission into the bounded queue — the open-loop
        arrival path (:class:`raft_tpu_torch.serving.ServingExecutor` calls
        this from ``submit``). Sheds immediately with
        :class:`~raft_tpu_torch.errors.RaftOverloadError` (occupancy-priced
        ``retry_after_s``) when total outstanding work (queued + in
        service) is at ``max_queue + max_concurrent`` or the token
        limiter is empty; otherwise the request is QUEUED and the
        caller returns to the arrival stream without waiting for a
        slot. Dispatch/completion are reported later via
        :meth:`begin_service` / :meth:`finish_service`;
        :meth:`cancel_queued` gives up a queued spot (shutdown, caller
        timeout)."""
        errors.expects(n >= 1, "enqueue: n=%d < 1", n)
        with self._lock:
            # the async bound is TOTAL OUTSTANDING (queued + in service)
            # vs max_queue + max_concurrent — the blocking path's total
            # capacity. A pure queue-depth check would shed a default
            # (1, 0) controller's every request on an IDLE server: the
            # async queue holds requests a free slot would have absorbed
            # immediately in the blocking world.
            cap = self.max_queue + self.max_concurrent
            if self._queue_depth + self._in_flight + n > cap:
                self._shed_queue += n
                self._m_shed["queue"].inc(n)
                raise errors.RaftOverloadError(
                    f"admission capacity full ({self._queue_depth} "
                    f"waiting + {self._in_flight} in flight >= "
                    f"max_queue={self.max_queue} + max_concurrent="
                    f"{self.max_concurrent})",
                    retry_after_s=self._retry_after(self._queue_depth),
                )
            if self.rate is not None:
                self._refill_tokens(self._clock())
                if self._tokens < float(n):
                    self._shed_rate += n
                    self._m_shed["rate"].inc(n)
                    raise errors.RaftOverloadError(
                        f"rate limit exhausted ({self.rate}/s, burst "
                        f"{self.burst})",
                        retry_after_s=(float(n) - self._tokens) / self.rate,
                    )
                self._tokens -= float(n)
            self._queue_depth += n
            self._peak_queue = max(self._peak_queue, self._queue_depth)
            self._sync_gauges()

    def begin_service(self, n: int = 1) -> int:
        """Report ``n`` queued requests dispatched (queue → in service).
        Returns the service ticket to pass to :meth:`finish_service`.
        The executor calls this when a micro-batch leaves the batcher;
        from this stamp on, the batch's age floors the retry-after
        pricing (:meth:`_service_estimate`)."""
        errors.expects(n >= 1, "begin_service: n=%d < 1", n)
        with self._lock:
            errors.expects(
                self._queue_depth >= n,
                "begin_service: %d requested but only %d queued",
                n, self._queue_depth,
            )
            self._queue_depth -= n
            return self._begin_locked(n)

    def finish_service(self, ticket: int) -> None:
        """Report a service ticket complete: counters, slot release, and
        the per-request service-time EWMA (batch held-time amortized
        over its ``n`` requests) that prices later sheds."""
        with self._lock:
            t0, n = self._inflight_started.pop(ticket)
            held = max(0.0, self._clock() - t0) / max(n, 1)
            self._in_flight -= n
            self._completed += n
            self._service_ewma_s = (
                held if self._service_ewma_s is None
                else 0.8 * self._service_ewma_s + 0.2 * held
            )
            self._g_service.set(self._service_ewma_s * 1e3)
            self._sync_gauges()
            self._slot_free.notify(n)

    def abort_service(self, ticket: int) -> None:
        """Release a service ticket whose dispatch FAILED: the slot
        frees (waiters wake), but neither the service-time EWMA nor
        ``completed`` moves — a crashed dispatch is not service-time
        evidence (a near-zero ``held`` would drag the EWMA toward 0 and
        underprice every later shed), and its requests were answered
        with an exception, not served."""
        with self._lock:
            _t0, n = self._inflight_started.pop(ticket)
            self._in_flight -= n
            self._sync_gauges()
            self._slot_free.notify(n)

    def cancel_queued(self, n: int = 1) -> None:
        """Give back ``n`` queued spots without serving them (executor
        shutdown, a caller abandoning its queued request)."""
        with self._lock:
            self._queue_depth -= min(n, self._queue_depth)
            self._sync_gauges()

    def __repr__(self) -> str:
        s = self.stats()
        return (
            f"AdmissionController(max_concurrent={self.max_concurrent}, "
            f"max_queue={self.max_queue}, in_flight={s.in_flight}, "
            f"queued={s.queue_depth}, admitted={s.admitted}, "
            f"shed={s.shed})"
        )
