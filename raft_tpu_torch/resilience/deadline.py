"""Deadlines and retries for serving dispatches — the port of
``raft_tpu/resilience/deadline.py``. Readiness is a CUDA event's
``query()`` where the JAX package polls ``Array.is_ready()``
(:func:`raft_tpu_torch.core.interruptible.waitables`).

The reference treats cancellable waits as a core primitive
(``raft::interruptible`` polls a stream wait, interruptible.hpp:66-120)
but leaves deadlines and retry policy to callers. At serving scale
(ROADMAP north star) a slow chip, a preempted host, or a hung collective
must turn into a bounded, classified error the caller can retry — not an
indefinite block. This module provides that failure model:

* :class:`Deadline` — a monotonic-clock budget shared across attempts;
* :class:`RetryPolicy` — max attempts, exponential backoff with
  DETERMINISTIC jitter (seeded; two replicas retrying the same failure
  de-synchronize identically run-to-run, so chaos tests replay exactly),
  and retryable-error classification;
* :func:`dispatch_with_deadline` — dispatch + bounded wait + retry,
  built on ``Interruptible.synchronize(timeout_s=...)``. Retries call
  the SAME function object again: a retry costs one more dispatch;
* :class:`HedgePolicy` + :func:`dispatch_hedged` — tail-latency
  hedging: when the primary dispatch is still not ready after a
  percentile-derived hedge delay, a backup is dispatched and the FIRST
  ready answer wins (the "tied requests" pattern; the loser's device
  work completes in the background — cooperative semantics, exactly
  like an abandoned retry). On a card the backup runs on a second
  stream (``backup_stream=``): on the primary's stream it would queue
  behind the straggler it is meant to overtake.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import errors
from raft_tpu_torch.analysis.threads import runtime as lockcheck
from raft_tpu_torch.core.interruptible import Interruptible, waitables

__all__ = [
    "Deadline", "RetryPolicy", "dispatch_with_deadline",
    "HedgePolicy", "dispatch_hedged", "wait_first",
]


@dataclasses.dataclass(frozen=True)
class Deadline:
    """A wall-clock budget on the monotonic clock.

    ``Deadline.after(0.5)`` expires 500 ms from construction; every
    attempt of a retried dispatch draws from the SAME budget, so retries
    can never extend the caller's latency bound. ``Deadline.unbounded()``
    never expires (remaining() is +inf).
    """

    expires_at: float  # time.monotonic() timestamp; +inf = unbounded

    @classmethod
    def after(cls, timeout_s: Optional[float]) -> "Deadline":
        """A deadline ``timeout_s`` seconds from now (None = unbounded)."""
        if timeout_s is None:
            return cls.unbounded()
        errors.expects(
            timeout_s > 0, "Deadline.after: timeout_s=%s must be > 0",
            timeout_s,
        )
        return cls(time.monotonic() + float(timeout_s))

    @classmethod
    def unbounded(cls) -> "Deadline":
        return cls(math.inf)

    @property
    def bounded(self) -> bool:
        return math.isfinite(self.expires_at)

    def remaining(self) -> float:
        """Seconds left (never negative; +inf when unbounded)."""
        return max(0.0, self.expires_at - time.monotonic())

    def expired(self) -> bool:
        return self.remaining() <= 0.0


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry classification + exponential backoff with deterministic
    jitter.

    ``retryable_types`` classifies errors worth re-dispatching: by
    default timeouts (:class:`raft_tpu_torch.errors.RaftTimeoutError`) and
    cancellations are retryable, while logic errors
    (:class:`raft_tpu_torch.errors.RaftLogicError` — a bad argument retried is
    a bad argument again) and everything else are not. The backoff for
    attempt ``a`` (1-based) is
    ``min(max_delay_s, base_delay_s * multiplier**(a-1))`` scaled by a
    jitter factor drawn from a counter-based PRNG seeded on
    ``(seed, a)`` — deterministic across runs and replicas, so fault
    injection replays exactly and two replicas with different seeds
    de-synchronize their retry storms.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    multiplier: float = 2.0
    max_delay_s: float = 2.0
    jitter_frac: float = 0.25
    seed: int = 0
    retryable_types: Tuple[type, ...] = (
        errors.RaftTimeoutError,
        TimeoutError,
    )

    def is_retryable(self, exc: BaseException) -> bool:
        """Classification: may this failure be re-dispatched?"""
        return isinstance(exc, self.retryable_types)

    def backoff_s(self, attempt: int) -> float:
        """Delay before attempt ``attempt + 1`` (after failure number
        ``attempt``, 1-based), with deterministic jitter in
        ``[1 - jitter_frac, 1 + jitter_frac]``."""
        errors.expects(attempt >= 1, "backoff_s: attempt=%d < 1", attempt)
        base = min(
            self.max_delay_s,
            self.base_delay_s * self.multiplier ** (attempt - 1),
        )
        u = float(
            np.random.default_rng((self.seed, attempt)).uniform(-1.0, 1.0)
        )
        return max(0.0, base * (1.0 + self.jitter_frac * u))


def dispatch_with_deadline(
    fn: Callable[..., Any], *args: Any,
    timeout_s: Optional[float] = None,
    deadline: Optional[Deadline] = None,
    retry: Optional[RetryPolicy] = None,
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    **kwargs: Any,
) -> Any:
    """Dispatch ``fn(*args, **kwargs)`` and wait for its outputs under a
    deadline, retrying classified failures.

    * ``timeout_s`` bounds EACH attempt's wait
      (``Interruptible.synchronize(timeout_s=...)`` →
      :class:`raft_tpu_torch.errors.RaftTimeoutError` on expiry);
    * ``deadline`` (optional) is an overall budget across all attempts —
      each attempt's wait is clipped to the tighter of the two, and no
      retry starts once it has expired;
    * ``retry`` governs how many attempts and which errors qualify
      (default: a single attempt, i.e. no retries);
    * ``on_retry(attempt, exc, sleep_s)`` is called before each backoff
      sleep — the observability hook (log/metric the failure).

    ``fn`` is called again on retry, so a retry costs dispatch latency
    only. The abandoned attempt's device work still completes in the
    background (cooperative semantics, exactly like
    ``Interruptible.cancel``) — on one stream this means a retry queues
    behind the straggler it is retrying past; the per-attempt timeout
    covers that window. Each wait polls the events ``fn`` returned, or
    one recorded on the current stream right after ``fn`` returned
    (:func:`~raft_tpu_torch.core.interruptible.waitables`).

    Cancellation composes: a ``cancel()`` aimed at this thread raises
    ``InterruptedException`` out of the wait, which is NOT retryable
    under the default policy and propagates immediately.
    """
    retry = RetryPolicy(max_attempts=1) if retry is None else retry
    errors.expects(
        retry.max_attempts >= 1,
        "dispatch_with_deadline: max_attempts=%d < 1", retry.max_attempts,
    )
    overall = Deadline.unbounded() if deadline is None else deadline
    attempt = 0
    while True:
        attempt += 1
        wait_s: Optional[float] = timeout_s
        if overall.bounded:
            rem = overall.remaining()
            wait_s = rem if wait_s is None else min(wait_s, rem)
        try:
            out = fn(*args, **kwargs)
            Interruptible.synchronize(out, timeout_s=wait_s)
            return out
        except Exception as exc:
            exhausted = (
                attempt >= retry.max_attempts
                or not retry.is_retryable(exc)
                or overall.expired()
            )
            if exhausted:
                raise
            sleep_s = min(retry.backoff_s(attempt), overall.remaining())
            if on_retry is not None:
                on_retry(attempt, exc, sleep_s)
            if sleep_s > 0:
                time.sleep(sleep_s)


class HedgePolicy:
    """Percentile-based hedge-delay tuning + hedge outcome counters
    (thread-safe).

    The hedge delay is the latency percentile at which a dispatch is
    declared "probably straggling" and worth backing up: hedging at p95
    bounds the extra dispatch load to ~5% of traffic while cutting the
    tail above it to roughly ``delay + p50`` (the classic tied-requests
    tradeoff — docs/robustness.md "hedge-delay tuning").
    :func:`dispatch_hedged` records every completed dispatch's latency
    here, so the delay adapts to the measured distribution;
    ``default_delay_s`` serves until ``min_samples`` have been seen, and
    ``min_delay_s``/``max_delay_s`` clamp the estimate (a hedge delay
    below the dispatch cost would double EVERY request's load).

    Counters: ``primary_wins`` / ``backup_wins`` count hedged races by
    winner; ``hedges`` counts backup dispatches (the added-load
    metric); ``unhedged`` counts dispatches the primary won before the
    delay expired.
    """

    def __init__(self, *, percentile: float = 95.0,
                 default_delay_s: float = 0.05,
                 min_delay_s: float = 0.0,
                 max_delay_s: float = 10.0,
                 window: int = 1024, min_samples: int = 16):
        errors.expects(
            0.0 < percentile <= 100.0,
            "HedgePolicy: percentile=%s out of range (0, 100]", percentile,
        )
        errors.expects(
            min_delay_s <= max_delay_s,
            "HedgePolicy: min_delay_s=%s > max_delay_s=%s",
            min_delay_s, max_delay_s,
        )
        errors.expects(
            window >= 1 and min_samples >= 1,
            "HedgePolicy: window=%d / min_samples=%d must be >= 1",
            window, min_samples,
        )
        self.percentile = float(percentile)
        self.default_delay_s = float(default_delay_s)
        self.min_delay_s = float(min_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.window = int(window)
        self.min_samples = int(min_samples)
        self._lock = lockcheck.make_lock("HedgePolicy._lock")
        self._samples: List[float] = []
        self.hedges = 0
        self.unhedged = 0
        self.primary_wins = 0
        self.backup_wins = 0

    def record(self, seconds: float) -> None:
        """Record one completed dispatch's latency (a bounded sliding
        window of the most recent ``window`` samples)."""
        with self._lock:
            self._samples.append(float(seconds))
            if len(self._samples) > self.window:
                del self._samples[: len(self._samples) - self.window]

    @property
    def n_samples(self) -> int:
        with self._lock:
            return len(self._samples)

    def hedge_delay_s(self) -> float:
        """The current hedge delay: the configured latency percentile of
        the recorded window, clamped to [min_delay_s, max_delay_s];
        ``default_delay_s`` (clamped) until ``min_samples`` samples."""
        with self._lock:
            if len(self._samples) < self.min_samples:
                est = self.default_delay_s
            else:
                est = float(
                    np.percentile(np.asarray(self._samples),
                                  self.percentile)
                )
        return min(self.max_delay_s, max(self.min_delay_s, est))


def wait_first(candidates, *, timeout_s: Optional[float],
               poll_interval_s: float = 0.0005,
               max_poll_interval_s: float = 0.02) -> int:
    """Index of the FIRST fully-ready candidate (every event of its
    :func:`~raft_tpu_torch.core.interruptible.waitables` done), polling with the same cancellable backoff loop as
    ``Interruptible.synchronize``; :class:`raft_tpu_torch.errors.RaftTimeoutError`
    if none is ready within ``timeout_s``. Public for custom dispatch
    layers racing replica candidates the way :func:`dispatch_hedged`
    does. (The open-loop executor's drain loop implements the same
    readiness idiom NON-blocking — it sweeps many in-flight batches per
    poll instead of parking on one candidate set, so it cannot call
    this helper.)"""
    pending = [waitables(c) for c in candidates]
    deadline = (
        None if timeout_s is None else time.monotonic() + timeout_s
    )
    interval = poll_interval_s
    while True:
        Interruptible.yield_now()
        for i, leaves in enumerate(pending):
            pending[i] = [w for w in leaves if not w.query()]
            if not pending[i]:
                return i
        if deadline is not None and time.monotonic() >= deadline:
            raise errors.RaftTimeoutError(
                "dispatch_hedged: neither primary nor backup ready "
                f"within {timeout_s:.3g}s"
            )
        time.sleep(interval)
        interval = min(interval * 2.0, max_poll_interval_s)


def dispatch_hedged(
    fn: Callable[..., Any], *args: Any,
    hedge: "HedgePolicy | float" = 0.05,
    backup_fn: Optional[Callable[..., Any]] = None,
    timeout_s: Optional[float] = None,
    deadline: Optional[Deadline] = None,
    on_hedge: Optional[Callable[[float], None]] = None,
    backup_stream: "torch.cuda.Stream | None" = None,
    **kwargs: Any,
) -> Any:
    """Dispatch ``fn(*args, **kwargs)`` and, if it is still not ready
    after the hedge delay, dispatch a backup — the first ready answer
    wins (Dean & Barroso's "tied requests": the p99 of a hedged
    dispatch collapses toward ``hedge_delay + p50``, because a
    straggling chip no longer holds the answer hostage).

    * ``hedge``: a :class:`HedgePolicy` (percentile-adaptive, records
      every completed latency and counts outcomes) or a fixed delay in
      seconds;
    * ``backup_fn``: the backup dispatch (default: ``fn`` again — on a
      replicated deployment pass the OTHER replica's entry point, so
      the backup cannot land on the same straggling chip);
    * ``timeout_s`` / ``deadline``: overall wait bound across both
      dispatches (the tighter wins), raising
      :class:`raft_tpu_torch.errors.RaftTimeoutError` — measured from entry,
      so the hedge delay spends the same budget;
    * ``on_hedge(delay_s)``: observability hook, called once when the
      backup is actually dispatched;
    * ``backup_stream``: the CUDA stream the backup is enqueued on (the
      primary runs on the caller's current stream). Give a second stream
      on a card: on the primary's own stream the backup could never
      finish first.

    Each candidate's readiness is fixed when it is dispatched: the
    events it returns, or one recorded on its stream right then
    (:func:`~raft_tpu_torch.core.interruptible.waitables`), so the
    primary's wait never covers the backup's work.

    The LOSER is abandoned, not preempted: its device work completes in
    the background (cooperative semantics, exactly like a
    ``dispatch_with_deadline`` retry past a straggler), and its output
    buffers are dropped with the reference. Hedging therefore costs up
    to one duplicate dispatch per hedge — bound it by hedging at a high
    percentile.
    """
    policy = hedge if isinstance(hedge, HedgePolicy) else None
    delay_s = (
        policy.hedge_delay_s() if policy is not None else float(hedge)
    )
    errors.expects(
        delay_s >= 0, "dispatch_hedged: hedge delay %s < 0", delay_s
    )
    overall = Deadline.unbounded() if deadline is None else deadline
    if timeout_s is not None:
        overall = Deadline(
            min(overall.expires_at, time.monotonic() + timeout_s)
        )
    t0 = time.monotonic()
    primary = fn(*args, **kwargs)
    primary_w = waitables(primary)
    first_wait = delay_s
    if overall.bounded:
        first_wait = min(first_wait, overall.remaining())
    try:
        Interruptible.synchronize(primary_w, timeout_s=first_wait)
        if policy is not None:
            policy.record(time.monotonic() - t0)
            with policy._lock:
                policy.unhedged += 1
        return primary
    except errors.RaftTimeoutError:
        if overall.bounded and overall.expired():
            raise  # the budget, not the hedge delay, ended the wait
    if policy is not None:
        with policy._lock:
            policy.hedges += 1
    if on_hedge is not None:
        on_hedge(delay_s)
    with (torch.cuda.stream(backup_stream) if backup_stream is not None
          else contextlib.nullcontext()):
        backup = (backup_fn if backup_fn is not None else fn)(
            *args, **kwargs
        )
        backup_w = waitables(backup)
    winner = wait_first(
        (primary_w, backup_w),
        timeout_s=overall.remaining() if overall.bounded else None,
    )
    if policy is not None:
        policy.record(time.monotonic() - t0)
        with policy._lock:
            if winner == 0:
                policy.primary_wins += 1
            else:
                policy.backup_wins += 1
    return primary if winner == 0 else backup
