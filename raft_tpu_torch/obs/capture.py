"""SLO-triggered profile capture of the port — the counterpart of
``raft_tpu/obs/capture.py``: when the tail goes bad, grab ONE bounded
trace while it is still bad.

Profiles are the only artifact that explains a latency regression at
the kernel level, but nobody is watching a trace viewer when the p99
breaches at 03:12 — and by the morning the regression is gone.
:class:`ProfileTrigger` closes that loop (docs/observability.md
"SLO-triggered capture"): it watches ONE histogram (e.g. the
executor's ``serving_stage_ms{stage="e2e"}``), and when the WINDOWED
quantile — observations since the previous check only, not the
process-lifetime distribution — stays over the threshold for N
consecutive windows, it fires one bounded
``torch.profiler`` capture through :mod:`raft_tpu_torch.core.annotate`'s
``start_trace``/``stop_trace`` (CPU activity and, where a card is
present, its CUDA kernels, written as a Chrome trace; the profiling
enable flag flips on for exactly the capture span and every
``annotate`` range lands in the trace), records the capture path as a flight-recorder event and a
``profile_captures_total`` counter, and then stands down
(``max_captures`` + ``cooldown_s`` bound the cost: a profile is
expensive, a profile STORM is an outage).

The consecutive-windows requirement is the debounce: one bad window is
a GC pause or a compaction; N bad windows is a regime. Windows with no
traffic carry no evidence and do not advance the breach count.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from raft_tpu_torch import errors
from raft_tpu_torch.analysis.threads import runtime as lockcheck
from raft_tpu_torch.core.annotate import start_trace, stop_trace
from raft_tpu_torch.obs import metrics as _metrics
from raft_tpu_torch.obs.flight import FlightRecorder
from raft_tpu_torch.obs.metrics import (
    Histogram,
    MetricRegistry,
    quantile_from_counts,
)

__all__ = ["ProfileTrigger"]


class ProfileTrigger:
    """Watch a latency histogram; capture one bounded profile when its
    windowed quantile breaches the SLO for ``consecutive`` checks.

    ``histogram`` — the watched
    :class:`~raft_tpu_torch.obs.metrics.Histogram`
    (record milliseconds into it; ``threshold_ms`` compares directly).
    ``quantile`` — which tail to watch (99.0 = p99).
    ``consecutive`` — breach debounce in windows.
    ``capture_s`` — how long one capture runs (bounded by design).
    ``log_dir`` — where the ``torch.profiler`` Chrome trace is written.
    ``max_captures`` / ``cooldown_s`` — the storm bound.
    ``recorder`` — optional
    :class:`~raft_tpu_torch.obs.flight.FlightRecorder`
    that gets a ``profile_capture`` event naming the path.
    ``start``/``stop``/``sleep``/``clock`` are injectable for
    deterministic tests (defaults: the real
    :func:`raft_tpu_torch.core.annotate.start_trace` /
    :func:`~raft_tpu_torch.core.annotate.stop_trace`).

    Drive it either by calling :meth:`check` from your own maintenance
    loop (the serving executor's drain cadence, a health-check sweep) or
    by :meth:`watch`-ing with a background daemon thread.
    """

    def __init__(self, histogram: Histogram, *, threshold_ms: float,
                 log_dir: str, quantile: float = 99.0,
                 consecutive: int = 3, capture_s: float = 0.5,
                 max_captures: int = 1, cooldown_s: float = 600.0,
                 recorder: Optional[FlightRecorder] = None,
                 registry: Optional[MetricRegistry] = None,
                 start: Callable[[str], None] = start_trace,
                 stop: Callable[[], None] = stop_trace,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic):
        errors.expects(threshold_ms > 0,
                       "ProfileTrigger: threshold_ms=%s <= 0",
                       threshold_ms)
        errors.expects(0.0 < quantile <= 100.0,
                       "ProfileTrigger: quantile=%s out of (0, 100]",
                       quantile)
        errors.expects(consecutive >= 1,
                       "ProfileTrigger: consecutive=%d < 1", consecutive)
        errors.expects(capture_s > 0,
                       "ProfileTrigger: capture_s=%s <= 0", capture_s)
        errors.expects(max_captures >= 1,
                       "ProfileTrigger: max_captures=%d < 1",
                       max_captures)
        self.histogram = histogram
        self.threshold_ms = float(threshold_ms)
        self.quantile = float(quantile)
        self.consecutive = int(consecutive)
        self.capture_s = float(capture_s)
        self.log_dir = str(log_dir)
        self.max_captures = int(max_captures)
        self.cooldown_s = float(cooldown_s)
        self.recorder = recorder
        self._registry = (_metrics.default_registry()
                          if registry is None else registry)
        self._start = start
        self._stop_trace = stop
        self._sleep = sleep
        self._clock = clock
        self._lock = lockcheck.make_lock("ProfileTrigger._lock")
        self._prev_counts = histogram.counts_snapshot()
        self._breaches = 0
        self._captures = 0
        self._last_capture_t: Optional[float] = None
        self.capture_paths: List[str] = []
        self._watch_stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None

    @property
    def captures(self) -> int:
        with self._lock:
            return self._captures

    def window_quantile(self) -> Optional[float]:
        """The watched quantile over observations since the LAST check
        (None when the window saw no traffic). Advances the window."""
        now = self.histogram.counts_snapshot()
        with self._lock:
            prev = self._prev_counts
            self._prev_counts = now
        delta = [b - a for a, b in zip(prev, now)]
        return quantile_from_counts(delta, self.quantile)

    def check(self) -> Optional[str]:
        """One watch window: read the windowed quantile, advance the
        breach count, and fire a capture when the debounce and the
        storm bounds allow. Returns the capture path when a capture
        fired, else None."""
        q = self.window_quantile()
        with self._lock:
            if q is None:
                return None        # no traffic, no evidence
            if q <= self.threshold_ms:
                self._breaches = 0
                return None
            self._breaches += 1
            if self._breaches < self.consecutive:
                return None
            now = self._clock()
            if self._captures >= self.max_captures or (
                self._last_capture_t is not None
                and now - self._last_capture_t < self.cooldown_s
            ):
                return None
            # commit to the capture while holding the lock (a racing
            # watcher thread must not double-start the profiler), then
            # run the bounded capture outside it
            prev_stamp = self._last_capture_t
            self._captures += 1
            self._last_capture_t = now
            self._breaches = 0
            breached_ms = q
        try:
            return self._capture(breached_ms)
        except BaseException:
            # a refused start (another capture already running) must
            # not burn the budget — with the default max_captures=1
            # that would disable the trigger for the process lifetime
            # on a capture that never happened. Roll back and re-raise
            # (the watcher thread swallows; a caller-driven check()
            # sees the failure). _breaches stays reset: the next
            # attempt waits out a full debounce, a natural retry delay.
            with self._lock:
                self._captures -= 1
                self._last_capture_t = prev_stamp
            raise

    def _capture(self, breached_ms: float) -> str:
        self._start(self.log_dir)
        try:
            self._sleep(self.capture_s)
        finally:
            self._stop_trace()
        self._registry.counter(
            "profile_captures_total", trigger=self.histogram.name,
        ).inc()
        if self.recorder is not None:
            self.recorder.record(
                "profile_capture", path=self.log_dir,
                breached_ms=round(float(breached_ms), 3),
                quantile=self.quantile,
                threshold_ms=self.threshold_ms,
            )
        with self._lock:
            self.capture_paths.append(self.log_dir)
        return self.log_dir

    # -- the optional watcher thread -----------------------------------------
    def watch(self, interval_s: float = 5.0) -> "ProfileTrigger":
        """Run :meth:`check` every ``interval_s`` on a daemon thread
        (one window per interval). Idempotent; ``stop()`` ends it."""
        errors.expects(interval_s > 0,
                       "ProfileTrigger.watch: interval_s=%s <= 0",
                       interval_s)
        from raft_tpu_torch.obs import crash as _crash

        _crash.install_excepthook()
        with self._lock:
            if self._watch_thread is not None:
                return self
            self._watch_stop.clear()
            self._watch_thread = threading.Thread(
                target=self._watch_loop, args=(float(interval_s),),
                name="obs-profile-trigger", daemon=True,
            )
            self._watch_thread.start()
        return self

    def _watch_loop(self, interval_s: float) -> None:
        while not self._watch_stop.wait(interval_s):
            try:
                self.check()
            except Exception:   # noqa: BLE001 — the watcher must not
                pass            # kill serving; a failed capture is lost
                                # telemetry, not an outage

    def stop(self, timeout_s: float = 5.0) -> None:
        with self._lock:
            th = self._watch_thread
            self._watch_thread = None
        if th is not None:
            self._watch_stop.set()
            th.join(timeout_s)
