"""Runtime observability for the serving tier — the port of
``raft_tpu/obs``: metrics, the flight recorder and the SLO-triggered
profile capture.

* :mod:`raft_tpu_torch.obs.metrics` — the process-wide
  :class:`MetricRegistry` of counters, gauges, and log2 latency
  histograms (streaming p50/p95/p99 at any instant), with Prometheus
  exposition and a periodic JSONL emitter. The serving executor and the
  admission controller record here by default; ``RAFT_TPU_OBS=off``
  turns every recorder into a no-op.
* :mod:`raft_tpu_torch.obs.flight` — the bounded ring-buffer
  :class:`FlightRecorder` of per-request span events
  (submit→pack→dispatch→hedge→demux), dumped as JSONL on failure
  paths.
* :mod:`raft_tpu_torch.obs.capture` — the :class:`ProfileTrigger`: when
  a watched latency histogram's windowed quantile stays over its
  threshold for N consecutive checks, one bounded ``torch.profiler``
  capture (a Chrome trace with the card's kernels), bounded against
  storms by ``max_captures`` and ``cooldown_s``.
"""

from raft_tpu_torch.obs.capture import ProfileTrigger
from raft_tpu_torch.obs.flight import FlightRecorder
from raft_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    default_registry,
    enabled,
    set_enabled,
)

__all__ = [
    "MetricRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "FlightRecorder",
    "ProfileTrigger",
    "default_registry",
    "enabled",
    "set_enabled",
]
