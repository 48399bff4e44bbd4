"""Runtime observability for the serving tier — the port of
``raft_tpu/obs``: metrics and the flight recorder.

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

The JAX package's SLO-triggered profile capture (``ProfileTrigger``) is
not ported yet.
"""

from raft_tpu_torch.obs.flight import FlightRecorder
from raft_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    default_registry,
    enabled,
    program_census,
    set_enabled,
)

__all__ = [
    "MetricRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "FlightRecorder",
    "default_registry",
    "enabled",
    "set_enabled",
    "program_census",
]
