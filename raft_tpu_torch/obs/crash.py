"""Uncaught-thread-exception routing: ``threading.excepthook`` -> obs.
The port of ``raft_tpu/obs/crash.py``.

Every long-lived worker in the serving tier is a daemon thread — the
executor's batcher/drainer, the background compactor, the obs emitter,
the metrics emitter. A daemon thread that dies of an uncaught
exception vanishes silently: Python prints a traceback to stderr (often
swallowed by the harness) and the process keeps running with a wedged
pipeline. :func:`install_excepthook` chains a hook onto
``threading.excepthook`` that

* increments ``thread_uncaught_total{thread=<name>}`` in the process
  registry (docs/observability.md catalog), and
* records a ``thread_uncaught`` flight event on the registered sink
  (:func:`set_flight_sink` — the serving executor registers its
  recorder at construction),

then delegates to the PREVIOUS hook, so the stderr traceback (or a
user-installed hook) still fires. Installation is idempotent and
happens automatically wherever the repo starts a daemon thread; the
hook itself never raises (a crash handler that crashes hides the
original failure).
"""

from __future__ import annotations

import threading
from typing import List

from raft_tpu_torch.obs import metrics as _metrics

__all__ = ["install_excepthook", "set_flight_sink"]

_installed: List[bool] = [False]
_prev_hook: list = [None]
_flight_sink: list = [None]


def set_flight_sink(recorder) -> None:
    """Register the :class:`~raft_tpu_torch.obs.flight.FlightRecorder` that
    receives ``thread_uncaught`` events (last registration wins;
    ``None`` clears)."""
    _flight_sink[0] = recorder


def _hook(args) -> None:
    try:
        name = args.thread.name if args.thread is not None else "<unknown>"
        if _metrics.enabled():
            _metrics.default_registry().counter(
                "thread_uncaught_total", thread=name,
            ).inc()
        fr = _flight_sink[0]
        if fr is not None:
            fr.record(
                "thread_uncaught", thread=name,
                exc_type=getattr(args.exc_type, "__name__",
                                 str(args.exc_type)),
                message=str(args.exc_value),
            )
    except Exception:   # noqa: BLE001 — never mask the original crash
        pass
    prev = _prev_hook[0]
    if prev is not None:
        prev(args)


def install_excepthook() -> None:
    """Route uncaught thread exceptions through the obs hook
    (idempotent; the previous hook keeps firing after ours)."""
    if _installed[0]:
        return
    _prev_hook[0] = threading.excepthook
    threading.excepthook = _hook
    _installed[0] = True
