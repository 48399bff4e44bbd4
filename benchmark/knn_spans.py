"""The brute-force kNN's own ranges in a traced run, for the ``knn.*``
readers and the two kNN rooflines.

The port holds CPU-scope ranges around its brute-force search (one
``knn.search`` a call, and the phases inside it: ``knn.chunk_mins``,
``knn.select``, ``knn.rescore``, ``knn.scan``). They put nothing on the
device timeline; each range's kernels are those launched inside it, as
the profiler correlates them.

:func:`of` reduces a run's capture once, as ``program_spans`` does for
the IVF ranges: per phase the device time of the kernels launched inside
its ranges less that of ``knn.*`` ranges nested in them, and the device
idle in gaps whose midpoint lies inside a ``knn.search`` range. A program
without these ranges gives None here, and every reader then reports
nothing.
"""

from __future__ import annotations

import torch

from benchmark import program_spans
from benchmark.tracing import gaps_by_span, merged

ENTRY = "knn.search"
PHASES = ("knn.chunk_mins", "knn.select", "knn.rescore", "knn.scan")
_CUDA = torch.autograd.DeviceType.CUDA


def is_knn(name: str) -> bool:
    return name.startswith("knn.")


def _own_us(e) -> float:
    """Device time (us) of the kernels launched inside ``e`` and its
    descendants, not inside a ``knn.*`` range nested in it."""
    own = sum(k.duration for k in e.kernels)
    for c in e.cpu_children:
        if not is_knn(c.name):
            own += _own_us(c)
    return own


def reduce_events(events) -> dict | None:
    """The capture's ``knn.*`` ranges reduced (times in us); None without
    a ``knn.search`` range."""
    entries, intervals = [], []
    phase_us = {p: 0.0 for p in PHASES}
    for e in events:
        if e.device_type == _CUDA:
            if not (e.name.startswith("bench.") or is_knn(e.name)
                    or program_spans.is_program(e.name)):
                intervals.append((e.time_range.start, e.time_range.end))
        elif e.name == ENTRY:
            entries.append((e.time_range.start, e.time_range.end, "entry"))
        elif e.name in phase_us:
            phase_us[e.name] += _own_us(e)
    if not entries:
        return None
    return {
        "calls": len(entries),
        "device": bool(intervals),
        "phase_us": phase_us,
        "idle_us": 1e6 * gaps_by_span(merged(intervals), entries).get("entry", 0.0),
    }


def of(run) -> dict | None:
    """:func:`reduce_events` of the run's capture, once a run; None
    without a capture, a ``knn.search`` range, or any device activity."""
    if "_knn_spans" not in run.__dict__:
        prof = getattr(run.trace, "_prof", None) if run.trace else None
        red = reduce_events(prof.events()) if prof is not None else None
        run._knn_spans = red if red and red["device"] else None
    return run._knn_spans


def per_call_ms(run, key: str, phase: str | None = None) -> float | None:
    """A reduced time per captured call, in ms: ``key`` of :func:`of`, or
    the phase's own device time with ``key="phase_us"``."""
    red = of(run)
    if red is None:
        return None
    us = red[key][phase] if phase else red[key]
    return 1e-3 * us / red["calls"]


def roofline_pct(run, phase: str, span: str, least_s) -> float | None:
    """The least time of the captured launches kept under the harness
    span ``span`` (``least_s`` on each launch's inputs) over the device
    time of the kernels in the program's ``phase`` ranges, in percent."""
    red = of(run)
    kept = run.trace.kept.get(span) if run.trace else None
    if red is None or not kept or red["phase_us"][phase] <= 0:
        return None
    return 100.0 * sum(least_s(*k) for k in kept) / (1e-6 * red["phase_us"][phase])
