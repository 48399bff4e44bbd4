"""The graph search's own ranges and counters in a traced run, for the
``graph.*`` readers and ``beam_scan_roofline``.

The port holds CPU-scope ranges around its beam search (one
``graph.search`` a call, and the phases of each round inside it:
``graph.frontier``, ``graph.scan``, ``graph.merge``, then
``graph.rerank``), and counts each round's candidate slots by fate in
``graph_search_slots_total{kind}`` while ranges are emitted. The ranges
put nothing on the device timeline; each range's kernels are those
launched inside it, as the profiler correlates them.

:func:`of` reduces a run's capture once, as ``knn_spans`` does for the
brute-force ranges: per phase the device time of the kernels launched
inside its ranges less that of ``graph.*`` ranges nested in them, and the
device idle in gaps whose midpoint lies inside a ``graph.search`` range.
A program without these ranges or counters gives None here, and every
reader then reports nothing.
"""

from __future__ import annotations

import torch

from benchmark import program_spans, roofline_graph
from benchmark.tracing import gaps_by_span, merged

ENTRY = "graph.search"
PHASES = ("graph.frontier", "graph.scan", "graph.merge", "graph.rerank")
SLOTS = "graph_search_slots_total"
SPAN = "bench.beam_scan"
_CUDA = torch.autograd.DeviceType.CUDA


def is_graph(name: str) -> bool:
    return name.startswith("graph.")


def _own_us(e) -> float:
    """Device time (us) of the kernels launched inside ``e`` and its
    descendants, not inside a ``graph.*`` range nested in it."""
    own = sum(k.duration for k in e.kernels)
    for c in e.cpu_children:
        if not is_graph(c.name):
            own += _own_us(c)
    return own


def reduce_events(events) -> dict | None:
    """The capture's ``graph.*`` ranges reduced (times in us), and the
    device time of each harness span around a beam-kernel launch, in
    launch order; None without a ``graph.search`` range."""
    entries, intervals, scans = [], [], []
    phase_us = {p: 0.0 for p in PHASES}
    for e in events:
        if e.device_type == _CUDA:
            if e.name == SPAN:
                scans.append((e.time_range.start, e.time_range.end))
            elif not (e.name.startswith("bench.") or is_graph(e.name)
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
        "scan_us": [t - s for s, t in sorted(scans)],
    }


def of(run) -> dict | None:
    """:func:`reduce_events` of the run's capture, once a run; None
    without a capture, a ``graph.search`` range, or any device activity."""
    if "_graph_spans" not in run.__dict__:
        prof = getattr(run.trace, "_prof", None) if run.trace else None
        red = reduce_events(prof.events()) if prof is not None else None
        run._graph_spans = red if red and red["device"] else None
    return run._graph_spans


def per_call_ms(run, key: str, phase: str | None = None) -> float | None:
    """A reduced time per captured call, in ms: ``key`` of :func:`of`, or
    the phase's own device time with ``key="phase_us"``."""
    red = of(run)
    if red is None:
        return None
    us = red[key][phase] if phase else red[key]
    return 1e-3 * us / red["calls"]


def slots_by_kind() -> dict | None:
    """The program's candidate slots by fate, counted over the captured
    calls; None where the program has no such counter."""
    try:
        from raft_tpu_torch.obs.metrics import default_registry
    except ImportError:
        return None
    out: dict = {}
    for c in default_registry().series(SLOTS):
        kind = c.labels.get("kind")
        out[kind] = out.get(kind, 0) + c.value
    return out if sum(out.values()) else None


def beam_scan_roofline_pct(run) -> float | None:
    """The least time of the kept beam-kernel launches over the device
    time of the harness spans around those same launches (the first ones
    of the capture, in launch order), in percent."""
    red = of(run)
    kept = [k for k in (run.trace.kept.get(SPAN) or []) if k is not None] \
        if run.trace else []
    if red is None or not kept or len(red["scan_us"]) < len(kept):
        return None
    dev_s = 1e-6 * sum(red["scan_us"][:len(kept)])
    if dev_s <= 0:
        return None
    return 100.0 * sum(roofline_graph.beam_scan_least_s(*k) for k in kept) / dev_s
