"""The program's own ranges and counters in a traced run, for the
``search.*`` readers.

The port holds CPU-scope ranges around its IVF searches (one entry range
a call, ``ivf_flat.search`` / ``ivf_pq.search``, and the phases inside
it: ``ivf.probe``, ``ivf.invert``, ``ivf.lut``, ``ivf.scan``,
``ivf.pool``, ``ivf.rerank``, ``ivf.sync``) and counts calls, host syncs
and (query, probe) pairs in its metric registry. The ranges are no user
annotations: they put nothing on the device timeline, so the harness's
own readings (``tracing.Trace.summary``) stay as they were. Each range's
kernels are those launched inside it, as the profiler correlates them.

:func:`of` reduces a run's capture once: per phase the device time of the
kernels launched inside its ranges less that of the program ranges nested
in them, the device idle in gaps whose midpoint lies inside an entry
range, and the idle in gaps an ``ivf.sync`` range overlaps. A program
without these ranges or counters (an older port) gives None here, and
every reader then reports nothing.
"""

from __future__ import annotations

import torch

from benchmark.tracing import gaps_by_span, merged

ENTRIES = ("ivf_flat.search", "ivf_pq.search")
PHASES = ("ivf.probe", "ivf.invert", "ivf.lut", "ivf.scan", "ivf.pool",
          "ivf.rerank")
SYNC = "ivf.sync"
_CUDA = torch.autograd.DeviceType.CUDA


def is_program(name: str) -> bool:
    return name in ENTRIES or name.startswith(("ivf.", "serve."))


def _own_us(e, stop_at_program: bool) -> float:
    """Device time (us) of the kernels launched inside ``e`` and its
    descendants; with ``stop_at_program``, not inside a program range
    nested in it."""
    own = sum(k.duration for k in e.kernels)
    for c in e.cpu_children:
        if not (stop_at_program and is_program(c.name)):
            own += _own_us(c, stop_at_program)
    return own


def reduce_events(events) -> dict | None:
    """The capture's program ranges reduced (times in us); None without
    an entry range."""
    entries, syncs, intervals = [], [], []
    phase_us = {p: 0.0 for p in PHASES}
    entry_us = 0.0
    for e in events:
        if e.device_type == _CUDA:
            if not e.name.startswith("bench.") and not is_program(e.name):
                intervals.append((e.time_range.start, e.time_range.end))
        elif e.name in ENTRIES:
            entries.append((e.time_range.start, e.time_range.end, "entry"))
            entry_us += _own_us(e, stop_at_program=False)
        elif e.name in phase_us:
            phase_us[e.name] += _own_us(e, stop_at_program=True)
        elif e.name == SYNC:
            syncs.append((e.time_range.start, e.time_range.end))
    if not entries:
        return None
    busy = merged(intervals)
    sync_idle = 0.0
    for (_, a), (b, _) in zip(busy, busy[1:]):
        if any(s < b and t > a for s, t in syncs):
            sync_idle += b - a
    return {
        "calls": len(entries),
        "device": bool(intervals),
        "phase_us": phase_us,
        "entry_us": entry_us,
        "idle_us": 1e6 * gaps_by_span(busy, entries).get("entry", 0.0),
        "sync_idle_us": sync_idle,
    }


def of(run) -> dict | None:
    """:func:`reduce_events` of the run's capture, once a run; None
    without a capture, an entry range, or any device activity."""
    if "_program_spans" not in run.__dict__:
        prof = getattr(run.trace, "_prof", None) if run.trace else None
        red = reduce_events(prof.events()) if prof is not None else None
        run._program_spans = red if red and red["device"] else None
    return run._program_spans


def per_call_ms(run, key: str, phase: str | None = None) -> float | None:
    """A reduced time per captured call, in ms: ``key`` of :func:`of`, or
    the phase's own device time with ``key="phase_us"``."""
    red = of(run)
    if red is None:
        return None
    us = red[key][phase] if phase else red[key]
    return 1e-3 * us / red["calls"]


def counter_total(name: str, engine: str) -> int | None:
    """The sum of the program's counter ``name`` over the cell engine's
    series; None where the program has no such series."""
    try:
        from raft_tpu_torch.obs.metrics import default_registry
    except ImportError:
        return None
    found = [c.value for c in default_registry().series(name)
             if c.labels.get("engine") == engine]
    return sum(found) if found else None


def host_syncs_per_call(run) -> float | None:
    """The program's device-to-host reads per search call, over every
    call of the run (warm-up and window included: each call of a batch
    size makes the same reads)."""
    engine = run.cfg["engine"]
    calls = counter_total("ivf_search_calls_total", engine)
    if not calls:
        return None
    return (counter_total("ivf_search_host_syncs_total", engine) or 0) / calls


def dropped_pairs_pct(run) -> float | None:
    """The share of (query, probe) pairs past ``qcap`` over the calls the
    program counted pairs in: those made while ranges were emitted, the
    capture's calls."""
    engine = run.cfg["engine"]
    pairs = counter_total("ivf_search_pairs_total", engine)
    if not pairs:
        return None
    return 100.0 * (counter_total("ivf_search_pairs_dropped_total",
                                  engine) or 0) / pairs
