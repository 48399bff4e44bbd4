"""What the IVF and graph searches record about themselves: phase
ranges and counters.

The ranges go through :mod:`raft_tpu_torch.core.annotate`, the port's one
range layer: emitted while its gate is open or a ``torch.profiler``
capture runs, nothing but a flag check otherwise. The public grouped
searches (:func:`~.ivf_flat.ivf_flat_search_grouped`,
:func:`~.ivf_pq.ivf_pq_search_grouped`) hold the entry range; the one
grouped body (:func:`~.grouped.search`) holds every phase range, for
each engine (flat, SQ, PQ) in both forms (the CUDA kernel and the legacy
plain-PyTorch scan), under the same names:

* ``ivf_flat.search`` / ``ivf_pq.search`` — the public entry, the whole
  call;
* ``ivf.probe`` — the coarse probe (gram and sort), or the eager probe
  of an auto-sized ``qcap``;
* ``ivf.invert`` — :func:`~.common.invert_probe_map_ranked`;
* ``ivf.lut`` — each ADC table build (IVF-PQ: one a LUT chunk in the
  kernel form, ``ivf_pq.PQEngine.pieces``; one a list block inside
  ``ivf.scan`` in the legacy form);
* ``ivf.scan`` — the scan launches and their regroup or scatter into
  the query-major pool (IVF-PQ's kernel engine: one a LUT chunk, the
  last holding the regroup);
* ``ivf.pool`` — the top of the pool: :func:`~.common.subchunk_pool_rows`,
  or the legacy engine's top-k over the pooled partials;
* ``ivf.rerank`` — the exact f32 rescoring of the pool's rows;
* ``ivf.sync`` — each device-to-host read inside a search.

The counters live in :func:`raft_tpu_torch.obs.metrics.default_registry`,
and ``RAFT_TPU_OBS`` gates them as it gates every series:

* ``ivf_search_calls_total{engine}`` — calls of a public grouped search,
  always recorded;
* ``ivf_search_host_syncs_total{engine,site}`` — device-to-host reads
  inside a search, always recorded; each is an ``ivf.sync`` range;
* ``ivf_search_scan_form_total{engine,form,reason}`` — each grouped
  search's form as the engine rule (:func:`~.grouped.resolve_kernel`)
  picks it, always recorded: ``form="kernel"`` (``reason`` ``auto``:
  ``use_kernel=None``; ``pinned``: ``True``) or ``form="legacy"``
  (``fallback``: a CUDA index whose kernel cannot serve the search under
  ``None``, which ``grouped.ENGINE_FALLBACKS`` reads; ``pinned``:
  ``False``; ``host``: a CPU index under ``None``; ``unrefined``: an
  IVF-PQ search without the refine tail);
* ``ivf_rerank_calls_total{engine,route}`` — each exact rerank of a
  grouped search by the route :func:`~.rerank.rerank_kernel_fits` picks,
  always recorded: ``route="kernel"`` (R, one launch over the batch's
  rows in place) or ``route="gather"`` (the rows gathered in query
  blocks: the CPU, an engine without an f32 source, a shape R does not
  take);
* ``ivf_search_pairs_total{engine}`` and
  ``ivf_search_pairs_dropped_total{engine}`` — the (query, probe) pairs
  of a search and those past ``qcap`` (``slot >= qcap``), counted only
  while ranges are emitted and never for a warm-up batch
  (:func:`uncounted`). The dropped count is a device-side sum folded
  into the counter when it is read: the search adds no host sync, and
  with no range emitted no device work either.

The graph index's beam search (:func:`~.graph.graph_search`) records
itself here too, with the same range layer and registry:

* ``graph.search`` — the public entry, the whole call;
* ``graph.frontier`` — a round's frontier: its selection, the neighbour
  gather, the within-round dedup sort, the visited filter and mark;
* ``graph.scan`` — a round's scoring of its candidates: the beam kernel
  (#5), its sub-chunk selection and gathers, or the exact engine's
  :func:`~.common.score_l2_candidates`;
* ``graph.merge`` — a round's top-P of pool and candidates;
* ``graph.rerank`` — the exact tail and its top-k;
* ``graph_search_calls_total{engine}`` — calls of the public search by
  the engine that scored them, always recorded;
* ``graph_search_engine_total{engine,reason}`` — each engine choice of
  :func:`~.graph._resolve_beam_engine`, always recorded:
  ``engine="kernel"`` (``auto``: ``use_kernel=None`` on a Hopper card;
  ``pinned``: ``True``) or ``engine="exact"`` (``fallback``: a CUDA
  index the kernel cannot serve under ``None``, which
  ``graph.ENGINE_FALLBACKS`` reads; ``pinned``: ``False``; ``host``: a
  CPU index under ``None``);
* ``graph_search_slots_total{kind}`` — the candidate slots of every
  round by fate: ``new`` (scored), ``dup`` (repeated within the round),
  ``visited`` (found in the visited table), ``sentinel`` (an empty
  adjacency slot or an empty frontier entry); counted as
  ``ivf_search_pairs_total`` is, only while ranges are emitted and never
  in a warm-up, as device-side sums folded when read.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Iterator

from raft_tpu_torch.core.annotate import annotate, ranges_on
from raft_tpu_torch.obs import metrics as _metrics

__all__ = ["count_pairs", "count_slots", "counting", "entry",
           "graph_call", "graph_engine", "graph_engines", "host_sync",
           "rerank", "scan_form", "scan_forms", "uncounted"]

SCAN_FORMS = "ivf_search_scan_form_total"
GRAPH_ENGINES = "graph_search_engine_total"
GRAPH_SLOTS = "graph_search_slots_total"

# counter handles by (name, labels): made in the registry once
_handles: dict = {}
# a thread's warm-up in progress (its pairs are not counted)
_local = threading.local()


def _counter(name: str, **labels) -> _metrics.Counter:
    key = (name, tuple(sorted(labels.items())))
    c = _handles.get(key)
    if c is None:
        c = _handles[key] = _metrics.default_registry().counter(name, **labels)
    return c


def entry(engine: str) -> Callable:
    """Decorate a public grouped search of ``engine``: count each call
    and hold the ``<engine>.search`` range around it."""
    name = f"{engine}.search"

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def search(*args, **kwargs):
            _counter("ivf_search_calls_total", engine=engine).inc()
            with annotate(name):
                return fn(*args, **kwargs)
        return search
    return wrap


def host_sync(engine: str, site: str):
    """Count one device-to-host read at ``site`` and return the
    ``ivf.sync`` range to hold around it."""
    _counter("ivf_search_host_syncs_total", engine=engine, site=site).inc()
    return annotate("ivf.sync")


def scan_form(engine: str, kernel: bool, reason: str) -> None:
    """Count one grouped search of ``engine`` in its form, for
    ``reason``."""
    _counter(SCAN_FORMS, engine=engine,
             form="kernel" if kernel else "legacy", reason=reason).inc()


def rerank(engine: str, kernel: bool) -> None:
    """Count one exact rerank of ``engine`` on its route."""
    _counter("ivf_rerank_calls_total", engine=engine,
             route="kernel" if kernel else "gather").inc()


def scan_forms(engine: str, form: str, reason=None) -> int:
    """The grouped searches of ``engine`` counted in ``form`` (for
    ``reason`` alone, when given)."""
    return sum(c.value for c in _metrics.default_registry().series(SCAN_FORMS)
               if c.labels.get("engine") == engine
               and c.labels.get("form") == form
               and reason in (None, c.labels.get("reason")))


def count_pairs(engine: str, slot, qcap: int) -> None:
    """While ranges are emitted and outside a warm-up, count a search's
    (query, probe) pairs and, as a device-side sum, those whose slot
    (:func:`~.common.invert_probe_map_ranked`) is past ``qcap``."""
    if not counting():
        return
    _counter("ivf_search_pairs_total", engine=engine).inc(slot.numel())
    _counter("ivf_search_pairs_dropped_total", engine=engine).inc_deferred(
        (slot >= qcap).sum())


@contextlib.contextmanager
def uncounted() -> Iterator[None]:
    """Hold around a warm-up search on this thread: its pairs (and a
    graph search's slots) are not counted (an all-zeros batch probes the
    same lists from every query, and would read as a flood of drops)."""
    prev = getattr(_local, "warmup", False)
    _local.warmup = True
    try:
        yield
    finally:
        _local.warmup = prev


def counting() -> bool:
    """Are per-search counts taken: ranges emitted, and no warm-up on
    this thread?"""
    return ranges_on() and not getattr(_local, "warmup", False)


def graph_call(engine: str) -> None:
    """Count one graph search scored by ``engine``."""
    _counter("graph_search_calls_total", engine=engine).inc()


def graph_engine(engine: str, reason: str) -> None:
    """Count one engine choice of the graph search, for ``reason``."""
    _counter(GRAPH_ENGINES, engine=engine, reason=reason).inc()


def graph_engines(engine: str, reason=None) -> int:
    """The graph searches counted on ``engine`` (for ``reason`` alone,
    when given)."""
    return sum(c.value for c in _metrics.default_registry().series(GRAPH_ENGINES)
               if c.labels.get("engine") == engine
               and reason in (None, c.labels.get("reason")))


def count_slots(sentinel, dup, visited, total: int) -> None:
    """Add one graph search's candidate slots by fate: ``sentinel``,
    ``dup`` and ``visited`` are 0-d device counts, ``total`` every slot of
    its rounds; the rest are ``new``."""
    _counter(GRAPH_SLOTS, kind="sentinel").inc_deferred(sentinel)
    _counter(GRAPH_SLOTS, kind="dup").inc_deferred(dup)
    _counter(GRAPH_SLOTS, kind="visited").inc_deferred(visited)
    _counter(GRAPH_SLOTS, kind="new").inc_deferred(
        total - sentinel - dup - visited)
