"""What the brute-force kNN records about itself: phase ranges and
counters.

The ranges go through :mod:`raft_tpu_torch.core.annotate`, the port's
one range layer (:func:`entry`, and ``annotate`` calls in ``knn.py`` and
``fused_knn.py``): emitted
while its gate is open or a ``torch.profiler`` capture runs, nothing but
a flag check otherwise. Both routes of
:func:`~raft_tpu_torch.spatial.knn.brute_force_knn` use them:

* ``knn.search`` — the public entry, the whole call;
* ``knn.chunk_mins`` — the fused route's phase 1 (#6), with the index's
  row norms when the call computes them;
* ``knn.select`` — each ``top_k_smallest`` of the fused route, over the
  chunk minima and over the rescored candidates, with its index
  arithmetic;
* ``knn.rescore`` — the #7 launches and their concatenation, or the
  gather route's torch gather and ``bmm``;
* ``knn.scan`` — the scan route's blocked search of one partition.

The counters live in :func:`raft_tpu_torch.obs.metrics.default_registry`,
and ``RAFT_TPU_OBS`` gates them as it gates every series:

* ``knn_search_calls_total{route="fused"|"scan"}`` — one a partition
  searched;
* ``knn_rescore_calls_total{route="kernel"|"gather"}`` — one a fused
  search, by the route of its exact rescore;
* ``knn_chunk_mins_calls_total{route="wgmma"|"mma"|"f32"|"plain"}`` —
  one a phase-1 call (``fused_knn.chunk_mins``), by the kernel it
  launched (``fused_knn.chunk_mins_route``), or ``plain`` for the plain
  version on CPU tensors.
"""

from __future__ import annotations

import functools
from typing import Callable

from raft_tpu_torch.core.annotate import annotate
from raft_tpu_torch.obs import metrics as _metrics

__all__ = ["count", "entry"]


def count(name: str, route: str) -> None:
    """One more of the counter ``name`` on ``route``. Called a few times
    a search, so the registry's lookup costs nothing against it."""
    _metrics.default_registry().counter(name, route=route).inc()


def entry(fn: Callable) -> Callable:
    """Decorate the public brute-force search: hold the ``knn.search``
    range around each call."""
    @functools.wraps(fn)
    def search(*args, **kwargs):
        with annotate("knn.search"):
            return fn(*args, **kwargs)
    return search
