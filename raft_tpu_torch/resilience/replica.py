"""The per-shard and per-list load feed — the part of
``raft_tpu/resilience/replica.py`` (:238-350) that the cold tier needs:
:func:`record_shard_load`, :func:`measured_shard_load`,
:func:`record_list_load` and :func:`measured_list_load`, host numpy over
the port's :mod:`~raft_tpu_torch.obs.metrics` registry.

A tiered search records its probe histogram into the
``serving_list_rows_total{shard,list}`` counters; the promotion policy
ranks lists by the same counts (the store keeps a decayed copy of its
own). An index has thousands of lists and a counter per list would be a
cardinality bomb, so a shard mints at most 64 per-list series
(first-come, which under Zipf traffic is about the head, the set the
tier can act on) and folds the rest into ``list="other"``: total
traffic is conserved and the catalog stays bounded.

Not ported yet, with the shard health and degraded-result modules they
stand on: ``ReplicaPlacement``, ``popularity_replication``,
``FailoverPlan``, ``resolve_route`` and ``_alive_mask``.
"""

from __future__ import annotations

import numpy as np

from raft_tpu_torch import errors
from raft_tpu_torch.obs import metrics as obs_metrics

__all__ = [
    "measured_list_load",
    "measured_shard_load",
    "record_list_load",
    "record_shard_load",
]

_SHARD_LOAD_METRIC = "serving_shard_rows_total"
_LIST_LOAD_METRIC = "serving_list_rows_total"
_LIST_SERIES_CAP = 64


def record_shard_load(shard_rows, *, registry=None,
                      name: str = _SHARD_LOAD_METRIC) -> None:
    """Accumulate a per-shard dispatched-row count vector into the
    ``{name}{shard=s}`` counters. Callers hand in whatever granularity
    they have (per-batch probe-to-owner histograms, a bench's offered
    template mix); the counters sum it process-wide.
    ``RAFT_TPU_OBS=off`` no-ops it like every recorder."""
    rows = np.asarray(shard_rows)
    errors.expects(rows.ndim == 1,
                   "record_shard_load: expected a (P,) vector, got %s",
                   tuple(rows.shape))
    reg = obs_metrics.default_registry() if registry is None else registry
    for s in range(rows.shape[0]):
        n = int(rows[s])
        if n:
            reg.counter(name, shard=s).inc(n)


def measured_shard_load(n_shards: int, *, registry=None,
                        name: str = _SHARD_LOAD_METRIC) -> np.ndarray:
    """The accumulated per-shard load, ``(P,)`` float64 (zeros where no
    traffic was recorded)."""
    errors.expects(n_shards >= 1,
                   "measured_shard_load: n_shards=%d < 1", n_shards)
    reg = obs_metrics.default_registry() if registry is None else registry
    load = np.zeros(n_shards, np.float64)
    for inst in reg.series(name):
        s = inst.labels.get("shard")
        if s is None:
            continue
        s = int(s)
        if 0 <= s < n_shards:
            load[s] += float(inst.value)
    return load


def record_list_load(list_rows, *, shard: int = 0, registry=None,
                     name: str = _LIST_LOAD_METRIC,
                     max_series: int = _LIST_SERIES_CAP) -> None:
    """Accumulate a ``(n_lists,)`` per-list dispatched-row vector (a
    probe histogram, a touch snapshot) into the bounded-cardinality
    ``{name}{shard=s,list=l}`` counters. Lists that already own a series
    always record to it; new series are minted only while the shard
    holds fewer than ``max_series``, after which the remainder lands in
    ``list="other"``. ``RAFT_TPU_OBS=off`` no-ops it like every
    recorder."""
    rows = np.asarray(list_rows)
    errors.expects(rows.ndim == 1,
                   "record_list_load: expected a (n_lists,) vector, "
                   "got %s", tuple(rows.shape))
    reg = obs_metrics.default_registry() if registry is None else registry
    shard_l = str(int(shard))
    minted = set()
    for inst in reg.series(name):
        if (inst.labels.get("shard") == shard_l
                and inst.labels.get("list") not in (None, "other")):
            minted.add(inst.labels["list"])
    other = 0
    for lid in np.nonzero(rows)[0]:
        n = int(rows[lid])
        key = str(int(lid))
        if key in minted or len(minted) < max_series:
            minted.add(key)
            reg.counter(name, shard=shard_l, list=key).inc(n)
        else:
            other += n
    if other:
        reg.counter(name, shard=shard_l, list="other").inc(other)


def measured_list_load(n_lists: int, *, shard: "int | None" = None,
                       registry=None,
                       name: str = _LIST_LOAD_METRIC) -> np.ndarray:
    """The accumulated per-list load, ``(n_lists,)`` float64.
    ``shard=None`` sums every shard's series; the ``list="other"``
    bucket is left out (it names no list)."""
    errors.expects(n_lists >= 1,
                   "measured_list_load: n_lists=%d < 1", n_lists)
    reg = obs_metrics.default_registry() if registry is None else registry
    load = np.zeros(n_lists, np.float64)
    want = None if shard is None else str(int(shard))
    for inst in reg.series(name):
        lid = inst.labels.get("list")
        if lid in (None, "other"):
            continue
        if want is not None and inst.labels.get("shard") != want:
            continue
        lid = int(lid)
        if 0 <= lid < n_lists:
            load[lid] += float(inst.value)
    return load
