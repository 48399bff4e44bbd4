"""The cold-tier row — the port of ``bench/bench_serving.py``'s
``cold_tier_row``, over the port's
:class:`~raft_tpu_torch.tier.TieredListStore` and
:class:`~raft_tpu_torch.serving.ServingExecutor`.

The row returns a dict of measured numbers and asserts nothing about
rates (timing depends on the host and the card). The program rate comes
from :func:`~raft_tpu_torch.serving.open_loop.chained_dispatch_stats`,
the executor runs from
:func:`~raft_tpu_torch.serving.open_loop._drive_open_loop`, as the
open-loop row's do.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from raft_tpu_torch.serving.open_loop import (
    _drive_open_loop,
    _sync,
    chained_dispatch_stats,
)

__all__ = ["cold_tier_row"]


def cold_tier_row(index, qall, *, k: int, n_probes: int,
                  capacity_x: float = 4.0, buckets=(128, 1024),
                  request_size: int = 16, n_templates: int = 64,
                  zipf_s: float = 1.1, n_requests: int = 256,
                  flush_age_s: float = 0.002, max_in_flight: int = 4,
                  chain=(4, 32), escalate: int = 2, seed: int = 29,
                  min_duration_s: float = 0.5,
                  max_requests: int = 20_000,
                  fracs=(0.5, 0.8, 0.95)) -> dict:
    """The popularity-tiered cold-tier row: the SAME IVF-Flat ``index``
    served two ways on one card — fully resident (``hot_qps``, through
    :func:`~raft_tpu_torch.spatial.ann.ivf_flat_search_grouped` on its
    default engine, the baseline every tier claim is priced against)
    and through a :class:`~raft_tpu_torch.tier.TieredListStore` whose
    hot budget is ``1/capacity_x`` of the cold slab's bytes
    (``tiered_qps``, the tier's pinned legacy engine), under the
    Zipf(``zipf_s``) template mix the tier exists for. Stamps:

    * ``capacity_x`` — measured cold/hot byte ratio;
    * ``program_qps`` — the resident search's closed-chain rate at the
      largest bucket, the open-loop offered-load denominator;
    * ``qps_ratio_vs_hot`` and the ``p99_ms_{50,80,95}`` sweep at
      fractions of the TIERED arm's own saturation;
    * ``tier_hit_rate`` (and per-point ``tier_hit_rate_{tag}``) — the
      hit rate against offered load, after convergence;
    * ``recall_vs_hot`` — id-overlap recall of the tiered answer against
      the full-resident search ON the template traffic (both legacy);
    * ``fetch_overlap_pct`` — fetch spans stamped compute-overlapped
      (the executor had batches in flight);
    * beside the reference's keys, ``template_lists`` — the distinct
      lists the templates probe (host replay), against ``n_slots``.

    The tiered executor stages through :meth:`TieredListStore.stage`, so
    the tier's accounting reads the host rows the executor staged and a
    tiered dispatch makes no host sync. The hot working set is converged
    ONCE (a gentle warm pass and a fetcher drain) before any measured
    arm: the row prices the steady state, not the cold start."""
    from raft_tpu_torch.resilience import AdmissionController
    from raft_tpu_torch.serving import BucketSet, ServingExecutor
    from raft_tpu_torch.spatial.ann.ivf_flat import ivf_flat_search_grouped
    from raft_tpu_torch.testing.load import poisson_arrivals
    from raft_tpu_torch.tier import (
        PromotionPolicy, SlabFetcher, TieredListStore,
    )

    dev = index.device
    bset = BucketSet.of(buckets)
    q_pool = np.asarray(qall, np.float32)
    d = int(q_pool.shape[1])
    qcaps = {b: index.warmup(b, k=k, n_probes=n_probes)
             for b in bset.sizes}

    def make_hot(b):
        def run(qq, qcap=qcaps[b]):
            return ivf_flat_search_grouped(
                index, qq, k, n_probes=n_probes, qcap=qcap,
            )
        return run

    runs = {b: make_hot(b) for b in bset.sizes}

    def hot_dispatch(batch, **_rt):
        return runs[int(batch.shape[0])](batch)

    for b in bset.sizes:
        runs[b](torch.zeros((b, d), dtype=torch.float32, device=dev))
    _sync(dev)

    # the tier under test: hot budget = cold bytes / capacity_x
    storage = index.storage
    itemsize = index.data_sorted.element_size()
    cold_bytes = int(storage.n) * d * itemsize
    store = TieredListStore(
        index, hbm_budget_bytes=max(1, int(cold_bytes // capacity_x)),
        name="cold_tier", min_recall=0.95, touch_decay=0.95,
    )
    L = int(storage.max_list)
    big = bset.largest
    row = {
        "engine": "ivf_flat", "scenario": "cold_tier", "nq": big,
        "request_size": int(request_size), "zipf_s": float(zipf_s),
        "n_templates": int(n_templates), "n_slots": store.n_slots,
        "capacity_x": round(
            cold_bytes / (store.n_slots * L * d * itemsize), 2),
    }

    qb = torch.as_tensor(q_pool[:big], device=dev)
    st = chained_dispatch_stats(
        lambda s: qb * (1.0 + 1e-6 * s), runs[big],
        n1=chain[0], n2=chain[1], escalate=escalate, device=dev,
    )
    if st is not None:
        program_qps = big / (st["ms"] / 1e3)
        row["spread"] = st["spread"]
        row["repeats"] = st["repeats"]
    else:
        # jitter-dominated host: a crude timed denominator beats
        # shipping no tier evidence at all (stamped by the missing
        # spread/repeats)
        _sync(dev)
        t0 = time.perf_counter()
        for s in range(3):
            runs[big](qb * (1.0 + 1e-6 * s))
        _sync(dev)
        program_qps = 3 * big / max(time.perf_counter() - t0, 1e-9)
    row["program_qps"] = round(program_qps, 1)

    # the fixed Zipf template pool (hot templates re-arrive bitwise
    # identical)
    rng = np.random.default_rng(seed)
    pool = np.stack([
        q_pool[rng.integers(0, q_pool.shape[0], size=request_size)]
        * (1.0 + 1e-6 * (t + 1))
        for t in range(n_templates)
    ])
    row["template_lists"] = int(np.unique(store.host_probes(
        pool.reshape(-1, d), n_probes)).size)

    ex_box = {}

    def busy() -> bool:
        ex = ex_box.get("ex")
        return bool(ex is not None and ex.stats().in_flight > 0)

    def tier_dispatch(batch, tier=None, **_rt):
        return store.search(
            batch, k, n_probes=n_probes,
            qcap=qcaps[int(batch.shape[0])], runtime=tier,
        )

    def fresh_executor(tiered: bool):
        ex = ServingExecutor(
            tier_dispatch if tiered else hot_dispatch, bset, dim=d,
            flush_age_s=flush_age_s, max_in_flight=max_in_flight,
            admission=AdmissionController(
                max_concurrent=max(1, 4 * big // request_size),
                max_queue=max(8, 4 * big // request_size),
            ),
            runtime_provider=store.runtime if tiered else None,
            stage=store.stage if tiered else None,
            device=dev,
        )
        ex_box["ex"] = ex
        return ex

    def n_for(rate_rps):
        return int(min(max_requests,
                       max(n_requests, min_duration_s * rate_rps)))

    def drive(ex, rate_rps, seed_pt):
        sched = poisson_arrivals(
            rate_rps, n_for(rate_rps), seed=seed_pt,
            sizes=request_size, zipf_s=zipf_s,
            n_templates=n_templates,
        )
        return _drive_open_loop(
            ex, sched, q_pool, seed=seed_pt,
            rows_fn=lambda i, _size, s=sched: pool[
                int(s.template_ids[i])],
        )

    policy = PromotionPolicy(demote_margin=1.25, min_touches=2.0,
                             max_moves=8)
    fetcher = SlabFetcher(store, window=4, policy=policy,
                          busy_fn=busy,
                          max_pending=4 * store.n_slots)
    try:
        # converge the hot set off the clock (misses -> async fills)
        with fresh_executor(True) as ex:
            drive(ex, max(1.0, 0.25 * program_qps / request_size),
                  seed + 3)
        fetcher.drain(60.0)
        s0 = store.stats()

        rate = 1.5 * program_qps / request_size
        with fresh_executor(False) as ex:
            hot_qps = drive(ex, rate, seed)[2]
        with fresh_executor(True) as ex:
            tiered_qps = drive(ex, rate, seed)[2]
        row["hot_qps"] = round(hot_qps, 1)
        row["tiered_qps"] = round(tiered_qps, 1)
        if hot_qps > 0:
            row["qps_ratio_vs_hot"] = round(tiered_qps / hot_qps, 3)

        # the hit-rate-vs-QPS sweep at fractions of the TIERED arm's
        # own measured saturation
        for frac in fracs:
            tag = f"{int(round(frac * 100))}"
            offered = frac * tiered_qps / request_size
            if offered <= 0:
                continue
            pre = store.stats()
            with fresh_executor(True) as ex:
                lat_ms = drive(ex, offered, seed + int(frac * 100))[0]
            post = store.stats()
            hits = post.probe_hits - pre.probe_hits
            misses = post.probe_misses - pre.probe_misses
            if hits + misses:
                row[f"tier_hit_rate_{tag}"] = round(
                    hits / (hits + misses), 3)
            if lat_ms:
                # the point's host latency list, after its run
                row[f"p99_ms_{tag}"] = round(
                    float(np.percentile(np.asarray(lat_ms), 99)), 3)  # jaxlint: disable=sync-in-hot-path

        send = store.stats()
        dh = send.probe_hits - s0.probe_hits
        dm = send.probe_misses - s0.probe_misses
        if dh + dm:
            row["tier_hit_rate"] = round(dh / (dh + dm), 3)
        row["fetch_overlap_pct"] = round(send.fetch_overlap_pct, 1)
        row["tier_fetches"] = send.fetches
    finally:
        fetcher.close()

    # measured recall of the tiered answer vs the full-resident search
    # ON the template traffic, after convergence (measure_recall also
    # feeds the tier_recall gauge)
    recalls = [
        store.measure_recall(pool[t], k, n_probes=n_probes)
        for t in range(min(8, n_templates))
    ]
    row["recall_vs_hot"] = round(float(np.mean(recalls)), 4)
    row["tier_degraded"] = bool(store.degraded)
    return row
