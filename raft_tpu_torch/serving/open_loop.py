"""The open-loop serving row — the port of ``open_loop_row`` and
``_drive_open_loop`` (``bench/bench_serving.py:470-668``) and of
``chained_dispatch_stats`` (``bench/common.py:96``), on the port's
:class:`~raft_tpu_torch.serving.ServingExecutor`.

The row measures what the executor delivers against what the raw search
can do: the program rate of the largest bucket's search in a closed
chain (no executor in the path), the executor's saturation rate under a
seeded Poisson load at 1.5x that rate, then p50/p99 latency at fractions
of the measured saturation. Every time is a host clock reading around
work that ends in a synchronize, or a future's resolution; on a CUDA
device a timing is only as good as the card it ran on, so callers print
the card beside the row.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from raft_tpu_torch import errors
from raft_tpu_torch.core.device import resolve_device
from raft_tpu_torch.obs import metrics as obsm
from raft_tpu_torch.resilience import AdmissionController
from raft_tpu_torch.serving.batching import BucketSet
from raft_tpu_torch.serving.executor import STAGES, ServingExecutor
from raft_tpu_torch.testing import load

__all__ = ["chained_dispatch_stats", "open_loop_row"]

# ExecutorStats counters the row sums over every executor it runs
_TOTALS = ("submitted", "completed", "failed", "batches", "valid_rows",
           "padded_rows", "flushes_full", "flushes_deadline")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def chained_dispatch_stats(make_input, run, n1: int = 2, n2: int = 8,
                           reps: int = 3, escalate: int = 0, *,
                           device=None, _salt0: int = 1,
                           _escalations: int = 0):
    """Two-point timing of ``run``: a chain of ``n`` calls
    ``run(make_input(salt))`` between two synchronizes of ``device``
    (the JAX version forces a reduction of each result; on one CUDA
    stream the calls already run in order, so one synchronize at each
    end of the chain bounds it), and the median of ``reps`` difference
    quotients (T(n2) - T(n1)) / (n2 - n1) in ms — the launch and sync
    costs at the chain's ends cancel.

    ``make_input(salt)`` returns a fresh input per salt; inputs are made
    before the clock starts, and salts increase strictly across every
    chain, repeat and escalation. Returns ``{"ms", "ms_min", "spread",
    "repeats", "escalations"}``, or None when every quotient is
    non-positive (too fast to resolve this way). Noisy rows earn more
    repeats (3 -> 5 -> 7 while the spread exceeds 0.1), and
    ``escalate`` retries with 4x-longer chains while the result is
    jitter-dominated or still noisy."""
    dev = resolve_device(device)

    def timed(n, salt0):
        xs = [make_input(salt0 + i) for i in range(n)]
        _sync(dev)
        t0 = time.perf_counter()
        for x in xs:
            run(x)
        _sync(dev)
        return time.perf_counter() - t0

    off = _salt0
    quotients: List[float] = []

    def add_quotient():
        nonlocal off
        t1 = timed(n1, off)
        off += n1
        t2 = timed(n2, off)
        off += n2
        quotients.append((t2 - t1) / (n2 - n1) * 1e3)

    def summarize():
        # the median over ALL quotients (negative ones included): one
        # positive outlier must not pass for a measurement
        ms = sorted(quotients)[len(quotients) // 2]
        pos = sorted(q for q in quotients if q > 0)
        spread = (pos[-1] - pos[0]) / ms if (pos and ms > 0) else 0.0
        return ms, pos, spread

    def longer():
        return chained_dispatch_stats(
            make_input, run, n1=4 * n1, n2=4 * n2, reps=reps,
            escalate=escalate - 1, device=dev, _salt0=off,
            _escalations=_escalations + 1,
        )

    for _ in range(reps):
        add_quotient()
    ms, pos, spread = summarize()
    if ms <= 0:
        return longer() if escalate > 0 else None
    max_reps, spread_target = 7, 0.1
    best = (ms, pos, spread, len(quotients))
    while spread > spread_target and len(quotients) + 2 <= max_reps:
        add_quotient()
        add_quotient()
        ms, pos, spread = summarize()
        if ms > 0 and spread < best[2]:
            best = (ms, pos, spread, len(quotients))
    n_used = len(quotients)
    if ms <= 0:
        ms, pos, spread, n_used = best
    if spread > spread_target and escalate > 0:
        grown = longer()
        if grown is not None and grown["spread"] < spread:
            return grown
    return {"ms": ms, "ms_min": pos[0], "spread": round(spread, 3),
            "repeats": n_used, "escalations": _escalations}


def _drive_open_loop(executor, schedule, qall, *, seed: int = 0,
                     rows_fn=None, on_submit=None):
    """Replay one open-loop schedule through the executor; returns
    ``(latencies_ms, n_shed, achieved_qps, max_lag_s, rows_accepted)``.
    Latency is submit→future-resolution wall time per COMPLETED request;
    achieved QPS counts completed query rows over the span from first
    submit to last completion (sheds excluded).

    ``rows_fn(i, size)`` overrides the default random-unique row draw
    with the request's EXACT rows; ``on_submit(rows, future)`` sees
    every accepted request."""
    done: Dict[int, float] = {}
    lock = threading.Lock()
    rng = np.random.default_rng(seed)
    q_pool = np.asarray(qall, np.float32)

    def submit(i, size):
        if rows_fn is not None:
            rows = rows_fn(i, size)
        else:
            rows = q_pool[rng.integers(0, q_pool.shape[0], size=size)]
            rows = rows * np.float32(1.0 + 1e-6 * (i + 1))
        fut = executor.submit(rows)
        if on_submit is not None:
            on_submit(rows, fut)

        def _stamp(_f, i=i):
            with lock:
                done[i] = time.perf_counter()

        fut.add_done_callback(_stamp)
        return fut

    results, stamps, max_lag = load.replay(
        schedule, submit, clock=time.perf_counter
    )
    lat_ms, n_shed, rows_done, rows_accepted = [], 0, 0, 0
    t_last = 0.0
    for i, r in enumerate(results):
        if isinstance(r, errors.RaftOverloadError):
            n_shed += 1
            continue
        if isinstance(r, BaseException):
            raise r
        rows_accepted += int(schedule.sizes[i])
        r.result(timeout=120)            # surface dispatch failures
        # result() can return before add_done_callback has stamped
        # (set_result wakes waiters first, runs callbacks after)
        while True:
            with lock:
                t_done = done.get(i)
            if t_done is not None:
                break
            time.sleep(0.0002)
        lat_ms.append((t_done - stamps[i]) * 1e3)
        rows_done += int(schedule.sizes[i])
        t_last = max(t_last, t_done)
    span = max(t_last - float(stamps[0]), 1e-9) if lat_ms else None
    qps = rows_done / span if span else 0.0
    return lat_ms, n_shed, qps, max_lag, rows_accepted


def open_loop_row(make_run: Callable, qall, *, buckets=(128, 1024),
                  request_size: int = 16, n_requests: int = 256,
                  fracs=(0.5, 0.8, 0.95), flush_age_s: float = 0.002,
                  max_in_flight: int = 4, chain=(4, 32),
                  escalate: int = 2, seed: int = 11,
                  min_duration_s: float = 0.5,
                  max_requests: int = 20_000, device=None,
                  on_submit: Optional[Callable] = None) -> dict:
    """The open-loop executor row: saturation vs the raw search, then
    the offered-load sweep at ``fracs`` of measured saturation with
    p50/p99 per point.

    ``make_run(bucket)`` returns the WARMED serving closure for one
    bucket size; the executor routes each micro-batch to its bucket's
    closure. ``device`` is the executors' device (``None``: the CUDA
    card). ``n_requests`` is a FLOOR: each measured point is stretched
    to at least ``min_duration_s`` of offered traffic at its own rate
    (capped at ``max_requests``). ``on_submit(point, rows, future)``
    sees every accepted request, ``point`` naming the executor's run:
    ``"sat"``, ``"sat_off"`` (the saturation rerun with the registry
    off) or a fraction's percent tag.

    Beside the JAX row's keys, the row carries, per point (``sat`` and
    each fraction's percent tag), the shed count ``n_shed_<tag>``, the
    executor's ``pad_fraction_<tag>`` and its stage quantiles
    ``stage_p50_ms_<tag>`` / ``stage_p99_ms_<tag>`` (:data:`STAGES`), and
    ``totals``: its executors' summed :class:`ExecutorStats` counters
    with ``rows_accepted``, the rows of the requests they accepted."""
    dev = resolve_device(device)
    bset = BucketSet.of(buckets)
    runs = {b: make_run(b) for b in bset.sizes}
    d = int(np.asarray(qall).shape[1])

    def dispatch(batch, **_rt):
        return runs[int(batch.shape[0])](batch)

    # warm every bucket's closure before the clock starts
    for b in bset.sizes:
        runs[b](torch.zeros((b, d), dtype=torch.float32, device=dev))
    _sync(dev)

    # the denominator: raw search QPS at the largest bucket, closed-loop
    # chained quotient (no executor in the path)
    big = bset.largest
    qb = torch.as_tensor(np.asarray(qall, np.float32)[:big], device=dev)
    st = chained_dispatch_stats(
        lambda s: qb * (1.0 + 1e-6 * s), runs[big],
        n1=chain[0], n2=chain[1], escalate=escalate, device=dev,
    )
    row = {
        "engine": "ivf_flat", "scenario": "open_loop",
        "nq": big, "buckets": list(bset.sizes),
        "request_size": int(request_size),
        "n_requests": int(n_requests),
        "max_in_flight": int(max_in_flight),
    }
    if st is None:
        row["error"] = "jitter-dominated"
        return row
    program_qps = big / (st["ms"] / 1e3)
    row["program_qps"] = round(program_qps, 1)
    row["spread"] = st["spread"]
    row["repeats"] = st["repeats"]
    totals = dict.fromkeys(_TOTALS + ("rows_accepted",), 0)
    row["totals"] = totals

    def fresh_executor():
        return ServingExecutor(
            dispatch, bset, dim=d, flush_age_s=flush_age_s,
            max_in_flight=max_in_flight,
            admission=AdmissionController(
                max_concurrent=max(1, 4 * big // request_size),
                max_queue=max(8, 4 * big // request_size),
            ),
            device=dev,
            # a registry of its own: each point's stage quantiles are
            # that executor's alone
            registry=obsm.MetricRegistry(),
        )

    def n_for(rate_rps):
        return int(min(max_requests,
                       max(n_requests, min_duration_s * rate_rps)))

    def run_point(tag, schedule, drive_seed):
        """One executor over one schedule; records its stats under
        ``tag`` and returns the drive's result."""
        seen = (None if on_submit is None
                else lambda rows, fut: on_submit(tag, rows, fut))
        with fresh_executor() as ex:
            out = _drive_open_loop(ex, schedule, qall, seed=drive_seed,
                                   on_submit=seen)
        stats = ex.stats()
        for key in _TOTALS:
            totals[key] += getattr(stats, key)
        totals["rows_accepted"] += out[4]
        if tag != "sat_off":
            row[f"n_shed_{tag}"] = out[1]
            row[f"pad_fraction_{tag}"] = round(stats.pad_fraction, 4)
            row[f"stage_p50_ms_{tag}"] = {
                s: round(stats.stage_p50_ms[s], 4)
                for s in STAGES if s in stats.stage_p50_ms}
            row[f"stage_p99_ms_{tag}"] = {
                s: round(stats.stage_p99_ms[s], 4)
                for s in STAGES if s in stats.stage_p99_ms}
        return out

    # saturation: offer ~1.5x the program rate; the completion rate IS
    # the executor's deliverable throughput (sheds excluded). Measured
    # TWICE — registry enabled (the reported saturation_qps) and
    # disabled — so the row stamps the telemetry tax
    # (`obs_overhead_pct`)
    rate_rps = 1.5 * program_qps / request_size

    def sat_schedule():
        return load.poisson_arrivals(rate_rps, n_for(rate_rps), seed=seed,
                                     sizes=request_size)

    prev_obs = obsm.set_enabled(True)
    try:
        _, _, sat_qps, sat_lag, _ = run_point("sat", sat_schedule(), seed)
        obsm.set_enabled(False)
        _, _, sat_qps_off, _, _ = run_point("sat_off", sat_schedule(),
                                            seed)
    finally:
        obsm.set_enabled(prev_obs)
    row["saturation_qps"] = round(sat_qps, 1)
    row["qps_ratio_vs_program"] = round(sat_qps / program_qps, 3)
    if sat_qps_off > 0:
        row["obs_overhead_pct"] = round(
            100.0 * (1.0 - sat_qps / sat_qps_off), 2)
    # a lag comparable to the mean inter-arrival gap means the measured
    # rate was submit-bound
    row["gen_lag_ms_sat"] = round(sat_lag * 1e3, 3)

    # the offered-load sweep: p50/p99 at each fraction of saturation
    for frac in fracs:
        tag = f"{int(round(frac * 100))}"
        offered = frac * sat_qps / request_size
        if offered <= 0:
            continue
        n_point = n_for(offered)
        lat_ms, n_shed, qps, lag, _ = run_point(
            tag, load.poisson_arrivals(offered, n_point,
                                       seed=seed + int(frac * 100),
                                       sizes=request_size),
            seed + 1)
        row[f"gen_lag_ms_{tag}"] = round(lag * 1e3, 3)
        if lat_ms:
            # the point's host latency list, after its run — no device
            lat = np.asarray(lat_ms)  # jaxlint: disable=sync-in-hot-path
            row[f"p50_ms_{tag}"] = round(float(np.percentile(lat, 50)), 3)
            row[f"p99_ms_{tag}"] = round(float(np.percentile(lat, 99)), 3)
            row[f"achieved_qps_{tag}"] = round(qps, 1)
        if n_shed:
            row[f"shed_rate_{tag}"] = round(n_shed / n_point, 3)
    return row
