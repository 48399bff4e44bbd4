"""Where the open-loop ServingExecutor's time goes, on one CUDA card.

    python3 -m raft_tpu_torch.tools.profile_executor [--seed N]
        [--requests N] [--switch S ...]

Builds ``chip_smoke.py``'s IVF-Flat index (1,000,000 clustered rows of
width 96, 1024 lists, n_probes 8, k 10) and warms its buckets 8 / 64 /
512 / 4096, then prints, beside the card's name and power limit:

* the result cache's own calls, with no executor running: the time of a
  ``lookup`` (a miss, then an L1 hit) and of an ``insert``, with the
  cache's VectorCache tiers on the card and on the host;
* the smoke's result-cache pass (``--requests`` requests of 1-16 rows,
  served twice through an executor with a ResultCache) for both cache
  devices: each pass's wall time, the batches, the executor's stage
  p50/p99;
* the executor at 1.5 x the program rate of the 4096 bucket (requests of
  16 rows, seeded Poisson arrivals, 0.5 s of offered load) under each
  ``sys.setswitchinterval`` of ``--switch`` (the interpreter's default
  first): achieved queries/s, sheds, batches, stage p50/p99, and the
  host time of the dispatch closure (the search's eager calls) per
  batch;
* a burst: ``--burst`` requests of 16 rows submitted in one loop with
  nothing shed, then drained: the completion rate while the submit loop
  runs and after it has ended, with the closure's host time per batch
  in each span.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from raft_tpu_torch.obs import MetricRegistry
from raft_tpu_torch.resilience import AdmissionController
from raft_tpu_torch.serving import ResultCache, ServingExecutor
from raft_tpu_torch.serving.open_loop import (
    _drive_open_loop,
    chained_dispatch_stats,
)
from raft_tpu_torch.testing.load import poisson_arrivals
from raft_tpu_torch.tools.profile_grouped import DIM, K, _clustered, card_name
from raft_tpu_torch.spatial.ann import (
    IVFFlatParams,
    ivf_flat_build,
    ivf_flat_search_grouped,
)

BUCKETS = (8, 64, 512, 4096)
REQUEST_SIZE = 16


def _p(vals, q):
    return float(np.percentile(np.asarray(vals), q))


def _stages(st):
    return ({s: round(v, 3) for s, v in st.stage_p50_ms.items()},
            {s: round(v, 3) for s, v in st.stage_p99_ms.items()})


def cache_calls(card, pool, reqs, dev):
    """ms of a lookup (miss, then hit) and of an insert, no executor."""
    cache = ResultCache(K, device=dev, registry=MetricRegistry())
    rng = np.random.default_rng(1)
    miss, ins, hit = [], [], []
    for r in reqs:
        d = np.sort(rng.random((r.shape[0], K)).astype(np.float32), 1)
        i = rng.integers(0, 10 ** 6, (r.shape[0], K)).astype(np.int32)
        t0 = time.perf_counter()
        # a frozen cache: nothing mutates it, so epoch 0 is the contract
        got = cache.lookup(r, epoch=0)  # jaxlint: disable=stale-epoch-read
        t1 = time.perf_counter()
        cache.insert(r, d, i, epoch=0)
        t2 = time.perf_counter()
        assert got is None or r.shape[0] == got[0].shape[0]
        miss.append(1e3 * (t1 - t0))
        ins.append(1e3 * (t2 - t1))
    for r in reqs:
        t0 = time.perf_counter()
        cache.lookup(r, epoch=0)  # jaxlint: disable=stale-epoch-read
        hit.append(1e3 * (time.perf_counter() - t0))
    print(f"[{card}] result cache on {dev.type}, no executor: lookup "
          f"(miss) p50 {_p(miss, 50):.3f} / p99 {_p(miss, 99):.3f} ms, "
          f"insert p50 {_p(ins, 50):.3f} / p99 {_p(ins, 99):.3f} ms, "
          f"lookup (L1 hit) p50 {_p(hit, 50):.4f} ms", flush=True)


def cache_pass(card, search, reqs, dev, edev):
    """The smoke's result-cache pass (the executor on ``edev``) with the
    cache on ``dev``."""
    cache = ResultCache(K, device=dev, registry=MetricRegistry())

    def serve():
        # closing the executor joins its drain thread: every cache fill
        # of the pass has landed when it returns
        with ServingExecutor(lambda b, **_: search(b), BUCKETS, dim=DIM,
                             device=edev, result_cache=cache,
                             registry=MetricRegistry()) as ex:
            out = [f.result(timeout=600) for f in
                   [ex.submit(r) for r in reqs]]
        return out, ex.stats()

    t0 = time.perf_counter()
    first, st1 = serve()
    t1 = time.perf_counter()
    second, st = serve()
    t2 = time.perf_counter()
    same = all(a[0].tobytes() == b[0].tobytes() for a, b in
               zip(first, second))
    p50, p99 = _stages(st1)
    print(f"[{card}] result-cache pass, cache on {dev.type}: first pass "
          f"{1e3 * (t1 - t0):.1f} ms ({st1.batches} batches, "
          f"{st1.cache_hits} cache hits, {st1.coalesced_requests} "
          f"coalesced), second {1e3 * (t2 - t1):.1f} ms ({st.batches} "
          f"batches, {st.cache_hits} cache hits), equal {same}; first "
          f"pass stage p50 ms {p50}; stage p99 ms {p99}", flush=True)


class TimedSearch:
    """``search`` with the host time of each call recorded, stamped with
    its end on the host clock."""

    def __init__(self, search):
        self.search = search
        self.calls = []

    def __call__(self, batch, **_rt):
        t0 = time.perf_counter()
        out = self.search(batch)
        t1 = time.perf_counter()
        self.calls.append((t1, 1e3 * (t1 - t0), batch.shape[0]))
        return out


def burst(card, search, pool, n_requests, seed, edev):
    """Submit ``n_requests`` as fast as one loop can, then drain."""
    timed = TimedSearch(search)
    done = []
    rng = np.random.default_rng(seed)
    with ServingExecutor(timed, BUCKETS, dim=DIM, device=edev,
                         registry=MetricRegistry()) as ex:
        t0 = time.perf_counter()
        futs = []
        for _ in range(n_requests):
            f = ex.submit(pool[rng.integers(0, pool.shape[0],
                                            REQUEST_SIZE)])
            f.add_done_callback(
                lambda _f: done.append(time.perf_counter()))
            futs.append(f)
        t_sub = time.perf_counter()
        for f in futs:
            f.result(timeout=600)
        while len(done) < n_requests:
            time.sleep(0.001)
    t_end = max(done)
    during = sum(1 for t in done if t <= t_sub)
    for span, lo, hi, n in (("while submitting", t0, t_sub, during),
                            ("after", t_sub, t_end, n_requests - during)):
        ms = [c[1] for c in timed.calls if lo < c[0] <= hi]
        rate = n * REQUEST_SIZE / max(hi - lo, 1e-9)
        print(f"[{card}] burst of {n_requests} requests, {span} "
              f"({1e3 * (hi - lo):.1f} ms): {rate:.0f} queries/s "
              f"completed, {len(ms)} batches, closure host ms p50 "
              f"{_p(ms, 50) if ms else 0:.3f} / p99 "
              f"{_p(ms, 99) if ms else 0:.3f}", flush=True)


def saturation(card, search, pool, rate_rps, n_requests, switch, seed,
               edev):
    """One executor on ``edev`` at ``rate_rps`` requests/s under a switch
    interval."""
    prev = sys.getswitchinterval()
    sys.setswitchinterval(switch)
    try:
        big = max(BUCKETS)
        timed = TimedSearch(search)
        with ServingExecutor(
                timed, BUCKETS, dim=DIM,
                device=edev, registry=MetricRegistry(),
                admission=AdmissionController(
                    max_concurrent=4 * big // REQUEST_SIZE,
                    max_queue=4 * big // REQUEST_SIZE,
                    registry=MetricRegistry())) as ex:
            lat, shed, qps, lag, _ = _drive_open_loop(
                ex, poisson_arrivals(rate_rps, n_requests, seed=seed,
                                     sizes=REQUEST_SIZE),
                pool, seed=seed)
        st = ex.stats()
    finally:
        sys.setswitchinterval(prev)
    p50, p99 = _stages(st)
    print(f"[{card}] executor at {rate_rps * REQUEST_SIZE:.0f} offered "
          f"queries/s, switch interval {switch * 1e3:g} ms: achieved "
          f"{qps:.0f} queries/s, shed {shed}, batches {st.batches} "
          f"(pad_fraction {st.pad_fraction:.3f}), latency p50 "
          f"{_p(lat, 50):.2f} / p99 {_p(lat, 99):.2f} ms, generator lag "
          f"{1e3 * lag:.1f} ms; closure host ms p50 "
          f"{_p([c[1] for c in timed.calls], 50):.3f} / p99 "
          f"{_p([c[1] for c in timed.calls], 99):.3f}; stage p50 ms {p50}; "
          f"stage p99 ms {p99}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--switch", type=float, nargs="*", default=[0.0005])
    ap.add_argument("--burst", type=int, default=4000)
    ap.add_argument("--skip-cache", action="store_true")
    args = ap.parse_args(argv)
    card = card_name("profile_executor")
    dev = torch.device("cuda")

    rng = np.random.default_rng(args.seed)
    x = _clustered(rng, 1_000_000, 2000, None)
    index = ivf_flat_build(x, IVFFlatParams(
        n_lists=1024, kmeans_n_iters=10, kmeans_init="random"), device=dev)
    qcaps = {b: index.warmup(b, k=K, n_probes=8) for b in BUCKETS}

    def search(q):
        return ivf_flat_search_grouped(index, q, K, n_probes=8,
                                       qcap=qcaps[q.shape[0]])

    pool = (x[rng.integers(0, x.shape[0], 8192)]
            + 0.3 * rng.standard_normal((8192, DIM), dtype=np.float32))
    reqs = [pool[s:s + int(m)] for s, m in zip(
        rng.integers(0, pool.shape[0] - 16, args.requests),
        rng.integers(1, 17, args.requests))]

    if not args.skip_cache:
        for cdev in (dev, torch.device("cpu")):
            cache_calls(card, pool, reqs, cdev)
        for cdev in (dev, torch.device("cpu")):
            cache_pass(card, search, reqs, cdev, dev)

    qb = torch.as_tensor(pool[:max(BUCKETS)], device=dev)
    st = chained_dispatch_stats(lambda s: qb * (1.0 + 1e-6 * s), search,
                                n1=4, n2=32, device=dev)
    program = max(BUCKETS) / (st["ms"] / 1e3)
    print(f"[{card}] program rate at bucket {max(BUCKETS)}: {program:.0f} "
          f"queries/s ({st['ms']:.3f} ms a batch, spread {st['spread']})",
          flush=True)
    rate = 1.5 * program / REQUEST_SIZE
    for switch in [sys.getswitchinterval()] + list(args.switch):
        saturation(card, search, pool, rate, int(min(20_000, 0.5 * rate)),
                   switch, args.seed + 1, dev)
    burst(card, search, pool, args.burst, args.seed + 2, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
