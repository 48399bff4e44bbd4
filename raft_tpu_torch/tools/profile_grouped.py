"""Where the time of one IVF or graph search batch goes, on one CUDA card.

    python3 -m raft_tpu_torch.tools.profile_grouped
        [--kind flat|sq|pq|graph|coarse|mutable|sharded] [--beam B]
        [--engine flat|pq] [--ranks P] [--rendezvous-pairs N] [--seed N]
        [--out DIR]

Builds the index of ``chip_smoke.py``'s path of that kind:

* ``flat``: 1,000,000 clustered rows of width 96, 1024 lists; buckets 8
  and 4096 at their warmed qcap;
* ``mutable``: the ``flat`` index wrapped for mutation as
  ``chip_smoke.py``'s mutation phase wraps it (delta capacity 64, 256
  upserted rows, 10% of the rows deleted), searched through
  ``mutable_search`` at the same buckets;
* ``sq`` / ``pq``: 500,000 rows of width 96 around 1,000 centres
  (bench.py's ``ann_bench_dataset`` geometry), 2048 lists capped at 512
  rows, n_probes=16 (PQ: pq_dim=24, 8 bits, refine_ratio=4); bucket 8 at
  its warmed qcap and the 4,096-query batch at ``qcap="throughput"``;
* ``graph``: the same 500,000 rows, a degree-16 graph (intermediate 32,
  4 entries); the beam search at ``--beam`` (default 32) at nq 1 and
  4,096 with its warmed iteration count;
* ``coarse``: the ``flat`` index's 1,024 centroids and 64,768 draws of
  them with 0.5-std jitter (65,792 in all), the two-level coarse index
  of ``chip_smoke.py``'s coarse phase (4,096 supers asked, 26 members at
  most), 16 probes at overprobe 2; a 16,384-query batch through the flat
  ``coarse_probe`` and both engines of ``two_level_probe``;
* ``sharded``: the ``flat`` rows in a sharded IVF-Flat index
  (``raft_tpu_torch.comms``) over ``--ranks`` in-process ranks on the
  one card (default 8, ``chip_smoke.py``'s sharded phase), 1024 lists,
  8 probes; buckets 8 and 4096 at their warmed qcap. With ``--engine
  pq`` the sharded IVF-PQ index of ``chip_smoke.py``'s sharded PQ step
  instead: the ``pq`` rows and configuration over the ranks, bucket 8 at
  its warmed qcap and the 4,096-query batch at ``qcap="throughput"``
  (each rank launches the ADC kernel on its shard). With
  ``--rendezvous-pairs N`` it also times, per bucket, N pairs of 5
  searches alternating the in-process ranks' two rendezvous: taking
  turns (``Comms.run``'s) and all at once (every rank thread runs, a
  rank at a collective sleeps until its peers have posted).

For each bucket it times 5 searches (k=10) on the host clock, each
ending in a synchronise, and traces the same searches with
``torch.profiler``. It prints, per bucket: the batch wall time, the
device busy time (the union of the kernels' intervals), the idle share,
and the kernels that took the most device time. With ``--out`` it also
writes each trace as a Chrome trace there.
"""

from __future__ import annotations

import argparse
import collections
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from raft_tpu_torch.spatial.ann import (
    GraphParams,
    IVFFlatParams,
    IVFPQParams,
    IVFSQParams,
    graph_build,
    graph_search,
    ivf_flat_build,
    ivf_flat_search_grouped,
    ivf_pq_build,
    ivf_pq_search_grouped,
    ivf_sq_build,
    ivf_sq_search_grouped,
)

DIM, K = 96, 10
ITERS = 5


def _busy_us(intervals):
    """Length of the union of (start, end) intervals, in microseconds."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def trace_calls(fn, iters, trace_path=None):
    """Time ``iters`` calls of ``fn`` (each ending in a synchronise) on
    the host clock after one warm call, then trace as many with
    ``torch.profiler``. Returns (wall_ms per call, busy_ms per call, top
    kernels as [(name, ms per call, launches per call)]); with
    ``trace_path``, writes the Chrome trace there."""
    def run():
        fn()
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    wall_ms = 1e3 * (time.perf_counter() - t0) / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the trace holds no device time (is CUPTI "
                           "tracing available?)")
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end)
                        for e in kernels]) / 1e3 / iters
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    if trace_path is not None:
        prof.export_chrome_trace(str(trace_path))
    return wall_ms, busy_ms, [(n, t / 1e3 / iters, c / iters)
                              for n, (t, c) in top]


def card_name(tool: str) -> str:
    """The card's name and power limit as nvidia-smi gives them; exits
    when there is no CUDA device."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{tool}: needs a CUDA device")
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def _clustered(rng, n, n_centers, spread):
    if spread is None:       # chip_smoke.py clustered_rows
        centers = rng.standard_normal((n_centers, DIM),
                                      dtype=np.float32) * 2.0
    else:                    # chip_smoke.py ann_dataset
        centers = rng.uniform(-spread, spread,
                              (n_centers, DIM)).astype(np.float32)
    return (centers[rng.integers(0, n_centers, n)]
            + rng.standard_normal((n, DIM), dtype=np.float32))


def build(kind: str, rng, beam: int = 32, ranks: int = 8,
          engine: str = "flat"):
    """(rows, index, search(q, arg), [(bucket, arg)]) of the path of
    ``kind``: the arg is the qcap of an IVF search, the warmed iteration
    count of a graph search and the engine of a coarse probe (the index
    is then the centroid set)."""
    if kind == "coarse":
        return _build_coarse(rng)
    if kind == "mutable":
        return _build_mutable(rng)
    if kind == "sharded":
        return _build_sharded(rng, ranks, engine)
    if kind == "graph":
        x = _clustered(rng, 500_000, 1000, 10.0)
        index = graph_build(x, GraphParams(degree=16, intermediate_degree=32,
                                           n_entry=4, seed=0),
                            metric="sqeuclidean")

        def search(q, iters):
            return graph_search(index, q, K, beam=beam, iters=iters)
        plan = [(nq, index.warmup(nq, k=K, beam=beam)) for nq in (1, 4096)]
        return x, index, search, plan
    if kind == "flat":
        x = _clustered(rng, 1_000_000, 2000, None)
        index = ivf_flat_build(x, IVFFlatParams(
            n_lists=1024, kmeans_n_iters=10, kmeans_init="random"))

        def search(q, qcap):
            return ivf_flat_search_grouped(index, q, K, n_probes=8,
                                           qcap=qcap)
        warm = dict(n_probes=8)
        plan = [(8, None), (4096, None)]
    else:
        x = _clustered(rng, 500_000, 1000, 10.0)
        if kind == "sq":
            index = ivf_sq_build(x, IVFSQParams(
                n_lists=2048, kmeans_n_iters=10, max_list_cap=512))

            def search(q, qcap):
                return ivf_sq_search_grouped(index, q, K, n_probes=16,
                                             qcap=qcap)
            warm = dict(n_probes=16)
        else:
            index = ivf_pq_build(x, IVFPQParams(
                n_lists=2048, pq_dim=24, kmeans_n_iters=10,
                kmeans_init="random", max_list_cap=512))

            def search(q, qcap):
                return ivf_pq_search_grouped(index, q, K, n_probes=16,
                                             qcap=qcap, refine_ratio=4.0)
            warm = dict(n_probes=16, refine_ratio=4.0)
        plan = [(8, None), (4096, "throughput")]
    plan = [(nq, index.warmup(nq, k=K, **warm) if qc is None else qc)
            for nq, qc in plan]
    return x, index, search, plan


def _build_mutable(rng):
    from raft_tpu_torch.spatial.ann import mutation as mut

    x, index, _, plan = build("flat", rng)
    n = x.shape[0]
    m = mut.wrap_mutable(index, delta_cap=64)
    fresh = (x[rng.integers(0, n, 256)]
             + 0.3 * rng.standard_normal((256, DIM), dtype=np.float32))
    m, _ = mut.upsert(m, fresh, np.arange(n, n + 256, dtype=np.int32))
    dead = rng.choice(n, n // 10, replace=False).astype(np.int32)
    for s in range(0, dead.size, 8192):
        m, _ = mut.delete(m, dead[s:s + 8192])

    def search(q, qcap):
        return mut.mutable_search(m, q, K, n_probes=8, qcap=qcap)
    return x, index, search, plan


def _build_sharded(rng, ranks: int, engine: str = "flat"):
    from raft_tpu_torch.comms import (
        build_comms,
        mnmg_ivf_flat_build,
        mnmg_ivf_flat_search,
        mnmg_ivf_pq_build,
        mnmg_ivf_pq_search,
    )

    dev = torch.device("cuda", torch.cuda.current_device())
    comms = build_comms([dev] * ranks)
    if engine == "pq":
        x = _clustered(rng, 500_000, 1000, 10.0)
        index = mnmg_ivf_pq_build(comms, x, IVFPQParams(
            n_lists=2048, pq_dim=24, kmeans_n_iters=10,
            kmeans_init="random", max_list_cap=512))

        def search(q, qcap):
            return mnmg_ivf_pq_search(comms, index, q, K, n_probes=16,
                                      qcap=qcap, refine_ratio=4.0)
        plan = [(8, index.warmup(comms, 8, k=K, n_probes=16,
                                 refine_ratio=4.0)),
                (4096, index.warmup(comms, 4096, k=K, n_probes=16,
                                    qcap="throughput", refine_ratio=4.0))]
        return x, index, search, plan
    x = _clustered(rng, 1_000_000, 2000, None)
    index = mnmg_ivf_flat_build(comms, x, IVFFlatParams(
        n_lists=1024, kmeans_n_iters=10, kmeans_init="random"))

    def search(q, qcap):
        return mnmg_ivf_flat_search(comms, index, q, K, n_probes=8,
                                    qcap=qcap)
    plan = [(nq, index.warmup(comms, nq, k=K, n_probes=8))
            for nq in (8, 4096)]
    return x, index, search, plan


def _at_once_rendezvous():
    """(turns, group) classes for ``Comms.run``'s plain alternative to
    taking turns: every rank thread runs at once; a rank whose peers
    have not all posted sleeps on its event, and the last poster wakes
    every waiter of that collective."""
    from raft_tpu_torch.comms import comms as cm

    class AtOnce(cm._Turns):
        def pass_turn(self, r):
            self.progress = time.monotonic()
            for k in range(self.size):
                rec = self.waits[k]
                if rec is not None and rec.complete:
                    self.wake[k].set()

        def await_turn(self, r):
            deadline = time.monotonic() + self.timeout_s
            while not self.broken and not self._runnable(r):
                self.lock.release()
                try:
                    woke = self.wake[r].wait(
                        max(0.0, deadline - time.monotonic()))
                finally:
                    self.lock.acquire()
                self.wake[r].clear()
                if not woke and not self.broken:
                    self.timed_out = True
                    self._break()
            if self.broken:
                raise cm._Aborted()
            self.waits[r] = None

    class AtOnceGroup(cm._ThreadGroup):
        def exchange(self, i, value):
            if self.size == 1:
                return [value]
            t, r = self.turns, self.members[i]
            with t.lock:
                if t.broken:
                    raise cm._Aborted()
                gen = self.gen[i]
                self.gen[i] += 1
                rec = self.records.get(gen)
                if rec is None:
                    rec = self.records[gen] = cm._Record(self.size)
                rec.slots[i] = value
                rec.posted += 1
                if rec.complete:
                    t.pass_turn(r)
                else:
                    t.waits[r] = rec
                    t.await_turn(r)
                got = list(rec.slots)
                rec.read += 1
                if rec.read == self.size:
                    del self.records[gen]
                return got

    return AtOnce, AtOnceGroup


def compare_rendezvous(search, q, arg, pairs: int):
    """Host ms per search (``ITERS`` searches, each ending in a
    synchronise) for ``pairs`` alternating pairs: taking turns, then all
    at once. Returns ([turns ms], [at-once ms])."""
    from unittest import mock

    from raft_tpu_torch.comms import comms as cm

    at_once, at_once_group = _at_once_rendezvous()

    def timed():
        search(q, arg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            search(q, arg)
            torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / ITERS

    turns, plain = [], []
    for _ in range(pairs):
        turns.append(timed())
        with mock.patch.object(cm, "_Turns", at_once), \
                mock.patch.object(cm, "_ThreadGroup", at_once_group):
            plain.append(timed())
    return turns, plain


def _build_coarse(rng):
    from raft_tpu_torch.spatial.ann import coarse as tco
    from raft_tpu_torch.spatial.ann import common as cm

    x = _clustered(rng, 1_000_000, 2000, None)
    base = ivf_flat_build(x, IVFFlatParams(
        n_lists=1024, kmeans_n_iters=10, kmeans_init="random",
    )).centroids.float()
    n_extra = 65_792 - base.shape[0]
    sel = torch.as_tensor(rng.integers(0, base.shape[0], n_extra),
                          device=base.device)
    jitter = torch.as_tensor(0.5 * rng.standard_normal(
        (n_extra, DIM), dtype=np.float32), device=base.device)
    cents = torch.cat([base, base[sel] + jitter])
    coarse = cm.build_coarse_index(cents, n_super=4096, member_cap=26)
    args_c = (coarse.super_cents, coarse.member_ids, coarse.cents_padded,
              coarse.n_cents, 16, cm.n_super_probes(16, coarse.n_super))

    def search(q, engine):
        if engine == "flat":
            return cm.coarse_probe(q, cents, 16)
        return tco.two_level_probe(q, *args_c,
                                   use_kernel=engine == "kernel")
    return x, cents, search, [(16_384, e)
                              for e in ("flat", "legacy", "kernel")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kind", choices=("flat", "sq", "pq", "graph",
                                       "coarse", "mutable", "sharded"),
                    default="flat")
    ap.add_argument("--beam", type=int, default=32)
    ap.add_argument("--engine", choices=("flat", "pq"), default="flat",
                    help="the sharded index's engine (--kind sharded)")
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--rendezvous-pairs", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    card = card_name("profile_grouped")
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)

    rng = np.random.default_rng(args.seed)
    x, index, search, plan = build(args.kind, rng, args.beam, args.ranks,
                                   args.engine)
    dev = getattr(index, "device", None) or torch.device("cuda")
    arg_name = {"graph": "iters", "coarse": "engine"}.get(args.kind,
                                                          "qcap")
    for nq, qcap in plan:
        q = torch.as_tensor(
            x[rng.integers(0, x.shape[0], nq)]
            + 0.3 * rng.standard_normal((nq, DIM), dtype=np.float32),
            device=dev)
        wall, busy, top = trace_calls(
            lambda: search(q, qcap), ITERS,
            None if args.out is None
            else args.out / f"trace_{args.kind}_{args.engine}_{nq}_"
            f"{qcap}.json")
        what = (f"{args.kind} {args.engine}" if args.kind == "sharded"
                else args.kind)
        print(f"[{card}] {what} bucket {nq} ({arg_name} {qcap}): "
              f"{wall:.3f} ms per batch, device busy {busy:.3f} ms, idle "
              f"{1 - busy / wall:.1%}", flush=True)
        for name, ms, n in top:
            print(f"    {ms:9.4f} ms {n:7.1f}x  {name[:100]}", flush=True)
        if args.kind == "sharded" and args.rendezvous_pairs > 0:
            turns, plain = compare_rendezvous(search, q, qcap,
                                              args.rendezvous_pairs)
            print(f"[{card}] sharded bucket {nq}, host ms per search over "
                  f"{ITERS}, pairs (taking turns / all at once): "
                  + ", ".join(f"{a:.3f} / {b:.3f}"
                              for a, b in zip(turns, plain))
                  + f"; medians {np.median(turns):.3f} / "
                  f"{np.median(plain):.3f}, quartile spreads "
                  f"{np.subtract(*np.percentile(turns, [75, 25])):.3f} / "
                  f"{np.subtract(*np.percentile(plain, [75, 25])):.3f}, "
                  f"turns faster in {sum(a < b for a, b in zip(turns, plain))}"
                  f" of {len(turns)} pairs", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
