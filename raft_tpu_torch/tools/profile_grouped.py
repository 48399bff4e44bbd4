"""Where the time of one grouped IVF-Flat search batch goes, on one CUDA
card.

    python3 -m raft_tpu_torch.tools.profile_grouped [--seed N] [--out DIR]

Builds the main path's index (1,000,000 clustered rows of width 96,
1024 lists, as ``chip_smoke.py``), warms each profiled bucket, then for
each bucket times 5 searches (k=10, n_probes=8, the warmed qcap) on the
host clock, each ending in a synchronise, and traces the same searches
with ``torch.profiler``. It prints, per bucket: the batch
wall time, the device busy time (the union of the kernels' intervals),
the idle share, and the kernels that took the most device time. With
``--out`` it also writes each trace as a Chrome trace there.
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
    IVFFlatParams,
    ivf_flat_build,
    ivf_flat_search_grouped,
)

N_ROWS, DIM, N_LISTS, N_PROBES, K = 1_000_000, 96, 1024, 8, 10
# the smallest and the largest serving bucket of chip_smoke.py
BUCKETS = (8, 4096)
ITERS = 5


def _busy_us(intervals):
    """Length of the union of (start, end) intervals, in microseconds."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def profile_bucket(index, queries, qcap, iters, out_dir=None):
    """Returns (wall_ms per batch, busy_ms per batch, top kernels as
    [(name, ms per batch, launches per batch)])."""
    def run():
        ivf_flat_search_grouped(index, queries, K, n_probes=N_PROBES,
                                qcap=qcap)

    return trace_calls(run, iters, None if out_dir is None
                       else out_dir / f"trace_{len(queries)}.json")


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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    card = card_name("profile_grouped")
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)

    rng = np.random.default_rng(args.seed)
    centers = rng.standard_normal((2000, DIM), dtype=np.float32) * 2.0
    x = (centers[rng.integers(0, 2000, N_ROWS)]
         + rng.standard_normal((N_ROWS, DIM), dtype=np.float32))
    index = ivf_flat_build(x, IVFFlatParams(
        n_lists=N_LISTS, kmeans_n_iters=10, kmeans_init="random"))
    for nq in BUCKETS:
        qcap = index.warmup(nq, k=K, n_probes=N_PROBES)
        q = torch.as_tensor(
            x[rng.integers(0, N_ROWS, nq)]
            + 0.3 * rng.standard_normal((nq, DIM), dtype=np.float32),
            device=index.device)
        wall, busy, top = profile_bucket(index, q, qcap, ITERS, args.out)
        print(f"[{card}] bucket {nq} (qcap {qcap}): {wall:.3f} ms per "
              f"batch, device busy {busy:.3f} ms, idle "
              f"{1 - busy / wall:.1%}", flush=True)
        for name, ms, n in top:
            print(f"    {ms:9.4f} ms {n:7.1f}x  {name[:100]}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
