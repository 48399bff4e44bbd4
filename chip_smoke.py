#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (raft_tpu_torch) on one Hopper card.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from ``raft_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version, times it, and drives the
port's paths at full width, each with the kernels' launch counters set
to 0 just before it and read just after:

* IVF-Flat: an index over 1,000,000 clustered rows of width 96 (DEEP's
  width) built with 1024 lists, warmed per serving bucket, serving ~200
  requests through the bucketed micro-batcher and the grouped search,
  with recall@10 of both scan engines against exact brute force; then
  the open-loop ``ServingExecutor`` over that index (with one
  ``ProfileTrigger`` capture under load); then the mutation
  tier over it (upsert -> visible, 10% tombstones, recall on the
  survivors on both engines, the mixed-ingest row, compaction and a
  background compaction under searches, a cached answer gone stale
  after a write, the durable-ingest row, checkpoint + WAL-tail recovery
  and the v4 archive bitwise, the kill-9 leg); then the cold tier over
  it at 4x its hot budget (``TieredListStore`` on the pinned legacy
  engine: all hot equal to the resident search, convergence from misses
  to recall >= 0.95 on a working set that fits, the cold-tier row
  through the executor, a dispatch raced against membership flips,
  deletes, a recovered state and a compaction synced in, under a stall
  watchdog); then the same rows in a sharded IVF-Flat index
  (``raft_tpu_torch.comms``) at P = 8 ranks on the card: both
  communicator forms' self-tests (in process, and NCCL at world size 1),
  the build, the 4,096 batch on both engines against the oracle and the
  single-device index, every list probed, P = 8 against P = 1 and NCCL
  bitwise, a down rank with and without a replica, a NaN row, a rank
  recovered from an archive, ~100 requests through the executor with
  the coverage gauge, and the IVF-SQ sibling;
* the two-level coarse probe over 65,792 centroids of width 96 (the
  served index's and jittered draws of them, bench.py's recipe): the
  FLOP ratio, both engines' recall against the flat probe, the kernel
  engine's 16,384-query batch against the legacy engine, the flat scan
  kernel on both of its stages, and the three probes' times;
* single linkage (``sparse.hierarchy.single_linkage``, the RAFT call
  behind cuML's single-linkage AgglomerativeClustering) over 262,144 x
  128 rows around 512 centres: the k = 16 kNN graph on the fused kernels,
  the Borůvka MST and the connect-components rounds on the card, the
  dendrogram on the native host library; labels against the centres and
  against the same call on the scan-path graph, the stitching edges in
  the graph's metric and each pair entered once, an 8-cluster cut
  against a host f64 oracle; then spectral partitioning over 131,072 x
  128 rows around 8 centres (``fit_embedding``, ``partition``: purity,
  and Lanczos against the dense Laplacian's eigenvalues on a 4,096-row
  subsample);
* the toolkit, which reaches no kernel: sparse kNN at
  bench/bench_sparse.py's cell (20,000 x 2,000 x 100,000, k = 10) on the
  CSR colblock route, the prebuilt index and its ``precision="default"``
  route against scipy's f64 product, with auto -> dense and l1 cases;
  ``make_blobs`` at bench/common.py's recipe and the distributions'
  moments; the stats on the linkage and spectral results; the auction
  at 1,024 (f64 and f32) and 16 x 256 against scipy; labels and matrix
  helpers against numpy;
* IVF-SQ and IVF-PQ (bench.py's extra_sq_scan_kernel and extra_ivf_pq
  configurations) over 500,000 rows of width 96 around 1,000 centres:
  build, warm, serve ~100 requests each, and a 4,096-query batch on both
  engines, with recall@10 against exact brute force; each then wrapped
  for mutation (256 upserts, 10% deletes, the batch on both engines,
  one compaction); the SQ index tiered with int8 hot slots;
* graph ANN (bench/bench_serving.py's graph_ann_row) over the same rows:
  a degree-16 graph built on the card, recall@10 of the 4,096-query
  batch at beams 16/32/64 on both engines (equal distances required,
  but on queries whose walks diverge at a near-tie, each one shown)
  beside IVF-Flat's (2048 lists, 16 probes), warmup per bucket at the
  smallest beam within 0.01 of it (else the widest), ~100 served
  requests, and the nq = 1 p50 of the beam search beside IVF-Flat's at
  qcap 1;
* brute-force kNN through ``brute_force_knn``: 1,000,000 x 128 clustered
  rows (SIFT-1M's shape) serving ~100 bucketed requests, one
  10,000-query batch with f32 and bf16 phase 1, the scan path on 1,000
  of those queries, and 2,000,000 x 768 bf16 rows in two partitions
  (the width of the 10M x 768 regime, depth cut for the time limit),
  with recall@10 and distances against an exact oracle;
* last, after every timed phase, the concurrency auditor: the static
  pass (``raft_tpu_torch.analysis``, both tiers) over the port and this
  script, which must find nothing, then the runtime lock tracer on with
  the port's pinned order over a ``ServingExecutor`` on the card whose
  submits race ``close()``, a WAL ingest round and the supervisor's
  kill -> heal cycle, ending in ``assert_clean()``.

Any failed check raises, and the script exits non-zero. The last two
lines of stdout are the ``kernels`` JSON line (one object for each of the
eight TPU kernels, and one for ``top_k_smallest``'s selection kernel) and
the ``{"ok": true, ...}`` device line.

Imports neither JAX nor the JAX package. Needs one CUDA device of
compute capability 9.0; without one it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import dataclasses
import faulthandler
import importlib
import io
import json
import math
import os
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): the bound
# of a kernel is the larger of its bytes over the memory rate and its
# operations over the rate of their type.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12

N_ROWS, DIM, N_LISTS, N_PROBES, K = 1_000_000, 96, 1024, 8, 10
BUCKETS = (8, 64, 512, 4096)
N_REQUESTS = 200

# quantized IVF (bench.py extra_sq_scan_kernel / extra_ivf_pq): 500,000
# clustered rows of width 96 around 1,000 centres, 4,096 queries
QZ_ROWS, QZ_CENTERS, QZ_QUERIES, QZ_LISTS, QZ_PROBES = \
    500_000, 1000, 4096, 2048, 16
QZ_REQUESTS = 100
PQ_DIM, PQ_BITS, PQ_REFINE = 24, 8, 4.0

# graph ANN (bench/bench_serving.py:1312 graph_ann_row on the same corpus):
# degree 16 (intermediate 32), 4 seeded entries, beams 16/32/64; the
# IVF-Flat baseline at 2048 lists capped at 488 rows (serving_latency_rows'
# cap rule), 16 probes
GRAPH_DEGREE, GRAPH_ENTRIES, GRAPH_BEAMS = 16, 4, (16, 32, 64)
GRAPH_IVF_CAP = 488

# brute-force kNN at SIFT-1M's shape (bench/bench_knn.py:19), and the
# width of the 10M x 768 regime at 2M rows in two bf16 partitions
SIFT_ROWS, SIFT_DIM, SIFT_QUERIES = 1_000_000, 128, 10_000
BF_REQUESTS = 100
WIDE_ROWS, WIDE_DIM, WIDE_QUERIES = 2_000_000, 768, 1024


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg) -> None:
    """A failed smoke check (kept under ``python -O``, unlike assert)."""
    if not cond:
        raise AssertionError(f"chip_smoke: {msg}")


def cuda_time_ms(fn, arg_sets, iters: int = 50, warm: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` warmed launches (CUDA
    events around the whole run), each launch on the next of
    ``arg_sets`` in turn: copies of the inputs that together overflow
    the L2 cache, so every launch reads its inputs from device memory."""
    for i in range(warm):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def input_copies(*ts):
    """Enough copies of a call's tensor inputs (each keeping its strides)
    to fill four times the card's L2 cache, at least two, so timed
    launches read device memory."""
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                 50 << 20)
    nbytes = sum(t.numel() * t.element_size() for t in ts)
    return [tuple(t.clone() for t in ts)
            for _ in range(max(2, math.ceil(4 * l2 / nbytes)))]


def bound(nbytes, flops, flop_rate):
    """(bound_ms, bound_by): the larger of the bytes at the memory rate
    and the operations at ``flop_rate``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    log(smi)
    log(f"device: {name}, capability {cap[0]}.{cap[1]}, "
        f"count {torch.cuda.device_count()}, torch {torch.__version__} "
        f"(CUDA {torch.version.cuda})")
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs capability 9.0, got {cap}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("chip_smoke: TF32 matmuls are on")
    from raft_tpu_torch.core.device import full_f32

    inside = full_f32(lambda: torch.backends.cuda.matmul.allow_tf32)()
    check(inside is False, "full_f32 left TF32 matmuls on")
    return smi.splitlines()[0]


def phase_build():
    from raft_tpu_torch import _build, native
    from raft_tpu_torch.spatial.ann import flat_kernel

    # the native host library (g++) builds beside the nvcc processes
    host = {}

    def host_build():
        t = time.perf_counter()
        host["ok"] = native.available()
        host["s"] = time.perf_counter() - t

    host_thread = threading.Thread(target=host_build)
    host_thread.start()
    t0 = time.perf_counter()
    out_dir = _build.build_all()
    build_s = time.perf_counter() - t0
    host_thread.join()
    check(host["ok"], "the native host library (raft_tpu_torch/native) did "
          "not build")
    from raft_tpu_torch.spatial.ann import pq_kernel

    lib = flat_kernel._lib()
    check(all(lib.raft_flat_scan_q_tile(q) == flat_kernel._q_tile(q)
              and lib.raft_flat_scan_smem_bytes(DIM, flat_kernel._q_tile(q))
              == flat_kernel._lists_smem_bytes(DIM, flat_kernel._q_tile(q))
              for q in (1, 8, 9, 24, 64, 65, 4096)),
          "the wrapper's shared-memory model disagrees with the kernel's")

    def form(d, q):
        q_tile, smem = ctypes.c_int(), ctypes.c_longlong()
        wide = lib.raft_flat_scan_form(d, q, ctypes.byref(q_tile),
                                       ctypes.byref(smem))
        return bool(wide), q_tile.value, smem.value

    check(all(form(d, q) == flat_kernel.scan_form(d, q)
              for q in (1, 8, 9, 24, 64, 65, 632, 4096)
              for d in (DIM, 20, 768, 960, 1536, 2048, 12000)),
          "the wrapper's rule of the flat scan's form disagrees with the "
          "kernel's")
    check(all(lib.raft_sq_scan_smem_bytes(d, flat_kernel._q_tile(q))
              == flat_kernel._sq_lists_smem_bytes(d, flat_kernel._q_tile(q))
              for q in (1, 8, 24, 64, 65) for d in (DIM, 20, 24)),
          "the SQ wrapper's shared-memory model disagrees with the kernel's")
    plib = pq_kernel._lib()
    check(all(plib.raft_pq_lists_slots(q, m, k) == pq_kernel._slots(q, m, k)
              and plib.raft_pq_lists_smem_bytes(pq_kernel._slots(q, m, k),
                                                m, k)
              == pq_kernel._smem_bytes(pq_kernel._slots(q, m, k), m, k)
              for q in (1, 3, 8, 24) for m, k in ((PQ_DIM, 1 << PQ_BITS),
                                                  (96, 256), (5, 7))),
          "the ADC wrapper's shared-memory model disagrees with the kernel's")
    log(f"build: csrc/*.cu -> {out_dir} in {build_s:.2f} s; native/src/"
        f"host_algos.cpp -> {native.lib_path()} in {host['s']:.2f} s")


def _int_inputs(gen, lb, q, d, l_pad, dev):
    qr = torch.randint(-64, 64, (lb, q, d), generator=gen).to(dev)
    rows = torch.randint(-64, 64, (lb, l_pad, d), generator=gen).to(dev)
    return qr.to(torch.bfloat16), rows.to(torch.bfloat16)


def _bounds(gen, lb, l_pad, dev):
    """Ragged, empty and full [lo, hi) ranges, lo off the 8-row grain."""
    lo = torch.randint(0, l_pad // 2, (lb,), generator=gen)
    hi = lo + torch.randint(0, l_pad // 2, (lb,), generator=gen)
    lo[0], hi[0] = 0, l_pad                   # full
    lo[1], hi[1] = 13, 13                     # empty
    return torch.stack([lo, hi], 1).to(torch.int32).to(dev)


def check_kernel(lb, q, d, l_pad, seed):
    """The kernel against its plain version: bitwise on integer-exact
    inputs (contiguous and transposed-view slab), and on Gaussian inputs
    as :func:`compare_to_plain` says. Returns the Gaussian case's
    max |kernel - plain| over valid entries."""
    from raft_tpu_torch.spatial.ann import flat_kernel as fk

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    bounds = _bounds(gen, lb, l_pad, dev)
    qr, rows = _int_inputs(gen, lb, q, d, l_pad, dev)
    view = rows.transpose(1, 2)               # strided (LB, d, Lpad)
    want = fk.flat_scan_subchunk_min_plain(qr, view, bounds)
    for slab in (view, view.contiguous()):
        got = fk.flat_scan_subchunk_min(qr, slab, bounds)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(
                f"flat_scan_subchunk_min ({lb},{q},{d},{l_pad}) strides "
                f"{slab.stride()}: {bad} entries differ from the plain "
                "version on integer-exact inputs")
    qg = torch.randn((lb, q, d), generator=gen).to(dev).to(torch.bfloat16)
    yg = torch.randn((lb, l_pad, d), generator=gen).to(dev).to(
        torch.bfloat16).transpose(1, 2)
    return compare_to_plain(qg, yg, bounds)


def compare_to_plain(qr, slabs_t, bounds):
    """Kernel vs plain version on generic inputs: masked entries equal,
    valid ones within 1e-5 x (qn + yn) of each other (the f32 sums run in
    another order). Returns max |kernel - plain| over valid entries."""
    from raft_tpu_torch.spatial.ann import flat_kernel as fk

    lb = qr.shape[0]
    got = fk.flat_scan_subchunk_min(qr, slabs_t, bounds)
    want = fk.flat_scan_subchunk_min_plain(qr, slabs_t, bounds)
    qn = (qr.float() ** 2).sum(-1)[:, :, None]
    yn = (slabs_t.float() ** 2).sum(1).reshape(lb, 1, -1, 8).amax(-1)
    err = (got - want).abs()
    if not (err <= 1e-5 * (qn + yn)).all():
        raise AssertionError(
            f"flat_scan_subchunk_min {tuple(qr.shape)} x "
            f"{tuple(slabs_t.shape)}: off by {err.max().item()} > "
            "1e-5 x (qn + yn)")
    valid = want < 1e30
    return err[valid].max().item() if valid.any() else 0.0


def time_kernel(qr, slabs_t, bounds):
    """ms of the kernel, of its plain version and of the library
    yardstick (baddbmm of the norm bias minus 2 x the f32 gram, then the
    8-row amin; timed only, never called by the port), each rotating
    over copies of the inputs that overflow L2."""
    from raft_tpu_torch.core.device import full_f32
    from raft_tpu_torch.spatial.ann import flat_kernel as fk

    lb, q, d = qr.shape
    l_pad = slabs_t.shape[2]
    sets = input_copies(qr, slabs_t, bounds)
    ms = cuda_time_ms(fk.flat_scan_subchunk_min, sets)
    plain_ms = cuda_time_ms(fk.flat_scan_subchunk_min_plain, sets)
    del sets
    lib_sets = []
    for qc, yc, _ in input_copies(qr, slabs_t, bounds):
        qf, yf = qc.float(), yc.float()
        lib_sets.append((qf, yf, ((qf * qf).sum(-1)[:, :, None]
                                  + (yf * yf).sum(1)[:, None, :])))

    @full_f32
    def library(qf, yf, bias):
        t = torch.baddbmm(bias, qf, yf, alpha=-2.0)
        return t.reshape(lb, q, l_pad // 8, 8).amin(-1)

    library_ms = cuda_time_ms(library, lib_sets)
    return ms, plain_ms, library_ms


@contextlib.contextmanager
def kernel_calls(mod, name, key, keep=None):
    """Count the calls of ``mod.name`` (a kernel's wrapper) by
    ``key(args)`` and, with a list ``keep``, keep each call's inputs
    there. The wrapper still runs (and counts its launches) as before."""
    wrapper = getattr(mod, name)
    shapes = collections.Counter()

    def recording(*args, **kw):
        shapes[key(args)] += 1
        if keep is not None:
            keep.append(args)
        return wrapper(*args, **kw)

    setattr(mod, name, recording)
    try:
        yield shapes
    finally:
        setattr(mod, name, wrapper)


def engine_fallbacks(name, reset=False):
    """The grouped searches of engine ``name`` (``ivf_flat``, ``ivf_sq``,
    ``ivf_pq``) that the engine rule sent off the kernel
    (``grouped.ENGINE_FALLBACKS``), zeroed first with ``reset``."""
    from raft_tpu_torch.spatial.ann import grouped

    if reset:
        grouped.ENGINE_FALLBACKS[name] = 0
    return grouped.ENGINE_FALLBACKS[name]


@contextlib.contextmanager
def body_calls(admit, record, keep=()):
    """Record every call of the one grouped-search body
    (``grouped.search``) whose engine and keyword arguments ``admit(
    engine, kw)`` takes, as ``record(args, kw, added, launches)``: its
    arguments, keyword arguments, the slice of ``keep`` (filled by
    :func:`kernel_calls`) that it added, and the flat-scan launches it
    made."""
    from raft_tpu_torch.spatial.ann import flat_kernel as fk
    from raft_tpu_torch.spatial.ann import grouped

    real = grouped.search
    calls = []

    def recording(*args, **kw):
        start, before = len(keep), fk.LAUNCHES
        out = real(*args, **kw)
        if admit(args[0], kw):
            calls.append(record(args, kw, keep[start:],
                                fk.LAUNCHES - before))
        return out

    grouped.search = recording
    try:
        yield calls
    finally:
        grouped.search = real


@contextlib.contextmanager
def path_batches(name, keep):
    """Record the kernel-engine batches of the grouped body on engine
    ``name``: for each, its queries and the calls it launched, the slice
    of ``keep`` (filled by :func:`kernel_calls`) that it added."""
    with body_calls(lambda e, kw: e.name == name and e.kernel,
                    lambda args, kw, added, n: (args[1], added),
                    keep) as batches:
        yield batches


@contextlib.contextmanager
def impl_calls(name, keep):
    """Record every call of the grouped body on engine ``name`` (either
    form): its arguments, keyword arguments and the slice of ``keep``
    (filled by :func:`kernel_calls`) that it added."""
    with body_calls(lambda e, kw: e.name == name,
                    lambda args, kw, added, n: (args, kw, added),
                    keep) as calls:
        yield calls


def batch_per_key(batches, key):
    """One recorded batch for each ``key(nq, calls)``: the last one with
    a nonzero query (a served or measured batch), else the warmup's
    all-zeros batch. Returns {key: (nq, calls, warmup)}."""
    out = {}
    for q, calls in batches:
        k = key(q.shape[0], calls)
        warm = not bool(q.any())
        if k not in out or not warm:
            out[k] = (q.shape[0], calls, warm)
    return out


def scan_calls(keep=None):
    """The grouped search's flat-scan calls (``flat_scan_lists``, one a
    batch) by (Q, Lpad) shape (:func:`kernel_calls`)."""
    from raft_tpu_torch.spatial.ann import flat_kernel as fk

    return kernel_calls(fk, "flat_scan_lists",
                        lambda a: (a[1].shape[1], a[5]), keep)


def list_windows(gen, n_lists, n_rows, l_pad, dev):
    """(origins, bounds) of list windows as the grouped search makes
    them: lists 0 and 1 empty, list 2 full, the last list at the storage
    tail (its origin clamped, its range off the 8-row grain), the rest
    ragged."""
    sizes = torch.randint(1, l_pad + 1, (n_lists,), generator=gen)
    sizes[:2] = 0
    sizes[2] = l_pad
    sizes[-1] = l_pad // 2 + 3
    offsets = torch.randint(0, n_rows - l_pad, (n_lists,), generator=gen)
    offsets[-1] = n_rows - 1 - sizes[-1]
    origins = torch.clamp(offsets, max=n_rows - l_pad)
    lo = offsets - origins
    return (origins.to(torch.int32).to(dev),
            torch.stack([lo, lo + sizes], 1).to(torch.int32).to(dev))


def slot_map(gen, n_lists, q, n_live, dead, dev):
    """(lists, Q) int32 slot map: live slots front-packed with ids in
    [0, n_live), the rest ``dead``; list 2 all live, list 3 none."""
    occ = torch.randint(0, q + 1, (n_lists, 1), generator=gen)
    occ[2], occ[3] = q, 0
    ids = torch.randint(0, n_live, (n_lists, q), generator=gen)
    return torch.where(torch.arange(q)[None, :] < occ, ids,
                       dead).to(torch.int32).to(dev)


def lists_entry(call):
    """(kernel wrapper, plain version) of a list-scan call: the IVF-SQ
    scan when its rows are int8 codes, else the flat scan."""
    from raft_tpu_torch.spatial.ann import flat_kernel as fk
    from raft_tpu_torch.spatial.ann import sq_kernel as sk

    if call[2].dtype == torch.int8:
        return sk.sq_scan_lists, sk.sq_scan_lists_plain
    return fk.flat_scan_lists, fk.flat_scan_lists_plain


def row_values(call, rows=None):
    """f32 values of a list-scan call's rows (or of ``rows`` in their
    place): bf16 rows as they are, int8 codes dequantized as the kernel
    stages them."""
    from raft_tpu_torch.spatial.ann import sq_kernel as sk

    rows = call[2] if rows is None else rows
    if rows.dtype == torch.int8:
        return sk._dequant_tile(rows, call[6], call[7]).float()
    return rows.float()


def check_lists_kernel(seed, dev):
    """flat_scan_lists against its plain version: bitwise on
    integer-exact inputs, within 1e-5 x (qn + yn) on Gaussian ones, at
    query tiles of 8, 24, 64 and two of 40, d = 96 and a ragged d, with
    dead slots, empty and full ranges and the clamped tail window.
    Returns the Gaussian cases' max |kernel - plain| over live slots."""
    from raft_tpu_torch.spatial.ann import flat_kernel as fk

    gen = torch.Generator().manual_seed(seed)
    n_lists, nq, l_pad, err = 9, 60, 1160, 0.0
    for d in (DIM, 20):
        n_rows = 4 * l_pad + 3
        origins, bounds = list_windows(gen, n_lists, n_rows, l_pad, dev)
        for integer in (True, False):
            draw = ((lambda s: torch.randint(-64, 64, s, generator=gen)
                     .float()) if integer else
                    (lambda s: torch.randn(s, generator=gen)))
            queries = torch.cat([draw((nq, d)), torch.zeros((1, d))])
            queries = queries.to(torch.bfloat16).to(dev)
            rows = draw((n_rows, d)).to(torch.bfloat16).to(dev)
            for q in (8, 24, 64, 65):
                call = (queries, slot_map(gen, n_lists, q, nq, nq, dev),
                        rows, origins, bounds, l_pad)
                if integer:
                    bitwise(fk.flat_scan_lists, fk.flat_scan_lists_plain,
                            call, f"flat_scan_lists d={d} Q={q}")
                else:
                    err = max(err, compare_lists_to_plain(call))
    return err


def compare_lists_to_plain(call, rel=1e-5):
    """A list scan (flat or SQ, :func:`lists_entry`) vs its plain version
    on one batch's inputs: dead slots BIG in both, live ones within
    ``rel`` x (qn + yn) of each other (the tensor cores sum the dot, and
    the wide form the row norms, in another order). Returns max |kernel -
    plain| over live entries below BIG."""
    from raft_tpu_torch.spatial.ann import flat_kernel as fk

    queries, qmat, rows, origins, bounds, l_pad = call[:6]
    fn, plain = lists_entry(call)
    got = fn(*call)
    want = plain(*call)
    n = queries.shape[0] - 1
    live = (qmat >= 0) & (qmat < n)
    check(bool((got[~live] == fk.BIG).all() and (want[~live] == fk.BIG)
               .all()), f"{fn.__name__}: a dead slot is not BIG")
    qn = (queries.float() ** 2).sum(1)[qmat.clamp(0, n).long()][:, :, None]
    win = origins.long()[:, None] + torch.arange(l_pad, device=rows.device)
    yn = (row_values(call, rows[win]) ** 2).sum(-1).reshape(
        qmat.shape[0], 1, -1, 8).amax(-1)
    err = (got - want).abs()
    if not (err <= rel * (qn + yn)).all():
        raise AssertionError(
            f"chip_smoke: {fn.__name__} {tuple(qmat.shape)} x {l_pad}: off "
            f"by {err.max().item()} > {rel:.3g} x (qn + yn)")
    valid = live[:, :, None] & (want < 1e30)
    return err[valid].max().item() if valid.any() else 0.0


def lists_scan_bound(queries, qmat, rows, origins, bounds, l_pad,
                     *params, live_only=False):
    """(bound_ms, bound_by) of one list-scan launch (flat, or SQ with
    ``params`` vmin and vscale), counted on these inputs: the rows in
    [lo, hi) of the lists with a live slot (bf16 rows, or int8 codes and
    the f32 stats) and each distinct live query row read once (bf16), the
    slot map, origins and bounds read once, and every (list, slot,
    sub-chunk) minimum written once (f32), or with ``live_only`` the live
    slots' minima only (those the pool reads); 2 flop per multiply-add of
    a live slot and an in-range row at the bf16 rate."""
    n = queries.shape[0] - 1
    d = rows.shape[1]
    n_lists, q = qmat.shape
    live = (qmat >= 0) & (qmat < n)
    n_live = live.sum(1)
    span = (bounds[:, 1].clamp(0, l_pad)
            - bounds[:, 0].clamp(0, l_pad)).clamp(min=0)
    span = torch.where(n_live > 0, span, 0)
    n_out = int(n_live.sum()) if live_only else n_lists * q
    nbytes = (int(span.sum()) * d * rows.element_size()
              + torch.unique(qmat[live]).numel() * d * 2 + n_lists * q * 4
              + n_lists * 12 + n_out * (l_pad // 8) * 4
              + sum(t.numel() * 4 for t in params))
    return bound(nbytes, 2.0 * int((n_live * span).sum()) * d,
                 BF16_FLOP_PER_S)


def gathered_lists(queries, qmat, rows, origins, bounds, l_pad, *params):
    """A list scan's engine as it ran before the list entry: per 32-list
    block a query-row gather, a (32, Lpad, d) slab gather and one
    gathered-form launch (``flat_scan_subchunk_min``, or with ``params``
    vmin and vscale ``sq_scan_subchunk_min``; timed only, the path no
    longer runs it)."""
    from raft_tpu_torch.spatial.ann import flat_kernel as fk
    from raft_tpu_torch.spatial.ann import sq_kernel as sk

    win = torch.arange(l_pad, device=rows.device)
    for s in range(0, qmat.shape[0], 32):
        blk = slice(s, s + 32)
        slab = rows[origins[blk].long()[:, None] + win].transpose(1, 2)
        qv = queries[qmat[blk].long()]
        if params:
            sk.sq_scan_subchunk_min(qv, slab, bounds[blk], *params)
        else:
            fk.flat_scan_subchunk_min(qv, slab, bounds[blk])


def time_lists(call):
    """ms of one batch's list scan (flat or SQ, :func:`lists_entry`), of
    its plain version, of the gathered form it replaced
    (:func:`gathered_lists`, gathers included) and of the library
    yardstick (baddbmm of the norm bias minus 2 x the f32 gram over every
    list, then the 8-row amin, on pre-gathered f32 operands; for SQ the
    dequant, as torch elementwise operations, and the row norms are
    timed with it; timed only, never called by the port), each rotating
    over copies of the inputs that overflow L2."""
    from raft_tpu_torch.core.device import full_f32

    queries, qmat, rows, origins, bounds, l_pad = call[:6]
    params = call[6:]
    fn, plain = lists_entry(call)
    n_lists, q = qmat.shape
    sets = input_copies(queries, qmat, rows, origins, bounds)
    ms = cuda_time_ms(lambda *a: fn(*a, l_pad, *params), sets)
    plain_ms = cuda_time_ms(lambda *a: plain(*a, l_pad, *params), sets,
                            iters=2, warm=1)
    gathered_ms = cuda_time_ms(lambda *a: gathered_lists(*a, l_pad, *params),
                               sets, iters=5, warm=1)
    win = torch.arange(l_pad, device=rows.device)
    lib_sets = []
    for qs, qm, rw, og, _ in sets[:2]:
        qf = qs[qm.long()].float()
        slab = rw[og.long()[:, None] + win]
        if params:      # SQ: the codes, dequantized inside the timed call
            lib_sets.append((qf, slab, (qf * qf).sum(-1)[:, :, None]))
        else:
            yf = slab.float().transpose(1, 2)
            lib_sets.append((qf, yf, (qf * qf).sum(-1)[:, :, None]
                             + (yf * yf).sum(1)[:, None, :]))
    del sets

    @full_f32
    def library(qf, y, bias):
        if params:
            y = row_values(call, y).transpose(1, 2)
            bias = bias + (y * y).sum(1)[:, None, :]
        t = torch.baddbmm(bias, qf, y, alpha=-2.0)
        return t.reshape(n_lists, q, l_pad // 8, 8).amin(-1)

    library_ms = cuda_time_ms(library, lib_sets, iters=5, warm=1)
    return ms, plain_ms, gathered_ms, library_ms


def clustered_rows(rng, n, d, n_centers=2000):
    centers = rng.standard_normal((n_centers, d), dtype=np.float32) * 2.0
    lab = rng.integers(0, n_centers, n)
    return centers[lab] + rng.standard_normal((n, d), dtype=np.float32)


def exact_knn(x, q, k, block=1 << 16):
    """Exact squared-L2 top-k ids by plain f32 brute force (the oracle);
    ``x`` is one tensor or a list of row partitions (global ids)."""
    from raft_tpu_torch.core.device import full_f32

    @full_f32
    def run():
        qn = (q * q).sum(1)[:, None]
        best_v = torch.full((q.shape[0], k), float("inf"), device=q.device)
        best_i = torch.zeros((q.shape[0], k), dtype=torch.int64,
                             device=q.device)
        off = 0
        for part in (x if isinstance(x, (list, tuple)) else [x]):
            for s in range(0, part.shape[0], block):
                xb = part[s:s + block].float()
                d2 = qn + (xb * xb).sum(1)[None, :] - 2.0 * (q @ xb.T)
                v, i = torch.topk(d2, k, dim=1, largest=False)
                cat_v = torch.cat([best_v, v], 1)
                cat_i = torch.cat([best_i, i + off + s], 1)
                best_v, o = torch.topk(cat_v, k, dim=1, largest=False)
                best_i = torch.gather(cat_i, 1, o)
            off += part.shape[0]
        return best_i
    return run()


def recall(ids, true):
    ids, true = ids.cpu().numpy(), true.cpu().numpy()
    return sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(ids, true)) / true.size


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_requests(search, rows, rng, n_requests, dim, n_index, card, what):
    """Serve ``n_requests`` bucketed requests (1-512 rows, log-uniform,
    arriving 1-4 at a time ahead of each batch, so every bucket sees
    traffic) through the micro-batcher and ``search(queries, bucket)``;
    checks every answer's shape, range and order. Returns (requests,
    (dists, ids, bucket) by request id, p50 ms by bucket)."""
    from raft_tpu_torch.serving.batching import (
        BucketSet, PendingRequest, pack_requests,
    )

    buckets = BucketSet.of(BUCKETS)
    sizes = np.exp(rng.uniform(0.0, np.log(513.0), n_requests))
    requests = [rows(int(m)) for m in np.clip(sizes, 1, 512)]
    arrivals = [PendingRequest(r, None, 0.0) for r in requests]
    pending, served = [], {}
    lat = {b: [] for b in buckets.sizes}
    t_serve = time.perf_counter()
    while arrivals or pending:
        n_new = int(rng.integers(1, 5))
        pending += arrivals[:n_new]
        arrivals = arrivals[n_new:]
        batch, pending = pack_requests(pending, buckets, dim)
        t0 = time.perf_counter()
        d, ids = search(batch.queries, batch.bucket)
        # closed loop: a batch's latency ends at its host copy
        d, ids = d.cpu(), ids.cpu()  # jaxlint: disable=sync-in-hot-path
        lat[batch.bucket].append(1e3 * (time.perf_counter() - t0))
        for req, start in batch.entries:
            served[id(req.queries)] = (d[start:start + req.n_rows],
                                       ids[start:start + req.n_rows],
                                       batch.bucket)
    serve_s = time.perf_counter() - t_serve
    n_rows = sum(r.shape[0] for r in requests)
    for r in requests:
        d, ids, _ = served[id(r)]
        check(d.shape == (r.shape[0], K) and bool(torch.isfinite(d).all()),
              f"{what}: served distances of shape {tuple(d.shape)} not "
              "finite")
        check(bool(((ids >= 0) & (ids < n_index)).all()),
              f"{what}: served ids out of range")
        check(bool((d[:, 1:] >= d[:, :-1]).all()),
              f"{what}: served distances unsorted")
    p50 = {b: float(np.median(v)) for b, v in lat.items() if v}
    log(f"[{card}] {what} serve: {len(requests)} requests, {n_rows} rows in "
        f"{sum(len(v) for v in lat.values())} batches, {serve_s:.3f} s, "
        f"{n_rows / serve_s:.0f} queries/s; p50 ms by bucket "
        f"{ {b: round(v, 3) for b, v in p50.items()} }")
    return requests, served, p50


def main_path(seed, card, dev):
    """Build -> warm each bucket -> serve requests through the
    micro-batcher -> recall of both engines, on ``dev``. Returns the
    index, the warmed qcap of each bucket and the rows."""
    from raft_tpu_torch.spatial.ann import (
        IVFFlatParams, ivf_flat_build, ivf_flat_search_grouped,
    )

    rng = np.random.default_rng(seed)
    x = clustered_rows(rng, N_ROWS, DIM)

    t0 = time.perf_counter()
    index = ivf_flat_build(x, IVFFlatParams(
        n_lists=N_LISTS, kmeans_n_iters=10, kmeans_init="random",
    ), device=dev)
    sync(dev)
    build_s = time.perf_counter() - t0
    check(index.device.type == dev.type, f"index built on {index.device}")
    sizes = index.storage.list_sizes
    log(f"[{card}] build: {N_ROWS} x {DIM} -> {N_LISTS} lists in "
        f"{build_s:.2f} s (max_list {index.storage.max_list}, "
        f"empty lists {(sizes == 0).sum().item()})")

    t0 = time.perf_counter()
    qcaps = {b: index.warmup(b, k=K, n_probes=N_PROBES) for b in BUCKETS}
    log(f"[{card}] warmup: qcap per bucket {qcaps} in "
        f"{time.perf_counter() - t0:.2f} s")

    def noisy_rows(m):
        return (x[rng.integers(0, N_ROWS, m)]
                + 0.3 * rng.standard_normal((m, DIM), dtype=np.float32))

    requests, served, _ = serve_requests(
        lambda q, b: ivf_flat_search_grouped(index, q, K, n_probes=N_PROBES,
                                             qcap=qcaps[b]),
        noisy_rows, rng, N_REQUESTS, DIM, N_ROWS, card, "IVF-Flat")
    # served answers against exact brute force on a sample of requests
    sample = requests[:20]
    qs = torch.as_tensor(np.concatenate(sample), device=dev)
    true = exact_knn(torch.as_tensor(x, device=dev), qs, K)
    got = torch.cat([served[id(r)][1] for r in sample])
    r_served = recall(got, true)
    log(f"[{card}] served recall@10 (first 20 requests): {r_served:.4f}")
    check(r_served >= 0.8, f"served recall@10 {r_served}")

    qb = torch.as_tensor(noisy_rows(max(BUCKETS)), device=dev)
    true = exact_knn(torch.as_tensor(x, device=dev), qb, K)
    qc = qcaps[max(BUCKETS)]
    results = {}
    for name, engine in (("kernel", None), ("legacy", False)):
        sync(dev)
        t0 = time.perf_counter()
        _, ids = ivf_flat_search_grouped(index, qb, K, n_probes=N_PROBES,
                                         qcap=qc, use_kernel=engine)
        sync(dev)
        results[name] = (recall(ids, true), 1e3 * (time.perf_counter() - t0))
    nb = qb.shape[0]
    log(f"[{card}] {nb}-query batch: recall@10 kernel "
        f"{results['kernel'][0]:.4f} ({results['kernel'][1]:.2f} ms, "
        f"{1e3 * nb / results['kernel'][1]:.0f} queries/s), legacy "
        f"{results['legacy'][0]:.4f} ({results['legacy'][1]:.2f} ms, "
        f"{1e3 * nb / results['legacy'][1]:.0f} queries/s)")
    check(results["kernel"][0] >= results["legacy"][0] - 0.005,
          f"kernel engine recall below legacy: {results}")
    return index, qcaps, x


def ivf_flat_phase(args, card, dev):
    """The IVF-Flat path and its scan kernel; returns the kernel's entry
    of the ``kernels`` line."""
    from raft_tpu_torch.spatial.ann import flat_kernel as fk

    # kernel vs plain version: the fixed reference shape and a ragged one
    ref_err = 0.0
    for shape in ((32, 64, DIM, 3072), (3, 13, 24, 136)):
        err = check_kernel(*shape, seed=args.seed)
        ref_err = max(ref_err, err)
        log(f"kernel check {shape}: bitwise on integer-exact inputs, "
            f"Gaussian max |kernel - plain| {err:.3g}")
    gen = torch.Generator().manual_seed(args.seed)
    qr, rows = _int_inputs(gen, 32, 64, DIM, 3072, dev)
    bounds = _bounds(gen, 32, 3072, dev)
    ref = time_kernel(qr, rows.transpose(1, 2), bounds)
    # the gathered form as a list scan: every slot live, list b's window
    # at row b * 3072 of the slab
    ref_bound = lists_scan_bound(
        torch.cat([qr.reshape(-1, DIM), qr.new_zeros((1, DIM))]),
        torch.arange(32 * 64, device=dev, dtype=torch.int32).reshape(32, 64),
        rows.reshape(-1, DIM),
        torch.arange(0, 32 * 3072, 3072, device=dev, dtype=torch.int32),
        bounds, 3072)
    log(f"[{card}] flat_scan_subchunk_min (32, 64, {DIM}, 3072): "
        f"kernel {ref[0]:.4f} ms, plain {ref[1]:.4f} ms, library "
        f"{ref[2]:.4f} ms, bound {ref_bound[0]:.4f} ms ({ref_bound[1]})")

    err = check_lists_kernel(args.seed, dev)
    log("kernel check flat_scan_lists: bitwise on integer-exact inputs, "
        f"Gaussian max |kernel - plain| {err:.3g} (Q 8/24/64/65, d "
        f"{DIM} and 20, dead slots, empty/full/tail windows)")

    # the main path, with every launch counter at 0 just before it; each
    # kernel-engine batch and the calls it launched are kept

    fk.LAUNCHES = 0
    engine_fallbacks("ivf_flat", reset=True)
    keep = []
    with scan_calls(keep) as shapes, \
            path_batches("ivf_flat", keep) as batches, \
            select_k_path() as selected, rerank_path() as reranked:
        served = main_path(args.seed, card, dev)
    launches = fk.LAUNCHES
    select_k = select_k_path_entry(selected, "IVF-Flat main path", card)
    reranks = rerank_path_entry(reranked, "IVF-Flat main path", card)
    del selected, reranked
    log(f"main path: flat_scan_lists launched {launches} times, by "
        f"(Q, Lpad): {dict(shapes)}")
    check(launches > 0, "the main path never launched the kernel")
    check(engine_fallbacks("ivf_flat") == 0,
          f"{engine_fallbacks("ivf_flat")} main-path searches left the kernel")
    per_batch = collections.Counter(len(c) for _, c in batches)
    log(f"main path: {len(batches)} kernel-engine batches, flat-scan "
        f"launches per batch {dict(per_batch)}")
    check(set(per_batch) == {1} and len(batches) == launches,
          f"flat-scan launches per batch {dict(per_batch)} (one expected)")

    # the kernel against its plain version on every launch of the path:
    # its own query rows, slot maps, in-place rows and windows
    max_err = 0.0
    for call in keep:
        max_err = max(max_err, compare_lists_to_plain(call))
    log(f"kernel check on the main path: all {len(keep)} flat_scan_lists "
        f"calls within 1e-5 x (qn + yn) of the plain version, max |kernel "
        f"- plain| {max_err:.3g}")
    by_batch = batch_per_key(
        batches, lambda nq, c: (nq, c[0][1].shape[1], c[0][5]))
    del keep, batches

    timed = {}
    for (nq, q_, l_pad), (_, (call,), warm) in sorted(by_batch.items()):
        ms, plain_ms, gathered_ms, library_ms = time_lists(call)
        bound_ms, bound_by = lists_scan_bound(*call)
        live_ms, _ = lists_scan_bound(*call, live_only=True)
        timed[nq, q_, l_pad] = (ms, plain_ms, library_ms, bound_ms, bound_by,
                                gathered_ms, live_ms)
        live = int((call[1] < call[0].shape[0] - 1).any(1).sum())
        log(f"[{card}] flat_scan_lists per batch of {nq}"
            f"{' (the warmup, all zeros)' if warm else ''} at (lists, Q, d, "
            f"Lpad) ({call[1].shape[0]}, {q_}, {DIM}, {l_pad}), {live} "
            f"lists with a live slot, {shapes[q_, l_pad]} launches at this "
            f"(Q, Lpad): kernel {ms:.4f} ms ({bound_ms / ms:.1%} of the "
            f"bound, {live_ms / ms:.1%} of the live-minima bound), bound "
            f"{bound_ms:.4f} ms ({bound_by}), live-minima bound "
            f"{live_ms:.4f} ms, gathered form {gathered_ms:.4f} ms (32-list "
            f"gathers + launches; the bound is {bound_ms / gathered_ms:.1%} "
            f"of it), library {library_ms:.4f} ms, plain {plain_ms:.4f} ms")
    # the line reports the batch size of the (Q, Lpad) launched most,
    # its smallest bucket
    qc, l_pad = shapes.most_common(1)[0][0]
    nq = min(k[0] for k in timed if k[1:] == (qc, l_pad))
    ms, plain_ms, library_ms, bound_ms, bound_by, gathered_ms, live_ms = \
        timed[nq, qc, l_pad]
    slower = {k: (t[0], t[2]) for k, t in timed.items() if t[0] > t[2]}
    log("flat_scan_lists against baddbmm + amin per batch: "
        + (f"slower at {slower}" if slower else "no slower at any shape"))

    return served, {
        "name": "flat_scan_subchunk_min",
        "route": "cuda",
        "source": "raft_tpu_torch/csrc/flat_scan.cu",
        "replaces": "raft_tpu/spatial/ann/flat_kernel.py:115",
        "entry": "flat_scan_lists",
        "launches": launches,
        "launches_by_shape": {f"{a}x{b}": n for (a, b), n in shapes.items()},
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_live_ms": live_ms,
        "library_ms": library_ms,
        "gathered_ms": gathered_ms,
        "batch": nq,
        "shape": [N_LISTS, qc, DIM, l_pad],
        "card": card,
        "gathered": {"ms": ref[0], "plain_ms": ref[1], "library_ms": ref[2],
                     "bound_ms": ref_bound[0], "bound_by": ref_bound[1],
                     "max_abs_err": ref_err, "shape": [32, 64, DIM, 3072]},
        "select_k_path": select_k,
        "rerank_path": reranks,
    }


GIST_DIM, GIST_ROWS, GIST_LISTS, GIST_QUERIES = 960, 65_536, 64, 2048


def wide_rows_phase(args, card, dev):
    """IVF-Flat at GIST-1M's width (960) through the public entry with
    ``use_kernel=None``: every search on the kernel engine's wide form of
    the flat scan (no fallback, one launch a search, counted under
    ``form="kernel"``), each launch held against the plain version
    within the f32 summation bound, and the batch's recall against an
    exact oracle no lower than the legacy engine's."""
    from raft_tpu_torch.spatial.ann import (
        IVFFlatParams, ivf_flat_build, ivf_flat_search_grouped, search_obs,
    )
    from raft_tpu_torch.spatial.ann import flat_kernel as fk

    rng = np.random.default_rng(args.seed + 960)
    x = clustered_rows(rng, GIST_ROWS, GIST_DIM, n_centers=16)
    q = torch.as_tensor(
        x[rng.integers(0, GIST_ROWS, GIST_QUERIES)]
        + rng.standard_normal((GIST_QUERIES, GIST_DIM), dtype=np.float32),
        device=dev)
    index = ivf_flat_build(x, IVFFlatParams(n_lists=GIST_LISTS, seed=0),
                           device=dev)
    xd = torch.as_tensor(x, device=dev)
    true = exact_knn(xd, q, K)
    before = fk.LAUNCHES
    kernel0 = search_obs.scan_forms("ivf_flat", "kernel")
    engine_fallbacks("ivf_flat", reset=True)
    keep = []
    with scan_calls(keep) as shapes, rerank_path() as reranked:
        qcap = index.warmup(GIST_QUERIES, k=K, n_probes=N_PROBES)
        _, ids = ivf_flat_search_grouped(index, q, K, n_probes=N_PROBES,
                                         qcap=qcap)
    sync(dev)
    launches = fk.LAUNCHES - before
    reranks = rerank_path_entry(reranked, "GIST-width path", card)
    del reranked
    forms = search_obs.scan_forms("ivf_flat", "kernel") - kernel0
    wide, q_tile, smem = fk.scan_form(GIST_DIM, qcap)
    log(f"[{card}] wide rows: {GIST_ROWS} x {GIST_DIM}, {GIST_LISTS} lists "
        f"(max_list {index.storage.max_list}), qcap {qcap}: form "
        f"{'wide' if wide else 'resident'} (query tile {q_tile}, {smem} B "
        f"of shared memory), flat_scan_lists launched {launches} times by "
        f"(Q, Lpad) {dict(shapes)}; {forms} searches counted as kernel")
    check(wide, f"d={GIST_DIM} qcap {qcap} did not take the wide form")
    check(launches == 2 and forms == 2 and len(keep) == 2,
          f"{launches} launches, {forms} kernel searches for 2 searches")
    check(engine_fallbacks("ivf_flat") == 0,
          f"{engine_fallbacks('ivf_flat')} wide-row searches left the kernel")
    rel = (4 * GIST_DIM + 8) * 2.0 ** -24
    max_err = max(compare_lists_to_plain(call, rel) for call in keep)
    ms = cuda_time_ms(lambda *a: fk.flat_scan_lists(*a), [keep[-1]],
                      iters=10, warm=2)
    _, ids_legacy = ivf_flat_search_grouped(index, q, K, n_probes=N_PROBES,
                                            qcap=qcap, use_kernel=False)
    r_kernel, r_legacy = recall(ids, true), recall(ids_legacy, true)
    log(f"[{card}] wide rows: both launches within {rel:.3g} x (qn + yn) "
        f"of the plain version (max |kernel - plain| {max_err:.3g}); the "
        f"kernel {ms:.4f} ms at (lists, Q, d, Lpad) ({GIST_LISTS}, {qcap}, "
        f"{GIST_DIM}, {keep[-1][5]}); recall@10 kernel {r_kernel:.4f}, "
        f"legacy {r_legacy:.4f}")
    check(r_kernel >= r_legacy - 0.005,
          f"wide rows: kernel recall {r_kernel} below legacy {r_legacy}")
    return {"launches": launches, "max_abs_err": max_err, "ms": ms,
            "shape": [GIST_LISTS, qcap, GIST_DIM, keep[-1][5]],
            "recall": [r_kernel, r_legacy], "rerank_path": reranks}


# ---------------------------------------------------------------------------
# The open-loop ServingExecutor over the main path's IVF-Flat index
# ---------------------------------------------------------------------------

EXEC_KEPT = 20            # executor batches kept for the demux check
EXEC_REQUEST_SIZE = 16
EXEC_MIN_DURATION_S = 0.5
CACHE_REQUESTS = 200


class ExecutorCalls(list):
    """A keep list for :func:`kernel_calls` that keeps only the first
    ``n`` calls made in an executor's batcher thread."""

    def __init__(self, n):
        super().__init__()
        self.n = n

    def append(self, call):
        if (len(self) < self.n
                and threading.current_thread().name.endswith("-batcher")):
            super().append(call)


def traced_point(dispatch, pool, rate_rps, n_requests, seed, dev):
    """One executor at ``rate_rps`` requests/s of EXEC_REQUEST_SIZE rows,
    traced with torch.profiler's CUDA activity. Returns (wall s from the
    first submit to the last completion, device busy s — the union of
    the kernels' intervals — and the executor's stats)."""
    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch.obs import MetricRegistry
    from raft_tpu_torch.serving import ServingExecutor
    from raft_tpu_torch.testing.load import poisson_arrivals, replay
    from raft_tpu_torch.tools.profile_grouped import _busy_us

    sched = poisson_arrivals(rate_rps, n_requests, seed=seed,
                             sizes=EXEC_REQUEST_SIZE)
    rng = np.random.default_rng(seed)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with ServingExecutor(dispatch, BUCKETS, dim=DIM, device=dev,
                             registry=MetricRegistry()) as ex:
            t0 = time.perf_counter()
            futs, _, _ = replay(sched, lambda i, m: ex.submit(
                pool[rng.integers(0, pool.shape[0], m)]),
                clock=time.perf_counter)
            for f in futs:
                f.result(timeout=120)
            wall = time.perf_counter() - t0
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    check(kernels, "the executor trace holds no device time")
    busy = _busy_us([(e.time_range.start, e.time_range.end)
                     for e in kernels]) / 1e6
    return wall, busy, ex.stats()


class MergedE2E:
    """An executor's end-to-end latency over every bucket, as one
    histogram for ``ProfileTrigger``: ``counts_snapshot`` sums its
    buckets' ``serving_stage_ms{stage="e2e"}`` series."""

    def __init__(self, registry, executor, buckets):
        self.name = f"{executor}_e2e"
        self._hists = [registry.histogram(
            "serving_stage_ms", executor=executor, stage="e2e", bucket=b)
            for b in buckets]

    def counts_snapshot(self):
        return tuple(sum(c) for c in zip(*(h.counts_snapshot()
                                           for h in self._hists)))


TRIGGER_CHECK_S = 0.02     # the drain cadence the trigger is checked at
TRIGGER_RUN_S = 1.0        # seconds of traffic a round of the run sends
TRIGGER_MAX_RUNS = 8
TRIGGER_AFTER = 25         # checks after the capture that end the run


def trigger_point(dispatch, pool, rate_rps, threshold_ms, seed, dev, card):
    """A ``ProfileTrigger`` on the executor's end-to-end latency: an
    executor at ``rate_rps`` requests/s in rounds of TRIGGER_RUN_S until
    TRIGGER_AFTER checks followed the capture, ``check()`` every
    TRIGGER_CHECK_S, ``threshold_ms`` under the measured p50, 2
    consecutive windows, a 0.5 s capture, at most one.
    Exactly one capture must fire under load, its Chrome trace must hold
    CUDA events of ``flat_lists_kernel``, and the storm bound must hold
    through later breached windows. Returns the numbers."""
    import glob
    import shutil
    import tempfile

    from raft_tpu_torch.obs import MetricRegistry, ProfileTrigger
    from raft_tpu_torch.serving import ServingExecutor
    from raft_tpu_torch.testing.load import poisson_arrivals, replay

    reg = MetricRegistry()
    e2e = MergedE2E(reg, "trigger", BUCKETS)
    log_dir = tempfile.mkdtemp(prefix="profile_trigger_")
    trig = ProfileTrigger(e2e, threshold_ms=threshold_ms, log_dir=log_dir,
                          consecutive=2, capture_s=0.5, max_captures=1,
                          registry=reg)
    checks = []
    done, enough = threading.Event(), threading.Event()
    n_requests = max(128, int(TRIGGER_RUN_S * rate_rps))
    sched = poisson_arrivals(rate_rps, n_requests, seed=seed,
                             sizes=EXEC_REQUEST_SIZE)
    rng = np.random.default_rng(seed)
    client_error, sent = [], [0]

    def client(ex):
        # rounds of TRIGGER_RUN_S of traffic until the checks after the
        # capture are enough (the capture and its trace's export take
        # a while), at most TRIGGER_MAX_RUNS
        try:
            for _ in range(TRIGGER_MAX_RUNS):
                futs, _, _ = replay(sched, lambda i, m: ex.submit(
                    pool[rng.integers(0, pool.shape[0], m)]),
                    clock=time.perf_counter)
                for f in futs:
                    f.result(timeout=120)
                sent[0] += len(futs)
                if enough.is_set():
                    break
        except Exception as e:  # noqa: BLE001 — reported below
            client_error.append(repr(e))
        finally:
            done.set()

    # the checks (and so the capture) run on this thread: the profiler
    # starts where the process registered it; the traffic comes from
    # another
    with ServingExecutor(dispatch, BUCKETS, dim=DIM, device=dev,
                         registry=reg, name="trigger") as ex:
        th = threading.Thread(target=client, args=(ex,),
                              name="trigger-client")
        t0 = time.perf_counter()
        th.start()
        fire_t = None
        while not done.wait(TRIGGER_CHECK_S):
            t = time.perf_counter()
            fired = trig.check()
            checks.append((t, fired, trig._breaches, time.perf_counter()))
            if fired is not None:
                fire_t = t
            elif fire_t is not None and sum(
                    1 for c in checks if c[0] > fire_t) >= TRIGGER_AFTER:
                enough.set()
        wall = time.perf_counter() - t0
        th.join(120)
    errors_seen = client_error
    check(not errors_seen, f"the triggered run's client raised {errors_seen}")
    fired = [(t, p, t1 - t) for t, p, _, t1 in checks if p is not None]
    check(len(fired) == 1 and trig.captures == 1,
          f"{len(fired)} profile captures under load (want exactly 1)")
    after = [b for t, p, b, _ in checks if t > fired[0][0]]
    files = glob.glob(os.path.join(log_dir, "trace_*.json"))
    check(len(files) == 1, f"{len(files)} Chrome traces written")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    flat = [e for e in kernels if "flat_lists_kernel" in e.get("name", "")]
    check(flat, "the captured trace holds no flat_lists_kernel event")
    # the storm bound: later windows breached again, and nothing fired
    rebreached = max(after) if after else 0
    shutil.rmtree(log_dir, ignore_errors=True)
    nums = dict(threshold_ms=threshold_ms, checks=len(checks),
                capture_at_s=fired[0][0] - t0, capture_s=fired[0][2],
                wall_s=wall,
                trace_kernel_events=len(kernels),
                flat_lists_events=len(flat), checks_after=len(after),
                max_breaches_after=rebreached, requests=sent[0])
    log(f"[{card}] ProfileTrigger on the executor's e2e latency (threshold "
        f"{threshold_ms:.3f} ms, under the p50; 2 windows of "
        f"{1e3 * TRIGGER_CHECK_S:.0f} ms): one capture at "
        f"{nums['capture_at_s']:.3f} s, taking {nums['capture_s']:.3f} s "
        f"with the trace's export, of a {wall:.2f} s run "
        f"({sent[0]} requests), its Chrome trace {len(kernels)} CUDA "
        f"kernel events, {len(flat)} of flat_lists_kernel; {len(after)} "
        f"later checks, up to {rebreached} consecutive breached windows "
        "again, no second capture")
    check(rebreached >= 2, "no later window breached twice: the storm "
          "bound was not exercised")
    return nums


def executor_phase(args, card, dev, index, qcaps, x):
    """The open-loop ServingExecutor over the main path's index: the
    open-loop row (saturation, p50/p99 at fractions of it, sheds, stage
    quantiles), with no host sync inside any executor dispatch; 20 kept
    batches demuxed bitwise equal to a direct search of the same batch;
    accounting that adds up; one flat_scan_lists launch per search, each
    kept launch equal to its plain version; a traced run at 0.95 of
    saturation for the device's idle share; and a result-cache pass."""
    from raft_tpu_torch.serving import STAGES
    from raft_tpu_torch.serving.open_loop import open_loop_row
    from raft_tpu_torch.spatial.ann import flat_kernel as fk
    from raft_tpu_torch.spatial.ann import ivf_flat_search_grouped

    rng = np.random.default_rng(args.seed + 8)
    pool = (x[rng.integers(0, N_ROWS, 8192)]
            + 0.3 * rng.standard_normal((8192, DIM), dtype=np.float32))

    def search(q):
        return ivf_flat_search_grouped(index, q, K, n_probes=N_PROBES,
                                       qcap=qcaps[q.shape[0]])

    kept, calls, exec_sizes = [], collections.Counter(), []
    # the row's point whose requests are being submitted: batches are
    # kept from the two saturation runs ("sat", "sat_off") only, whose
    # requests are recorded by point (the two runs send the same rows;
    # one run alone kept 19 batches on a slow host). A point's executor
    # is closed before the next point submits, so a batch's point is the
    # one current at its dispatch.
    point = {"now": None}
    saturation = ("sat", "sat_off")

    def make_run(bucket):
        def run(q):
            if not threading.current_thread().name.endswith("-batcher"):
                calls["direct"] += 1
                return search(q)
            calls["executor"] += 1
            exec_sizes.append(q.shape[0])
            # every sync inside the dispatch warns (recorded below)
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                d, i = search(q)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
            if point["now"] in saturation and len(kept) < EXEC_KEPT:
                kept.append((point["now"], q.clone(), d.clone(),
                             i.clone()))
            return d, i
        return run

    recorded = {}

    def on_submit(at, rows, fut):
        point["now"] = at
        if at in saturation:
            recorded[at, rows[0].tobytes()] = (rows, fut)

    fk.LAUNCHES = 0
    engine_fallbacks("ivf_flat", reset=True)
    keep = ExecutorCalls(EXEC_KEPT)
    t0 = time.perf_counter()
    with scan_calls(keep), warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        row = open_loop_row(
            make_run, pool, buckets=BUCKETS,
            request_size=EXEC_REQUEST_SIZE, fracs=(0.5, 0.8, 0.95),
            flush_age_s=0.002, max_in_flight=4,
            min_duration_s=EXEC_MIN_DURATION_S, device=dev,
            on_submit=on_submit)
    launches = fk.LAUNCHES
    row_s = time.perf_counter() - t0
    check("error" not in row, f"open-loop row: {row.get('error')}")
    tot = row["totals"]
    log(f"[{card}] open-loop row ({row_s:.1f} s): program "
        f"{row['program_qps']:.0f} queries/s (bucket {row['nq']}, spread "
        f"{row['spread']}), saturation {row['saturation_qps']:.0f} "
        f"queries/s, {row['qps_ratio_vs_program']:.3f} x program, registry "
        f"off/on {row.get('obs_overhead_pct')}% overhead")
    for tag in ("sat", "50", "80", "95"):
        lat = ("" if tag == "sat" else
               f"p50 {row.get(f'p50_ms_{tag}')} ms, p99 "
               f"{row.get(f'p99_ms_{tag}')} ms, achieved "
               f"{row.get(f'achieved_qps_{tag}')} queries/s, ")
        log(f"[{card}] open loop at {tag}: {lat}shed "
            f"{row[f'n_shed_{tag}']}, pad_fraction "
            f"{row[f'pad_fraction_{tag}']}; stage p50 ms "
            f"{row[f'stage_p50_ms_{tag}']}; stage p99 ms "
            f"{row[f'stage_p99_ms_{tag}']}")
    log(f"open-loop totals: {tot}")
    # torch's sync debug mode warns "called a synchronizing CUDA
    # operation" at each sync it detects (not every kind, it says)
    syncs = collections.Counter(
        f"{w.filename}:{w.lineno}" for w in warned
        if "called a synchronizing" in str(w.message))
    for where, n in syncs.items():
        log(f"host sync inside an executor dispatch ({n}x): {where}")
    check(not syncs, f"{len(syncs)} host syncs inside executor dispatches")
    log(f"executor dispatches: {calls['executor']} batches under "
        "torch.cuda.set_sync_debug_mode('warn'), no host sync detected")
    check(set(row["stage_p50_ms_95"]) == set(STAGES),
          f"stage histograms {row['stage_p50_ms_95']}")
    check(tot["submitted"] == tot["completed"] + tot["failed"]
          and tot["failed"] == 0,
          f"executor accounting: {tot}")
    check(tot["valid_rows"] == tot["rows_accepted"],
          f"valid rows {tot['valid_rows']} != rows accepted "
          f"{tot['rows_accepted']}")
    check(sum(exec_sizes) == tot["valid_rows"] + tot["padded_rows"]
          and len(exec_sizes) == tot["batches"] == calls["executor"],
          f"executor batches {len(exec_sizes)} ({sum(exec_sizes)} rows) "
          f"against {tot}")

    # one flat_scan_lists launch per search (executor batches, warmups
    # and the program chain), no fallback, kept launches = plain version
    log(f"executor path: flat_scan_lists launched {launches} times for "
        f"{calls['executor']} executor batches and {calls['direct']} "
        "direct searches")
    check(launches == calls["executor"] + calls["direct"],
          "flat_scan_lists launches != searches")
    check(engine_fallbacks("ivf_flat") == 0,
          f"{engine_fallbacks("ivf_flat")} executor searches left the kernel")
    torch.cuda.synchronize()
    check(len(keep) == EXEC_KEPT, f"kept {len(keep)} executor launches")
    max_err = max(compare_lists_to_plain(call) for call in keep)
    log(f"kernel check on the executor path: the first {len(keep)} "
        "executor flat_scan_lists calls within 1e-5 x (qn + yn) of the "
        f"plain version, max |kernel - plain| {max_err:.3g}")
    del keep

    # demux: every request of a kept batch got exactly its rows of that
    # batch's output, and a direct search of the batch gives the same
    check(len(kept) == EXEC_KEPT, f"kept {len(kept)} executor batches")
    n_req = 0
    for at, staged, d, i in kept:
        rd, ri = search(staged)
        check(torch.equal(rd, d) and torch.equal(ri, i),
              "a direct search of a kept batch differs from its dispatch")
        host = staged.cpu().numpy()
        d, i = d.cpu().numpy(), i.cpu().numpy()
        o = 0
        while o < host.shape[0] and (at, host[o].tobytes()) in recorded:
            rows, fut = recorded[at, host[o].tobytes()]
            m = rows.shape[0]
            check(np.array_equal(host[o:o + m], rows),
                  "a request's rows are not contiguous in its batch")
            got_d, got_i = fut.result(timeout=60)
            check(got_d.shape == (m, K) and got_i.shape == (m, K),
                  f"demuxed {got_d.shape} for a {m}-row request")
            check(got_d.tobytes() == d[o:o + m].tobytes()
                  and got_i.tobytes() == i[o:o + m].tobytes(),
                  "demuxed rows differ from the batch's rows")
            o += m
            n_req += 1
        check(o > 0 and not host[o:].any(),
              "a kept batch holds rows of no recorded request")
    log(f"demux check: {n_req} requests of the first {len(kept)} executor "
        "batches bitwise equal to their rows of the batch and of a "
        "direct search; no padded row surfaced")
    del kept, recorded

    # where the device time goes at 0.95 of saturation
    rate = 0.95 * row["saturation_qps"] / EXEC_REQUEST_SIZE
    wall, busy, st = traced_point(lambda b, **_: search(b), pool, rate,
                                  max(256, int(0.5 * rate)),
                                  args.seed + 95, dev)
    log(f"[{card}] traced executor at 0.95 of saturation: "
        f"{st.completed} requests in {st.batches} batches (pad_fraction "
        f"{st.pad_fraction:.3f}), wall {1e3 * wall:.1f} ms, device busy "
        f"{1e3 * busy:.1f} ms, idle {1 - busy / wall:.1%}")

    trigger_point(lambda b, **_: search(b), pool, rate,
                  0.5 * row["p50_ms_95"], args.seed + 96, dev, card)

    result_cache_pass(card, dev, search, pool)


def result_cache_pass(card, dev, search, pool):
    """CACHE_REQUESTS requests served twice through an executor with a
    ResultCache whose VectorCache tiers live on the card. Before the
    second pass the host L1 front is emptied, so every hit of that pass
    comes from the exact tier on the card (its probe, the copy back, the
    signature and epoch checks). The second pass sends each request
    whose rows all stayed in the tier (a set that overflows its ways
    evicts the rest): each must be answered from it at submit, with no
    batch, every row bitwise equal to the first pass's last fill of that
    row."""
    from raft_tpu_torch.obs import MetricRegistry
    from raft_tpu_torch.serving import ResultCache, ServingExecutor
    from raft_tpu_torch.serving.result_cache import _fold_key

    rng = np.random.default_rng(7)
    reqs = [pool[s:s + int(m)] for s, m in zip(
        rng.integers(0, pool.shape[0] - 16, CACHE_REQUESTS),
        rng.integers(1, 17, CACHE_REQUESTS))]
    cache = ResultCache(K, device=dev, registry=MetricRegistry())
    check(cache._exact.keys.device.type == dev.type,
          "the result cache's VectorCache is not on the card")
    n_rows = sum(r.shape[0] for r in reqs)
    # the exact tier keeps one entry a row, so a row that two requests
    # share holds the answer of the later fill (the two batches may have
    # dropped different probes): a tier hit is held against the last
    # fill of each of its rows
    last_fill = {}
    real_insert = cache.insert

    def insert(rows, dists, ids, **kw):
        for sig, d, i in zip(cache.signatures(rows), dists, ids):
            last_fill[sig.tobytes()] = (d.tobytes(), i.tobytes())
        return real_insert(rows, dists, ids, **kw)

    cache.insert = insert

    def serve(batch_reqs):
        # closing the executor waits for its cache fills, so every fill
        # of the pass has landed when it returns; a future already done
        # when submit returns was answered by the cache
        with ServingExecutor(lambda b, **_: search(b), BUCKETS, dim=DIM,
                             device=dev, result_cache=cache,
                             registry=MetricRegistry()) as ex:
            futs, at_submit = [], []
            for r in batch_reqs:
                futs.append(ex.submit(r))
                at_submit.append(futs[-1].done())
            out = [f.result(timeout=120) for f in futs]
        return out, at_submit, ex.stats()

    t0 = time.perf_counter()
    first, _, st1 = serve(reqs)
    t1 = time.perf_counter()
    tier_keys = set(cache._exact.keys.cpu().numpy().ravel().tolist())
    kept = [i for i, r in enumerate(reqs)
            if set(_fold_key(cache.signatures(r)[:, 0]).tolist())
            <= tier_keys]
    evicted = CACHE_REQUESTS - len(kept)
    with cache._lock:
        cache._l1.clear()
    before = cache.stats()
    t2 = time.perf_counter()
    second, hit, st = serve([reqs[i] for i in kept])
    t3 = time.perf_counter()
    cs = cache.stats()
    served = [(sig.tobytes(), (d.tobytes(), i.tobytes()), own)
              for j, b in zip(kept, second)
              for sig, d, i, own in zip(
                  cache.signatures(reqs[j]), b[0], b[1],
                  zip(first[j][0], first[j][1]))]
    same = all(last_fill.get(sig) == got for sig, got, _ in served)
    shared = sum(got != (d.tobytes(), i.tobytes())
                 for _, got, (d, i) in served)
    tier_rows = sum(reqs[i].shape[0] for i in kept)
    log(f"[{card}] result-cache pass: {CACHE_REQUESTS} requests ({n_rows} "
        f"rows) in {1e3 * (t1 - t0):.1f} ms ({st1.batches} batches, "
        f"{st1.cache_hits} cache hits, {st1.coalesced_requests} "
        f"coalesced); {evicted} requests lost a row to the exact tier's "
        f"evictions; L1 front emptied, the other {len(kept)} again in "
        f"{1e3 * (t3 - t2):.1f} ms ({st.batches} batches, "
        f"{st.cache_hits} cache hits, {sum(hit)} answered at submit, "
        f"{cs.hits - before.hits} row hits of {tier_rows} rows, from the "
        f"exact tier on the card); cache misses {cs.misses}, stale "
        f"{cs.stale}, inserts {cs.inserts}; every row bitwise equal to "
        f"the last fill of that row in the first pass: {same} ({shared} "
        f"rows carry the later fill of another request sharing the row, "
        f"the rest the request's own answer)")
    check(same, "answers from the exact tier differ from the rows the "
          "first pass filled in")
    check(all(hit) and st.batches == 0,
          "a request whose rows all sit in the exact tier was dispatched")
    check(st.cache_hits == len(kept),
          f"cache hits {st.cache_hits} != {CACHE_REQUESTS} - {evicted}")
    check(cs.hits - before.hits >= tier_rows,
          f"exact-tier row hits {cs.hits - before.hits} < {tier_rows}")
    for pass_st in (st1, st):
        check(pass_st.submitted == pass_st.completed + pass_st.failed
              and pass_st.failed == 0,
              f"result-cache executor accounting: {pass_st}")


# ---------------------------------------------------------------------------
# The mutation tier over the main path's IVF-Flat index
# ---------------------------------------------------------------------------

MUT_CAP = 64              # the mixed-ingest row's delta capacity
MUT_INGEST = 256          # rows an upsert batch / ingest dispatch carries
MUT_DEAD_FRAC = 0.10      # main rows tombstoned (below the policy's 0.25)
MUT_DELETE_BATCH = 8192   # ids a delete batch carries
DURABLE_BATCHES, DURABLE_BATCH = 24, 128
KILL_POINTS = (1, 5, 17)
# the mutation phase's write script and 4,096 batch (fresh rows, dead ids,
# queries, the survivors' oracle, recall), repeated by the sharded
# mutation step on the sharded index
MUTATION_SCRIPT = {}


@contextlib.contextmanager
def engine_batches(masked):
    """Record, for every IVF-Flat kernel-engine call of the grouped body
    with a tombstone mask (``masked``: the mutable searches) or without
    one (the frozen index's), the flat-scan launches it made."""
    with body_calls(lambda e, kw: (e.name == "ivf_flat" and e.kernel and (
            kw.get("row_mask") is not None) == masked),
            lambda args, kw, added, n: n) as launches:
        yield launches


def dyadic_rows(x, rng, m):
    """Noisy copies of corpus rows rounded to multiples of 1/16: their
    squares and dot products are exact in f32, so a row searched against
    itself scores exactly 0."""
    rows = (x[rng.integers(0, x.shape[0], m)]
            + 0.3 * rng.standard_normal((m, x.shape[1]), dtype=np.float32))
    return np.round(rows * 16.0) / 16.0


def mutable_state_tensors(m):
    """Every tensor of a MutableIndex under its archive key."""
    from raft_tpu_torch.spatial.ann import interop

    out = {}

    def walk(obj, prefix):
        for name in interop._FIELDS[type(obj)]:
            v = getattr(obj, name)
            if type(v) in interop._FIELDS:
                walk(v, prefix + name + ".")
            elif isinstance(v, torch.Tensor):
                out[prefix + name] = v
    walk(m, "")
    return out


def mutation_phase(args, card, dev, index, qcaps, x):
    """The mutation tier over the main path's 1M-row index: upsert ->
    visible and delete -> masked on both engines, recall on the survivors
    against an exact oracle, no host sync inside a mutable search or the
    async upsert, the mixed-ingest row, compaction and one background
    compaction cycle under searches, an executor whose cached answer goes
    stale after a write, the durable-ingest row, checkpoint + WAL-tail
    recovery and the v4 archive bitwise, and the kill-9 fast leg. Returns
    the phase's entry under the flat scan's ``mutation`` key."""
    import tempfile

    from raft_tpu_torch.durability import wal
    from raft_tpu_torch.obs import MetricRegistry
    from raft_tpu_torch.serving import ResultCache, ServingExecutor
    from raft_tpu_torch.serving.ingest_rows import (
        durable_ingest_row, mixed_ingest_row,
    )
    from raft_tpu_torch.spatial.ann import flat_kernel as fk
    from raft_tpu_torch.spatial.ann import interop
    from raft_tpu_torch.spatial.ann import ivf_flat_search_grouped
    from raft_tpu_torch.spatial.ann import mutation as mut
    from raft_tpu_torch.testing.crash import run_crash_ingest_cycle

    rng = np.random.default_rng(args.seed + 10)
    nums = {"card": card}

    def search(m, q, engine=None):
        return mut.mutable_search(m, q, K, n_probes=N_PROBES,
                                  qcap=qcaps.get(q.shape[0]),
                                  use_kernel=engine)

    def timed(fn, n=5):
        fn()
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        sync(dev)
        return 1e3 * (time.perf_counter() - t0) / n, out

    fk.LAUNCHES = 0
    engine_fallbacks("ivf_flat", reset=True)
    with engine_batches(True) as mut_calls, \
            engine_batches(False) as frozen_calls:
        t0 = time.perf_counter()
        m0 = mut.wrap_mutable(index, delta_cap=MUT_CAP)
        for b in BUCKETS:
            check(mut.mutable_warmup(m0, b, k=K, n_probes=N_PROBES,
                                     qcap=qcaps[b], ingest_batch=MUT_INGEST)
                  == qcaps[b], "mutable_warmup changed a bucket's qcap")
        check(int(m0.delta.counts.sum()) == 0 and m0.epoch == 0
              and bool((m0.row_mask > 0).all()),
              "mutable_warmup consumed delta slots or flipped the mask")
        nums["wrap_warmup_s"] = time.perf_counter() - t0

        # upsert -> visible: every acked row its own top-1 at distance 0
        fresh = dyadic_rows(x, rng, MUT_INGEST)
        fresh_ids = np.arange(N_ROWS, N_ROWS + MUT_INGEST, dtype=np.int32)
        sync(dev)
        t0 = time.perf_counter()
        m, acc = mut.upsert(m0, fresh, fresh_ids)
        nums["upsert_256_ms"] = 1e3 * (time.perf_counter() - t0)
        check(acc.all() and m.epoch == 1, f"upsert acked {acc.sum()} of "
              f"{MUT_INGEST} rows")
        # the same rows in 2 x 128: the same state (routing goes through
        # the index's canonical table, whatever the GEMM's rounding)
        half = MUT_INGEST // 2
        m2, acc2 = mut.upsert(m0, fresh[:half], fresh_ids[:half])
        m2, acc3 = mut.upsert(m2, fresh[half:], fresh_ids[half:])
        check(acc2.all() and acc3.all() and all(
            torch.equal(getattr(m.delta, f), getattr(m2.delta, f))
            for f in ("vecs", "ids", "live", "counts"))
            and torch.equal(m.row_mask, m2.row_mask),
            "upserts in 2 x 128 left another state than one batch of 256")
        del m2
        nums["routing_witness"], nums["routed_apart"] = routing_witness(
            index.centroids, fresh, half, card, "single-device")
        fresh_t = torch.as_tensor(fresh, device=dev)
        for engine in (None, False):
            d, i = search(m, fresh_t, engine)
            check(torch.equal(i[:, 0].cpu(), torch.as_tensor(fresh_ids))
                  and bool((d[:, 0] == 0).all()),
                  f"engine {engine}: an acked row is not its own top-1 at 0")

        # delete -> masked: 10% of the main rows and a quarter of the fresh
        dead_main = np.sort(rng.choice(N_ROWS, int(MUT_DEAD_FRAC * N_ROWS),
                                       replace=False)).astype(np.int32)
        dead_fresh = fresh_ids[::4]
        dead = np.concatenate([dead_main, dead_fresh])
        sync(dev)
        t0 = time.perf_counter()
        for s in range(0, dead.shape[0], MUT_DELETE_BATCH):
            m, found = mut.delete(m, dead[s:s + MUT_DELETE_BATCH])
            check(found.all(), "a delete missed a live id")
        nums["delete_ms"] = 1e3 * (time.perf_counter() - t0)
        stats = mut.compaction_stats(m)
        check(abs(stats["tombstone_frac"] - MUT_DEAD_FRAC) < 1e-6
              and stats["delta_live_rows"] == MUT_INGEST - dead_fresh.size,
              f"compaction stats {stats}")

        # the 4,096 batch: no dead id, recall against the survivors
        qb = torch.as_tensor(
            x[rng.integers(0, N_ROWS, max(BUCKETS))]
            + 0.3 * rng.standard_normal((max(BUCKETS), DIM),
                                        dtype=np.float32), device=dev)
        live_main = np.setdiff1d(np.arange(N_ROWS, dtype=np.int32),
                                 dead_main)
        live_fresh = np.setdiff1d(fresh_ids, dead_fresh)
        surv_ids = torch.as_tensor(np.concatenate([live_main, live_fresh]),
                                   device=dev)
        surv = torch.cat([torch.as_tensor(x[live_main], device=dev),
                          torch.as_tensor(fresh[live_fresh - N_ROWS],
                                          device=dev)])
        true = surv_ids[exact_knn(surv, qb, K)]
        del surv
        res = {}
        for name, engine in (("kernel", None), ("legacy", False)):
            ms, (d, i) = timed(lambda: search(m, qb, engine), n=3)
            check(not np.isin(i.cpu().numpy(), dead).any(),
                  f"{name} engine surfaced a deleted id")
            res[name] = (recall(i, true), ms)
        nums.update({f"recall_{n}": r for n, (r, _) in res.items()})
        nums.update({f"batch4096_{n}_ms": t for n, (_, t) in res.items()})
        check(res["kernel"][0] >= res["legacy"][0] - 0.005,
              f"kernel recall below legacy on the survivors: {res}")
        MUTATION_SCRIPT.update(
            fresh=fresh, fresh_ids=fresh_ids, dead=dead,
            dead_fresh=dead_fresh, qb=qb, true=true,
            recall={n: r for n, (r, _) in res.items()})
        nums["batch4096_frozen_ms"], _ = timed(
            lambda: ivf_flat_search_grouped(index, qb, K, n_probes=N_PROBES,
                                            qcap=qcaps[max(BUCKETS)]), n=3)
        nums["batch8_kernel_ms"], _ = timed(lambda: search(m, qb[:8]))
        nums["batch8_frozen_ms"], _ = timed(
            lambda: ivf_flat_search_grouped(index, qb[:8], K,
                                            n_probes=N_PROBES,
                                            qcap=qcaps[8]))
        # the dense delta scan and fold alone, at both sizes
        nl = m.delta.ids.shape[0]
        dids = m.delta.ids.reshape(-1)
        valid = (dids >= 0) & (m.delta.live.reshape(-1) > 0)
        dvec = m.delta.vecs.reshape(nl * MUT_CAP, DIM)
        for nq in (8, max(BUCKETS)):
            vals = torch.full((nq, K), float("inf"), device=dev)
            ids = torch.full((nq, K), -1, dtype=torch.int32, device=dev)
            nums[f"delta_scan{nq}_ms"], _ = timed(
                lambda: mut.delta_merge_topk(qb[:nq], vals, ids, dvec, dids,
                                             valid, K))

        # no host sync inside a mutable search dispatch or the async upsert
        ing_ids = torch.arange(2_000_000, 2_000_000 + MUT_INGEST,
                               dtype=torch.int32, device=dev)
        prev = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for b in BUCKETS:
                    search(m, qb[:b])
                mut._upsert_impl(index.centroids, m.delta, m.row_mask,
                                 m.id_to_pos, fresh_t, ing_ids, m.canon)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        syncs = collections.Counter(
            f"{w.filename}:{w.lineno}" for w in warned
            if "called a synchronizing" in str(w.message))
        for where, n in syncs.items():
            log(f"host sync inside a mutable dispatch ({n}x): {where}")
        check(not syncs, f"{len(syncs)} host syncs inside mutable dispatches")

        # the mixed-ingest row (recorded, not gated)
        t0 = time.perf_counter()
        row = mixed_ingest_row(index, qb[:512], k=K, n_probes=N_PROBES,
                               ingest_batch=MUT_INGEST, delta_cap=MUT_CAP)
        nums["mixed_row_s"] = time.perf_counter() - t0
        nums["mixed_row"] = {key: row.get(key) for key in (
            "frozen_qps", "ingest_qps", "mixed_search_qps",
            "qps_ratio_vs_frozen", "upsert_visible_ms", "delete_masked_ms",
            "spread", "error")}

        # compaction, then one background cycle under searches
        sync(dev)
        t0 = time.perf_counter()
        mc, cst = mut.compact(m)
        sync(dev)
        nums["compact_s"] = time.perf_counter() - t0
        want = N_ROWS - dead_main.size + live_fresh.size
        check(cst["survivors"] == want
              and int(mc.delta.counts.sum()) == 0
              and bool((mc.row_mask > 0).all()) and mc.epoch == m.epoch + 1,
              f"compaction: survivors {cst['survivors']} (want {want}), "
              f"stats {cst}")
        d, i = search(mc, qb)
        r_after = recall(i, true)
        nums["recall_kernel_after_compact"] = r_after
        check(not np.isin(i.cpu().numpy(), dead).any(),
              "a deleted id surfaced after compaction")
        check(abs(r_after - res["kernel"][0]) <= 0.005,
              f"recall after compaction {r_after} vs {res['kernel'][0]}")
        more = dyadic_rows(x, rng, MUT_INGEST)
        more_ids = np.arange(N_ROWS + MUT_INGEST, N_ROWS + 2 * MUT_INGEST,
                             dtype=np.int32)
        m2, acc = mut.upsert(mc, more, more_ids)
        check(acc.all(), "upsert into the compacted state rejected rows")
        bc = mut.BackgroundCompactor(mut.CompactionPolicy(refresh_every=0))
        t0 = time.perf_counter()
        check(bc.submit(m2), "the background compactor refused a submit")
        during = 0
        while True:
            busy = bc.busy
            search(m2, qb[:512])
            sync(dev)
            during += busy
            if not busy:
                break
        bc.join(120.0)
        polled = bc.poll()
        bc.stop()
        nums["background_compact_s"] = time.perf_counter() - t0
        nums["searches_during_compaction"] = during
        check(polled is not None and during >= 1,
              f"background compaction: result {polled is not None}, "
              f"{during} searches while it ran")
        m3, bst = polled
        check(bst["survivors"] == want + MUT_INGEST,
              f"background compaction survivors {bst['survivors']}")
        d, i = search(m3, torch.as_tensor(more, device=dev))
        check(torch.equal(i[:, 0].cpu(), torch.as_tensor(more_ids)),
              "rows folded by the background compaction are not found")

        # serve under writes: a cached answer goes stale after an upsert
        cache = ResultCache(K, registry=MetricRegistry())
        state = {"m": m3}
        req = qb[:4].cpu().numpy()
        with ServingExecutor(lambda b, **_: search(state["m"], b), BUCKETS,
                             dim=DIM, device=dev, result_cache=cache,
                             epoch_fn=lambda: state["m"].epoch,
                             registry=MetricRegistry()) as ex:
            first = ex.submit(req).result(timeout=60)
            again = ex.submit(req)
            hit = again.done()
            again.result(timeout=60)
            stale0 = cache.stats().stale
            state["m"], acc = mut.upsert(state["m"], req[:1],
                                         np.asarray([3_000_000], np.int32))
            ex.set_runtime()
            served = ex.submit(req).result(timeout=60)
            stale1 = cache.stats().stale
        check(acc.all() and hit, f"cache hit before the write: {hit}")
        check(stale1 > stale0, f"cache stale count {stale0} -> {stale1}")
        check(int(served[1][0, 0]) == 3_000_000
              and int(first[1][0, 0]) != 3_000_000,
              "the answer served after the write lacks the new row")
        nums["cache_stale"] = stale1 - stale0

        # durability: the durable-ingest row, checkpoint + WAL tail
        # recovery, the v4 archive, the kill-9 fast leg
        t0 = time.perf_counter()
        drow = durable_ingest_row(index, qb[:DURABLE_BATCH],
                                  ingest_batch=DURABLE_BATCH,
                                  n_batches=DURABLE_BATCHES,
                                  delta_cap=MUT_CAP)
        nums["durable_row_s"] = time.perf_counter() - t0
        nums["durable_row"] = {key: drow[key] for key in (
            "nondurable_qps", "durable_qps", "durability_ratio",
            "fsync_interval_ms", "fsync_p50_ms", "wal_mb_per_s")}
        with tempfile.TemporaryDirectory() as td:
            w = wal.WalWriter(f"{td}/wal", flush_interval_s=0.002)
            ing = wal.DurableIngest(mut.wrap_mutable(index, delta_cap=MUT_CAP),
                                    w)
            n_ops, wm = 0, None
            for b in range(8):
                ids = np.arange(4_000_000 + b * DURABLE_BATCH,
                                4_000_000 + (b + 1) * DURABLE_BATCH,
                                dtype=np.int32)
                check(ing.upsert(dyadic_rows(x, rng, DURABLE_BATCH),
                                 ids).all(), "a durable upsert was rejected")
                found = ing.delete(np.concatenate([
                    rng.choice(N_ROWS, 64, replace=False).astype(np.int32),
                    ids[:8]]))
                check(found[64:].all(), "a durable delete missed")
                n_ops += 2
                if b == 3:
                    wm = ing.checkpoint(f"{td}/delta.ckpt")
            live = ing.mindex
            ing.close()
            fresh = mut.wrap_mutable(index, delta_cap=MUT_CAP)
            t0 = time.perf_counter()
            rec, frontier, n = wal.recover_mutable(
                fresh, f"{td}/wal", checkpoint_path=f"{td}/delta.ckpt")
            sync(dev)
            nums["recover_s"] = time.perf_counter() - t0
            check(wm == 8 and (frontier, n) == (n_ops, n_ops - wm),
                  f"recovery: watermark {wm}, frontier {frontier}, "
                  f"replayed {n}")
            a, b_ = mutable_state_tensors(live), mutable_state_tensors(rec)
            check(all(torch.equal(a[key], b_[key]) for key in a),
                  "the recovered state differs from the live state")
            # the epoch counts on from the fresh wrap's, as the JAX
            # package's replay does: every replayed write applied (its
            # rows accepted or found), and each applied write advances
            # the epoch by one
            check(rec.epoch == fresh.epoch + n and live.epoch == n_ops,
                  f"recovered epoch {rec.epoch}, fresh {fresh.epoch} + "
                  f"{n} replayed; live {live.epoch}")
            nums["recovered_epoch"], nums["live_epoch"] = rec.epoch, live.epoch
            for x0, x1 in zip(search(live, qb), search(rec, qb)):
                check(torch.equal(x0, x1),
                      "the recovered state answers differently")
            t0 = time.perf_counter()
            interop.save_index(live, f"{td}/m.npz")
            loaded = interop.load_index(f"{td}/m.npz", device=dev)
            sync(dev)
            nums["v4_roundtrip_s"] = time.perf_counter() - t0
            nums["v4_archive_mb"] = os.path.getsize(f"{td}/m.npz") / 1e6
            b_ = mutable_state_tensors(loaded)
            check(set(a) == set(b_) and all(
                a[key].device.type == dev.type
                and torch.equal(a[key], b_[key].to(a[key].device))
                for key in a), "the v4 archive round trip is not bitwise")
            del live, rec, loaded
            t0 = time.perf_counter()
            for j, after in enumerate(KILL_POINTS):
                r = run_crash_ingest_cycle(
                    f"{td}/kill{j}", kill_after_acks=after, n_records=40,
                    d=8, seed=20 + j)
                check(r["returncode"] == -9 and len(r["acked"]) == after
                      and set(r["acked"]) <= set(r["recovered"]),
                      f"kill-9 at {after} acks: {r['returncode']}, acked "
                      f"{len(r['acked'])}, recovered {len(r['recovered'])}")
            nums["kill9_s"] = time.perf_counter() - t0
    launches = fk.LAUNCHES
    check(all(n == 1 for n in mut_calls + frozen_calls),
          f"flat-scan launches per kernel-engine search "
          f"{collections.Counter(mut_calls + frozen_calls)} (one expected)")
    check(launches == len(mut_calls) + len(frozen_calls),
          f"flat_scan_lists launched {launches} times for "
          f"{len(mut_calls)} mutable and {len(frozen_calls)} frozen "
          "kernel-engine searches")
    check(engine_fallbacks("ivf_flat") == 0,
          f"{engine_fallbacks("ivf_flat")} mutation-phase searches left the "
          "kernel")
    nums.update(launches=launches, mutable_searches=len(mut_calls),
                frozen_searches=len(frozen_calls), engine_fallbacks=0)
    log(f"[{card}] mutation phase: " + json.dumps(nums))
    return nums


def mutable_quantized(kind, index, x, qb, dev, card):
    """The mutation tier on a quantized index: upsert 256 rows, in one
    batch and in 2 x 128 to the same state (the C3 check, with
    :func:`routing_witness`, where capped lists split), delete 10%, a
    4,096 batch on both engines (no deleted id), the fresh rows found as
    their own top-1, one compaction. Returns its numbers and the
    kernel-engine searches it ran."""
    from raft_tpu_torch.spatial.ann import mutation as mut

    rng = np.random.default_rng(17)
    kw = {"refine_ratio": PQ_REFINE} if kind == "pq" else {}

    def search(m, q, engine=None):
        return mut.mutable_search(m, q, K, n_probes=QZ_PROBES,
                                  qcap="throughput", use_kernel=engine, **kw)

    nums, n_kernel = {}, 0
    m0 = mut.wrap_mutable(index, delta_cap=MUT_CAP)
    fresh = dyadic_rows(x, rng, MUT_INGEST)
    fresh_ids = np.arange(QZ_ROWS, QZ_ROWS + MUT_INGEST, dtype=np.int32)
    m, acc = mut.upsert(m0, fresh, fresh_ids)
    check(acc.all(), f"{kind}: upsert acked {acc.sum()} of {MUT_INGEST}")
    # the same rows in 2 x 128 on this index, whose capped lists were
    # split into pieces sharing their parent's centroid: the same state
    half = MUT_INGEST // 2
    m2, acc2 = mut.upsert(m0, fresh[:half], fresh_ids[:half])
    m2, acc3 = mut.upsert(m2, fresh[half:], fresh_ids[half:])
    check(acc2.all() and acc3.all() and all(
        torch.equal(getattr(m.delta, f), getattr(m2.delta, f))
        for f in ("vecs", "ids", "live", "counts"))
        and torch.equal(m.row_mask, m2.row_mask),
        f"{kind}: upserts in 2 x 128 left another state than one batch "
        "of 256")
    del m0, m2
    nums["routing_witness"], nums["routed_apart"] = routing_witness(
        index.centroids, fresh, half, card, f"single-device {kind}")
    dead = rng.choice(QZ_ROWS, QZ_ROWS // 10, replace=False).astype(np.int32)
    for s in range(0, dead.shape[0], MUT_DELETE_BATCH):
        m, found = mut.delete(m, dead[s:s + MUT_DELETE_BATCH])
        check(found.all(), f"{kind}: a delete missed a live id")
    for name, engine in (("kernel", None), ("legacy", False)):
        sync(dev)
        t0 = time.perf_counter()
        _, i = search(m, qb, engine)
        sync(dev)
        nums[f"batch4096_{name}_ms"] = 1e3 * (time.perf_counter() - t0)
        n_kernel += engine is None
        check(not np.isin(i.cpu().numpy(), dead).any(),
              f"{kind} {name} engine surfaced a deleted id")
    _, i = search(m, torch.as_tensor(fresh, device=dev))
    n_kernel += 1
    check(torch.equal(i[:, 0].cpu(), torch.as_tensor(fresh_ids)),
          f"{kind}: an acked row is not its own top-1")
    sync(dev)
    t0 = time.perf_counter()
    mc, st = mut.compact(m)
    sync(dev)
    nums["compact_s"] = time.perf_counter() - t0
    check(st["survivors"] == QZ_ROWS - dead.size + MUT_INGEST,
          f"{kind} compaction survivors {st['survivors']}")
    _, i = search(mc, qb)
    n_kernel += 1
    check(not np.isin(i.cpu().numpy(), dead).any(),
          f"{kind}: a deleted id surfaced after compaction")
    return nums, n_kernel


def subchunk_scan_entry(flat, sq):
    """The ``kernels`` entry of the shared sub-chunk scan (#1): its
    counterpart is the grid of the list kernel in csrc/flat_scan.cu
    (row groups x query tiles x lists, the [lo, hi) mask and the 8-row
    minima of csrc/scan_core.cuh), which every flat and SQ scan of the
    paths launches; timed in the gathered form of the JAX scan, list
    b's window at row b * Lpad with every slot live (the flat phase's
    reference shape)."""
    g = flat["gathered"]
    return {
        "name": "subchunk_scan", "route": "cuda",
        "source": "raft_tpu_torch/csrc/scan_core.cuh",
        "replaces": "raft_tpu/spatial/ann/scan_core.py:211",
        "entry": "flat_scan_subchunk_min (gathered form)",
        "launches": flat["launches"] + sq["launches"],
        "max_abs_err": g["max_abs_err"], "ms": g["ms"],
        "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": g["bound_by"], "library_ms": g["library_ms"],
        "shape": g["shape"], "card": flat["card"],
    }


# ---------------------------------------------------------------------------
# The cold tier over the main path's IVF-Flat index
# ---------------------------------------------------------------------------

TIER_CAPACITY = 4          # cold slab bytes / hot budget (capacity_x)
TIER_SAMPLE = 65_536       # corpus rows the working set is chosen on
TIER_BATCH = 4096          # the tiered batch (the largest bucket)
TIER_ROUND = 512           # queries a convergence search carries
TIER_QUERIES = 4096        # working-set queries a convergence round sends
TIER_ROUNDS = 8            # convergence rounds at most
TIER_DELETE_FRAC = 0.01    # of the rows in hot lists
TIER_SLEEP_CYCLES = 200_000_000   # ~0.1 s of the card's clock
TIER_WATCHDOG_S = 300      # the phase's stall limit


@contextlib.contextmanager
def host_syncs():
    """Count the host syncs torch's sync debug mode reports inside, by
    source line (every thread's: the rank threads' too)."""
    syncs = collections.Counter()
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield syncs
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    syncs.update(f"{os.path.basename(w.filename)}:{w.lineno}"
                 for w in warned
                 if "called a synchronizing" in str(w.message))


@contextlib.contextmanager
def no_host_sync(what):
    """Fail if torch's sync debug mode reports a host sync inside."""
    with host_syncs() as syncs:
        yield
    for where, n in syncs.items():
        log(f"host sync inside {what} ({n}x): {where}")
    check(not syncs, f"{len(syncs)} host syncs inside {what}")


@contextlib.contextmanager
def tier_calls():
    """Record every grouped-scan call the tier makes (its searches and
    the guardrail's full-path arm, the calls with a row mask): its
    engine's form and the flat-scan launches it made."""
    with body_calls(lambda e, kw: kw.get("row_mask") is not None,
                    lambda args, kw, added, n: (args[0].kernel, n)) as calls:
        yield calls


def working_set(store, rows, n_probes):
    """The capacity test's working set (tests/test_tier.py:554-580) at
    this scale: at most ``store.n_slots`` lists chosen greedily, one a
    step, each the list that newly covers the most of ``rows`` (rows
    whose probes, host replay, all fall inside the set), ties to the
    most probed list, then the highest id. Returns (lists, covered row
    indices)."""
    probes = store.host_probes(rows, n_probes)
    n_lists = store.stats().n_lists
    hist = np.bincount(probes.ravel(), minlength=n_lists)
    ids = np.arange(n_lists)
    in_s = np.zeros(n_lists, bool)
    covered = np.zeros(len(rows), bool)
    for _ in range(store.n_slots):
        # a row one list short of covered gains exactly that list
        one_short = (~covered) & (in_s[probes].sum(1) == n_probes - 1)
        sub = probes[one_short]
        gain = np.bincount(sub[~in_s[sub]], minlength=n_lists)
        gain[in_s] = -1
        in_s[np.lexsort((ids, hist, gain))[-1]] = True
        covered = in_s[probes].all(1)
    return np.nonzero(in_s)[0], np.nonzero(covered)[0]


def tier_phase(args, card, dev, index, qcaps, x):
    """The cold tier over the main path's 1M-row index at 4x its hot
    budget: the geometry, all hot equal to the resident legacy search,
    convergence from misses alone to recall >= 0.95 on a working set
    that fits, the cold-tier row through the executor, a dispatch raced
    against membership flips, deletes, a recovered state and a
    compaction synced into the tier, no host sync in a tiered search
    after each flip, no extension built, no flat-scan launch from the
    tier and none lost from the resident arm. Runs under a stall
    watchdog. Returns the phase's entry under the flat scan's ``tier``
    key."""
    import tempfile

    from raft_tpu_torch import _build
    from raft_tpu_torch.durability import wal
    from raft_tpu_torch.obs import MetricRegistry
    from raft_tpu_torch.serving.tier_rows import cold_tier_row
    from raft_tpu_torch.spatial.ann import flat_kernel as fk
    from raft_tpu_torch.spatial.ann import ivf_flat_search_grouped
    from raft_tpu_torch.spatial.ann import mutation as mut
    from raft_tpu_torch.spatial.ann.common import coarse_probe
    from raft_tpu_torch.tier import (
        PromotionPolicy, SlabFetcher, TieredListStore,
    )

    faulthandler.dump_traceback_later(TIER_WATCHDOG_S, exit=True)
    try:
        rng = np.random.default_rng(args.seed + 30)
        nums = {"card": card}
        libs = set(_build._LIBS)
        storage = index.storage
        n_lists, L = storage.list_index.shape[0], storage.max_list
        cold_bytes = storage.n * DIM * index.data_sorted.element_size()
        budget = cold_bytes // TIER_CAPACITY
        sids = storage.sorted_ids.cpu().numpy()
        list_of_pos = np.repeat(np.arange(n_lists),
                                storage.list_sizes.cpu().numpy())
        list_of_id = np.empty(storage.n, np.int64)
        list_of_id[sids] = list_of_pos
        sample = x[rng.choice(N_ROWS, TIER_SAMPLE, replace=False)]
        qc_big, qc_round = qcaps[TIER_BATCH], qcaps[TIER_ROUND]

        def timed_ms(fn, n=5):
            fn()
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            sync(dev)
            return 1e3 * (time.perf_counter() - t0) / n

        def tiered(store, q, **kw):
            return store.search(q, K, n_probes=N_PROBES,
                                qcap=qcaps[q.shape[0]], **kw)

        def all_hot_rows(store, rows, m):
            """``m`` rows of ``rows`` (with repeats) whose probes on the
            card all land in hot lists."""
            hot = torch.zeros(n_lists, dtype=torch.bool, device=dev)
            hot[torch.as_tensor(store.hot_lists(), device=dev).long()] = True
            cand = torch.as_tensor(rows, device=dev)
            probes, _ = coarse_probe(cand, index.centroids, N_PROBES)
            ok = torch.nonzero(hot[probes].all(1)).squeeze(1)
            check(ok.numel() > 0, "no row probes only hot lists")
            pick = ok[torch.arange(m, device=dev) % ok.numel()]
            return cand[pick], int(ok.numel())

        def dead_free(ids, dead):
            got = set(ids.cpu().numpy().ravel().tolist())
            return not (got & dead)

        def sync_free_search(store, what):
            rows = sample[:TIER_BATCH]
            staged = store.stage(rows)
            with no_host_sync(f"a tiered search after {what}"):
                tiered(store, staged)
            sync(dev)

        fk.LAUNCHES = 0
        engine_fallbacks("ivf_flat", reset=True)
        with engine_batches(False) as resident, tier_calls() as tcalls:
            # -- geometry ----------------------------------------------
            t0 = time.perf_counter()
            reg = MetricRegistry()
            store = TieredListStore(index, hbm_budget_bytes=budget,
                                    name="smoke_tier", min_recall=0.95,
                                    registry=reg)
            sync(dev)
            nums.update(
                snapshot_s=time.perf_counter() - t0, max_list=L,
                n_slots=store.n_slots, hot_bytes=store.stats().hot_bytes,
                host_bytes=store.host_bytes,
                capacity_x=cold_bytes / (store.n_slots * L * DIM * 4),
                hot_share=store.n_slots / n_lists)
            check(store._hot_data.device.type == "cuda"
                  and store._data_host.is_pinned(),
                  "the hot tier is not on the card or the cold slab not "
                  "pinned")
            check(nums["capacity_x"] >= TIER_CAPACITY,
                  f"capacity {nums['capacity_x']}")
            log(f"[{card}] tier geometry: max_list {L}, {store.n_slots} "
                f"slots of {n_lists} lists ({nums['hot_share']:.1%} can be "
                f"hot), hot {nums['hot_bytes'] / 1e6:.1f} MB, pinned host "
                f"{nums['host_bytes'] / 1e6:.1f} MB, capacity "
                f"{nums['capacity_x']:.2f}x, snapshot "
                f"{nums['snapshot_s']:.2f} s")

            # -- all hot equals resident --------------------------------
            ws_lists, ws_rows = working_set(store, sample, N_PROBES)
            probe_hist = np.bincount(
                store.host_probes(sample, N_PROBES).ravel(),
                minlength=n_lists)
            rest = [int(c) for c in np.argsort(-probe_hist, kind="stable")
                    if c not in set(ws_lists.tolist())]
            fill = [int(c) for c in ws_lists] + rest
            sync(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            mem0 = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            n_in = store.promote(fill)
            sync(dev)
            nums["install_ms_per_list"] = \
                1e3 * (time.perf_counter() - t0) / n_in
            nums["install_peak_extra_bytes"] = \
                torch.cuda.max_memory_allocated(dev) - mem0
            nums["clone_bytes"] = (store._hot_data.numel() * 4
                                   + store._hot_ids.numel() * 4)
            check(n_in == store.n_slots, f"promoted {n_in} lists")
            qa, n_ok = all_hot_rows(store, sample, TIER_BATCH)
            tv, ti = tiered(store, qa)
            rv, ri = ivf_flat_search_grouped(index, qa, K, n_probes=N_PROBES,
                                             qcap=qc_big, use_kernel=False)
            check(torch.equal(ti, ri) and torch.equal(tv, rv),
                  "all hot: the tier differs from the resident legacy search")
            log(f"[{card}] all hot: {n_in} lists installed in one "
                f"transaction ({nums['install_ms_per_list']:.3f} ms a list, "
                f"the clone {nums['clone_bytes'] / 1e6:.1f} MB, peak "
                f"+{nums['install_peak_extra_bytes'] / 1e6:.1f} MB); "
                f"{TIER_BATCH} queries from {n_ok} sampled rows probing "
                "only hot lists: ids equal and distances bitwise to the "
                "resident legacy search")
            host_rows = qa.cpu().numpy()
            staged = store.stage(host_rows)
            nums["batch_tiered_ms"] = timed_ms(
                lambda: tiered(store, staged))
            nums["batch_tiered_noaccount_ms"] = timed_ms(
                lambda: tiered(store, qa, account=False))
            nums["batch_resident_kernel_ms"] = timed_ms(
                lambda: ivf_flat_search_grouped(
                    index, qa, K, n_probes=N_PROBES, qcap=qc_big))
            nums["batch_resident_legacy_ms"] = timed_ms(
                lambda: ivf_flat_search_grouped(
                    index, qa, K, n_probes=N_PROBES, qcap=qc_big,
                    use_kernel=False))
            nums["d2h_copy_ms"] = timed_ms(lambda: qa.cpu())
            t0 = time.perf_counter()
            for _ in range(5):
                store._account(host_rows, N_PROBES, False)
            nums["account_host_ms"] = 1e3 * (time.perf_counter() - t0) / 5
            log(f"[{card}] {TIER_BATCH}-query batch: tiered (legacy "
                f"engine, host rows accounted) {nums['batch_tiered_ms']:.2f}"
                f" ms, without accounting "
                f"{nums['batch_tiered_noaccount_ms']:.2f} ms; resident "
                f"kernel engine {nums['batch_resident_kernel_ms']:.2f} ms, "
                f"resident legacy {nums['batch_resident_legacy_ms']:.2f} "
                f"ms; _account {nums['account_host_ms']:.2f} ms of host "
                f"time; a CUDA batch's copy back for it "
                f"{nums['d2h_copy_ms']:.3f} ms")
            sync_free_search(store, "promote")

            # -- a dispatch raced against membership flips ---------------
            ref = tiered(store, qa, account=False)
            sync(dev)
            ref = [t.clone() for t in ref]
            hot0 = [int(c) for c in store.hot_lists()]
            cold0 = [c for c in rest if c not in set(hot0)]
            torch.cuda._sleep(TIER_SLEEP_CYCLES)
            out = tiered(store, qa, account=False)   # snapshot A, dropped
            half = len(hot0) // 2
            flips = [(hot0[:half], cold0[:half]),
                     (cold0[:half], cold0[half:2 * half])]
            for down, up in flips:
                store.demote(down)
                check(store.promote(up) == len(up), "a flip's promote")
            sync(dev)
            check(all(torch.equal(a, b) for a, b in zip(out, ref)),
                  "the in-flight dispatch differs from its snapshot's answer")
            _, ni = tiered(store, qa, account=False)
            hot1 = set(int(c) for c in store.hot_lists())
            got = ni.cpu().numpy().ravel()
            check(all(list_of_id[g] in hot1 for g in got if g >= 0),
                  "after the flips an answer came from a cold list")
            check(not torch.equal(ni, ref[1]),
                  "the flips did not change the answer")
            nums["inflight_flips"] = len(flips)
            log(f"[{card}] in flight: a {TIER_BATCH}-query dispatch held "
                f"behind ~{TIER_SLEEP_CYCLES / 1e9:.1f} G cycles while "
                f"{len(flips)} flips demoted and refilled {half} slots each "
                "answered bitwise as its snapshot; the next search answers "
                "from the new hot set only")
            sync_free_search(store, "demote")

            # -- deletes into hot lists, synced --------------------------
            hot_pos = np.nonzero(np.isin(list_of_pos, sorted(hot1)))[0]
            del_pos = rng.choice(hot_pos, max(1, int(TIER_DELETE_FRAC
                                                     * hot_pos.size)),
                                 replace=False)
            del_ids = np.sort(sids[del_pos]).astype(np.int32)
            dead = set(del_ids.tolist())
            q_del = np.ascontiguousarray(
                x[del_ids[np.arange(TIER_BATCH) % del_ids.size]])
            _, before = tiered(store, q_del)
            self_hits = float((before[:, 0].cpu().numpy() == np.resize(
                del_ids, TIER_BATCH)).mean())
            m0 = mut.wrap_mutable(index, delta_cap=MUT_CAP)
            m, found = mut.delete(m0, del_ids)
            check(found.all(), "a delete missed")
            changed = store.sync_mutations(m)
            check(changed is not None and changed and store.stats().epoch
                  == m.epoch, f"sync after deletes: {changed}")
            _, after = tiered(store, q_del)
            check(dead_free(after, dead) and self_hits >= 0.5,
                  f"a deleted id surfaced, or too few deleted rows "
                  f"({self_hits:.1%}) were their own top-1 before")
            nums.update(deleted=int(del_ids.size),
                        delete_self_hits_before=self_hits,
                        delete_changed_lists=len(changed))
            log(f"[{card}] deletes: {del_ids.size} ids in hot lists "
                f"({self_hits:.1%} of them their own top-1 before), "
                f"{len(changed)} lists changed, none surfaces after "
                "sync_mutations")
            sync_free_search(store, "a tombstone flip")

            # -- checkpoint + tail recovery (C1), synced -----------------
            with tempfile.TemporaryDirectory() as td:
                ing = wal.DurableIngest(
                    mut.wrap_mutable(index, delta_cap=MUT_CAP),
                    wal.WalWriter(f"{td}/wal", flush_interval_s=0.002))
                for i, b in enumerate(np.array_split(del_ids, 4)):
                    check(ing.delete(b).all(), "a durable delete missed")
                    if i == 1:
                        ing.checkpoint(f"{td}/c.ckpt")
                live = ing.mindex
                ing.close()
                fresh = mut.wrap_mutable(index, delta_cap=MUT_CAP)
                rec, _, n = wal.recover_mutable(
                    fresh, f"{td}/wal", checkpoint_path=f"{td}/c.ckpt")
            check(rec.epoch == fresh.epoch + n == 2 and live.epoch == 4
                  and torch.equal(rec.row_mask, live.row_mask),
                  f"recovery: epoch {rec.epoch} (live {live.epoch})")
            store.sync_mutations(live)
            v0 = store.runtime()["tier"].version
            back = store.sync_mutations(rec)
            check(back == set() and store.stats().epoch == rec.epoch
                  and store.runtime()["tier"].version == v0 + 1,
                  f"sync onto the recovered state: {back}, epoch "
                  f"{store.stats().epoch}")
            _, after = tiered(store, q_del)
            check(dead_free(after, dead),
                  "a deleted id surfaced after the recovered sync")
            nums.update(recovered_epoch=rec.epoch, live_epoch=live.epoch)
            log(f"[{card}] recovery: checkpoint + tail gives epoch "
                f"{rec.epoch} (live {live.epoch}); the tier re-publishes "
                "the recovered mask and adopts its epoch; no deleted id "
                "surfaces")
            sync_free_search(store, "a sync onto a recovered state")

            # -- compaction ----------------------------------------------
            n_hot = store.stats().hot_lists
            inval0 = store.stats().invalidations
            t0 = time.perf_counter()
            mc, _ = mut.compact(rec, list_bucket=L, row_bucket=N_ROWS)
            check(mut.lists_changed_since(mc, store.stats().epoch) is None,
                  "the journal does not answer None after a compaction")
            kept = (mc.index.storage.n == storage.n
                    and mc.index.storage.max_list == L)
            if kept:
                check(store.sync_mutations(mc) is None
                      and store.stats().hot_lists == 0
                      and store.stats().invalidations == inval0 + n_hot,
                      "compaction: the tier did not invalidate every slot")
            else:
                try:
                    store.sync_mutations(mc)
                    check(False, "a geometry change was synced")
                except ValueError:
                    pass
                store = TieredListStore(mc.index, hbm_budget_bytes=budget,
                                        name="smoke_tier_compacted",
                                        epoch=mc.epoch,
                                        registry=MetricRegistry())
                check(store.sync_mutations(mc) == set(),
                      "the rebuilt store's first sync is not a no-op")
            store.promote(sorted(hot1))
            _, after = tiered(store, q_del)
            check(dead_free(after, dead),
                  "a deleted id surfaced after compaction")
            nums.update(compact_kept_geometry=bool(kept),
                        compact_s=time.perf_counter() - t0,
                        invalidated=n_hot if kept else 0)
            log(f"[{card}] compaction: the journal answers None; "
                + (f"geometry kept, sync_mutations re-snapshot the host "
                   f"authority and invalidated all {n_hot} slots"
                   if kept else
                   f"geometry changed (n {mc.index.storage.n}, max_list "
                   f"{mc.index.storage.max_list}): the sync refused and a "
                   "new store seeded with the epoch served")
                + "; no deleted id surfaces")
            del store, m, m0, rec, live, mc

            # -- capacity at recall: convergence from misses alone -------
            reg = MetricRegistry()
            store = TieredListStore(index, hbm_budget_bytes=budget,
                                    name="smoke_tier_capacity",
                                    min_recall=0.95, touch_decay=1.0,
                                    registry=reg)
            check(ws_rows.size > 0, "the working set covers no row")
            qs = sample[ws_rows[np.arange(TIER_QUERIES) % ws_rows.size]]
            pol = PromotionPolicy(demote_margin=1.25, min_touches=2.0,
                                  max_moves=8)
            hit_rates = []
            t0 = time.perf_counter()
            with SlabFetcher(store, window=4, policy=pol,
                             max_pending=4 * store.n_slots) as f:
                for _ in range(TIER_ROUNDS):
                    pre = store.stats()
                    for b in range(0, TIER_QUERIES, TIER_ROUND):
                        tiered(store, qs[b:b + TIER_ROUND])
                    check(f.drain(60.0), "the fetcher did not drain")
                    post = store.stats()
                    h = post.probe_hits - pre.probe_hits
                    hit_rates.append(h / (h + post.probe_misses
                                          - pre.probe_misses))
                    if post.probe_misses == pre.probe_misses:
                        break
                fstats = f.stats()
            converge_s = time.perf_counter() - t0
            recalls = [store.measure_recall(qs[b:b + TIER_ROUND], K,
                                            n_probes=N_PROBES, qcap=qc_round)
                       for b in range(0, TIER_QUERIES, TIER_ROUND)]
            recall = float(np.mean(recalls))
            st = store.stats()
            h_fetch = reg.histogram("tier_fetch_ms", tier=store.name)
            nums.update(
                working_set_lists=int(ws_lists.size),
                working_set_rows=int(ws_rows.size),
                rounds=len(hit_rates), round_hit_rates=hit_rates,
                hit_rate=st.hit_rate, converge_s=converge_s,
                fetches=st.fetches, fetch_p50_ms=h_fetch.p50,
                fetch_p99_ms=h_fetch.p99, fetcher=fstats,
                recall=recall, degraded=store.degraded)
            check(recall >= 0.95 and not store.degraded,
                  f"capacity: recall {recall} at {nums['capacity_x']:.2f}x")
            check(set(store.hot_lists().tolist()) <= set(ws_lists.tolist())
                  and hit_rates[-1] == 1.0,
                  f"no convergence onto the working set: hit rates "
                  f"{hit_rates}")
            log(f"[{card}] capacity {nums['capacity_x']:.2f}x: working set "
                f"{ws_lists.size} lists covering {ws_rows.size} of "
                f"{TIER_SAMPLE} sampled rows; from all cold, "
                f"{len(hit_rates)} rounds of {TIER_QUERIES} queries (hit "
                f"rate by round {[round(h, 4) for h in hit_rates]}), "
                f"{st.fetches} fetches (host span p50 {h_fetch.p50} ms, "
                f"p99 {h_fetch.p99} ms), {converge_s:.2f} s; recall vs "
                f"the full index {recall:.4f}, degraded {store.degraded}")
            del store

            # -- the cold-tier row through the executor -------------------
            pool = (x[rng.integers(0, N_ROWS, 16_384)]
                    + 0.3 * rng.standard_normal((16_384, DIM),
                                                dtype=np.float32))
            t0 = time.perf_counter()
            row = cold_tier_row(index, pool, k=K, n_probes=N_PROBES)
            nums["row_s"] = time.perf_counter() - t0
            nums["row"] = row
            for key in ("capacity_x", "program_qps", "hot_qps",
                        "tiered_qps", "qps_ratio_vs_hot", "p99_ms_50",
                        "p99_ms_80", "p99_ms_95", "tier_hit_rate",
                        "tier_hit_rate_50", "tier_hit_rate_80",
                        "tier_hit_rate_95", "recall_vs_hot",
                        "fetch_overlap_pct"):
                check(key in row, f"the cold-tier row lacks {key}")
            log(f"[{card}] cold-tier row ({nums['row_s']:.1f} s, "
                f"templates probe {row['template_lists']} distinct lists "
                f"against {row['n_slots']} slots): " + json.dumps(row))

        launches = fk.LAUNCHES
        check(all(not k and n == 0 for k, n in tcalls),
              f"the tier ran the kernel engine or launched the flat scan: "
              f"{collections.Counter(tcalls)}")
        check(all(n == 1 for n in resident) and launches == len(resident),
              f"flat_scan_lists launched {launches} times for "
              f"{len(resident)} resident kernel-engine batches "
              f"{collections.Counter(resident)}")
        check(engine_fallbacks("ivf_flat") == 0,
              f"{engine_fallbacks("ivf_flat")} tier-phase searches left the "
              "kernel")
        check(set(_build._LIBS) == libs, "the tier phase built an extension")
        nums.update(launches=launches, resident_batches=len(resident),
                    tier_scans=len(tcalls), engine_fallbacks=0)
        log(f"[{card}] tier phase: " + json.dumps(nums))
        return nums
    finally:
        faulthandler.cancel_dump_traceback_later()


# ---------------------------------------------------------------------------
# Sharded IVF-Flat over the main path's rows: in process at P = 8 on the
# card, and through torch.distributed with NCCL at world size 1
# ---------------------------------------------------------------------------

# tests/test_mnmg_ivf_flat.py on the 8-device mesh (the shape of
# tests/conftest.py:13-15), at the served configuration: 1,024 lists,
# k-means 10 iterations, k = 10, 8 probes
SHARD_P = 8
SHARD_BATCH = 4096         # the largest bucket
SHARD_FULL_Q = 256         # queries of the every-list probe
SHARD_DOWN = 3             # the rank the degraded steps lose
SHARD_REQUESTS = 100
SHARD_BUCKETS = (8, 64, 512)
SHARD_KEPT = 8             # served batches whose demux is checked


def sharded_phase(args, card, dev, index, qcaps, x):
    """Sharded IVF-Flat (``raft_tpu_torch.comms``) over the main path's
    1M rows: both communicator forms' self-tests and a health sweep, the
    P = 8 build (every row once), the 4,096-query batch on both engines
    against the exact oracle and the single-device index, the every-list
    probe, P = 8 against P = 1 and NCCL at world size 1, a down rank
    without and with a replica, a NaN row, rank recovery from an
    archive, ~100 requests through the ``ServingExecutor`` with the
    coverage gauge, the IVF-SQ sibling's build and batch, and the
    host-clock times. The flat-scan kernel's launches are counted over
    the sharded IVF-Flat path alone, the SQ scan's over the SQ step.
    Returns the phase's numbers, kept under the flat scan's ``sharded``
    key."""
    import tempfile

    import torch.distributed as dist

    from raft_tpu_torch.comms import (
        Comms, build_comms, mnmg_ivf_flat_build, mnmg_ivf_flat_search,
        mnmg_ivf_sq_build, mnmg_ivf_sq_search, place_index, recover_rank,
        run_all_self_tests,
    )
    from raft_tpu_torch.obs import MetricRegistry
    from raft_tpu_torch.resilience import (
        FailoverPlan, ReplicaPlacement, ShardHealth, health_check,
    )
    from raft_tpu_torch.serving import ServingExecutor
    from raft_tpu_torch.spatial.ann import (
        IVFFlatParams, ivf_flat_search_grouped, save_index,
    )
    from raft_tpu_torch.spatial.ann import flat_kernel as fk
    from raft_tpu_torch.spatial.ann import sq_kernel as sk
    from raft_tpu_torch.spatial.ann.common import coarse_probe
    from raft_tpu_torch.spatial.ann.ivf_sq import IVFSQParams

    t_phase = time.perf_counter()
    nums = {"card": card, "ranks": SHARD_P}
    rng = np.random.default_rng(args.seed + 40)
    cuda0 = (torch.device("cuda", torch.cuda.current_device())
             if dev.type == "cuda" else dev)
    comms = build_comms([cuda0] * SHARD_P)
    comms1 = build_comms([cuda0])

    # 1. both forms' self-tests, and the timed health sweep
    tests = run_all_self_tests(comms)
    check(all(tests.values()), f"in-process self-tests failed: {tests}")
    report = health_check(comms)
    check(report.ok, f"health_check failed: {report.failed}")
    nums["health_check_s"] = report.total_seconds
    tmp = tempfile.TemporaryDirectory()
    dcomms = Comms.initialize_distributed(
        os.path.join(tmp.name, "rendezvous"), 1, 0, device=cuda0,
        timeout_s=120.0)
    try:
        tests = run_all_self_tests(dcomms)
        check(all(tests.values()), f"NCCL self-tests failed: {tests}")
        log(f"[{card}] sharded: self-tests pass in process at P = "
            f"{SHARD_P} and through NCCL at world size 1; health_check "
            f"ok in {report.total_seconds:.3f} s")

        # the oracle and the single-device index's answer to the 4,096
        # batch, before the counters go to 0: not the sharded path
        qb = torch.as_tensor(
            x[rng.integers(0, N_ROWS, SHARD_BATCH)]
            + 0.3 * rng.standard_normal((SHARD_BATCH, DIM),
                                        dtype=np.float32), device=dev)
        xd = torch.as_tensor(x, device=dev)
        true = exact_knn(xd, qb, K)
        _, i1 = ivf_flat_search_grouped(index, qb, K, n_probes=N_PROBES,
                                        qcap=qcaps[SHARD_BATCH])
        r_single = recall(i1, true)

        # the sharded path, with the launch counters at 0 just before it
        fk.LAUNCHES = 0
        engine_fallbacks("ivf_flat", reset=True)

        # 2. the build at P = 8
        sync(dev)
        t0 = time.perf_counter()
        sidx = mnmg_ivf_flat_build(comms, x, IVFFlatParams(
            n_lists=N_LISTS, kmeans_n_iters=10, kmeans_init="random"))
        sync(dev)
        nums["build_s"] = time.perf_counter() - t0
        szs = sidx.list_sizes.cpu().numpy()
        sids = sidx.sorted_ids.cpu().numpy()
        got = np.concatenate([sids[r, :szs[r].sum()]
                              for r in range(SHARD_P)])
        check(got.shape[0] == N_ROWS
              and np.array_equal(np.sort(got), np.arange(N_ROWS)),
              "the sharded build does not hold every row exactly once")
        rows_per_rank = szs.sum(1)
        log(f"[{card}] sharded build: {N_ROWS} x {DIM} over {SHARD_P} "
            f"ranks in {nums['build_s']:.2f} s ({sidx.centroids.shape[0]} "
            f"lists after the cap, n_pad {sidx.n_pad}, rows a rank "
            f"{rows_per_rank.min()}..{rows_per_rank.max()})")
        qc = {b: sidx.warmup(comms, b, k=K, n_probes=N_PROBES)
              for b in SHARD_BUCKETS + (SHARD_BATCH,)}
        for b in SHARD_BUCKETS:
            sidx.warmup(comms, b, k=K, n_probes=N_PROBES, qcap=qc[b],
                        shard_mask=True)

        # 3. the 4,096-query batch on both engines, against the oracle
        def sharded(q, idx=None, c=comms, **kw):
            kw.setdefault("qcap", qc.get(q.shape[0], q.shape[0]))
            kw.setdefault("n_probes", N_PROBES)
            return mnmg_ivf_flat_search(c, sidx if idx is None else idx,
                                        q, K, **kw)

        keep = []
        launches0 = fk.LAUNCHES
        with scan_calls(keep):
            d8, i8 = sharded(qb)
        sync(dev)
        per_batch = fk.LAUNCHES - launches0
        _, i8_legacy = sharded(qb, use_kernel=False)
        r_kernel, r_legacy = recall(i8, true), recall(i8_legacy, true)
        nums.update(recall_single=r_single, recall_kernel=r_kernel,
                    recall_legacy=r_legacy, launches_per_batch=per_batch)
        log(f"[{card}] sharded {SHARD_BATCH}-query batch: recall@10 kernel "
            f"{r_kernel:.4f}, legacy {r_legacy:.4f}, single-device index "
            f"{r_single:.4f}; flat_scan_lists launched {per_batch} times "
            "(one a rank)")
        check(r_kernel >= r_single - 0.02 and r_legacy >= r_single - 0.02,
              f"sharded recall below the single-device index's: {nums}")
        check(r_kernel >= r_legacy - 0.005,
              f"sharded kernel engine below legacy: {nums}")
        check(1 <= per_batch <= SHARD_P,
              f"{per_batch} flat-scan launches for one batch at P = "
              f"{SHARD_P}")
        # the comparison's own launches are not the path's
        saved = fk.LAUNCHES
        max_err = max(compare_lists_to_plain(call) for call in keep)
        fk.LAUNCHES = saved
        nums["max_abs_err"] = max_err
        log(f"[{card}] sharded batch's {len(keep)} flat_scan_lists calls "
            f"within 1e-5 x (qn + yn) of the plain version, max |kernel - "
            f"plain| {max_err:.3g}")
        del keep

        # every list probed: each row scanned, so the oracle's answer
        # (recall 1.0, the returned rows' exact distances the oracle's
        # rows') with exact distances; the sentinel list takes ~7/8 of
        # the probe slots, far past its qcap, and must read as empty
        qf = qb[:SHARD_FULL_Q]
        n_all = int(sidx.centroids.shape[0])
        qc_all = sidx.warmup(comms, SHARD_FULL_Q, k=K, n_probes=n_all)
        check(qc_all == SHARD_FULL_Q,
              f"every-list qcap {qc_all}: a list would drop queries")
        true_all = ((qf[:, None, :].double()
                     - xd[true[:SHARD_FULL_Q]].double()) ** 2).sum(-1)
        for engine in (False, None):
            before = fk.LAUNCHES
            d_all, i_all = sharded(qf, n_probes=n_all, qcap=qc_all,
                                   use_kernel=engine)
            sync(dev)
            n_launch = fk.LAUNCHES - before
            r_all = recall(i_all, true[:SHARD_FULL_Q])
            ref = ((qf[:, None, :].double()
                    - xd[i_all.long()].double()) ** 2).sum(-1)
            scale = ((qf * qf).sum(1)[:, None]
                     + (xd[i_all.long()] ** 2).sum(-1)).double()
            err = (d_all.double() ** 2 - ref).abs()
            # the returned set's exact distances are the oracle's
            gap = (ref - true_all).abs()
            name = "legacy" if engine is False else "kernel"
            swaps = int((i_all.long() != true[:SHARD_FULL_Q]).any(1).sum())
            nums[f"recall_all_{name}"] = r_all
            nums[f"tie_swaps_all_{name}"] = swaps
            log(f"[{card}] sharded every-list probe (n_probes {n_all} = "
                f"every list, qcap {qc_all}, {SHARD_FULL_Q} queries, "
                f"{name}): recall@10 {r_all:.4f}, max |d^2 - exact| "
                f"{err.max().item():.3g}, max |exact - oracle's exact| "
                f"{gap.max().item():.3g} ({swaps} queries' ids in another "
                f"order or swapped at a tie); flat_scan_lists launched "
                f"{n_launch} times")
            check(bool((i_all >= 0).all() and (i_all < N_ROWS).all()),
                  f"every-list probe returned an alien row ({name})")
            check(bool((err <= 1e-5 * scale + 1e-3).all()),
                  f"every-list probe distances not exact ({name})")
            check(r_all == 1.0 and bool((gap <= 1e-5 * scale + 1e-3).all()),
                  f"every-list probe recall {r_all} ({name}): not the "
                  "oracle's answer")
            check(n_launch == (SHARD_P if engine is None else 0),
                  f"{n_launch} flat-scan launches for the every-list "
                  f"probe ({name})")
        check(engine_fallbacks("ivf_flat") == 0,
              f"{engine_fallbacks("ivf_flat")} sharded searches left the "
              "kernel")

        # 4. P = 8 against P = 1 and NCCL at world size 1
        t0 = time.perf_counter()
        idx1 = place_index(comms1, sidx)
        nums["reshard_s"] = time.perf_counter() - t0
        d1, i1s = sharded(qb, idx=idx1, c=comms1)
        idxd = place_index(dcomms, sidx)
        dd, ids_d = sharded(qb, idx=idxd, c=dcomms)
        sync(dev)
        for name, (d_, i_) in (("P = 1", (d1, i1s)), ("NCCL", (dd, ids_d))):
            check(torch.equal(d_, d8), f"{name} distances differ from P = 8")
            bad = ids_tied_only(d8, i8, i_)
            check(bad == 0, f"{name}: {bad} queries' ids differ beyond ties")
        log(f"[{card}] sharded P = 8, P = 1 (resharded in "
            f"{nums['reshard_s']:.2f} s) and NCCL at world size 1: "
            "distances bitwise equal, ids equal up to ties")
        del idxd

        # 5. degraded: a down rank without replicas, then with
        mask = np.ones(SHARD_P, np.int32)
        mask[SHARD_DOWN] = 0
        res = sharded(qb, shard_mask=mask)
        probes, _ = coarse_probe(qb.float(), sidx.centroids, N_PROBES)
        live = sidx.owner.long()[probes] != SHARD_DOWN
        want_cov = live.float().sum(1) * (1.0 / N_PROBES)
        lost = torch.as_tensor(
            sids[SHARD_DOWN, :szs[SHARD_DOWN].sum()], device=dev)
        leaked = torch.isin(res.ids, lost).any().item()
        check(res.partial and torch.equal(res.coverage, want_cov)
              and not leaked,
              f"rank {SHARD_DOWN} down: partial {res.partial}, coverage "
              "against probe_coverage's formula, or one of its ids leaked")
        sidx2 = place_index(comms, sidx, replication=2)
        health = ShardHealth(SHARD_P, telemetry=False)
        health.mark_down(SHARD_DOWN)
        plan = FailoverPlan.from_health(ReplicaPlacement.of_index(sidx2),
                                        health)
        res2 = sharded(qb, idx=sidx2, shard_mask=health, failover=plan)
        # rank 7's part now carries shard 3's candidates: an equal-distance
        # pair across the two shards can merge in the other order
        swapped = int((res2.ids != i8).any(1).sum())
        check(plan.fully_covered and bool((res2.coverage == 1.0).all())
              and torch.equal(res2.distances, d8)
              and ids_tied_only(d8, i8, res2.ids) == 0,
              "failover at replication 2 is not coverage 1.0 and bitwise "
              "the healthy search (ids up to ties)")
        nums["failover_tie_swaps"] = swapped
        qn = qb[:64].clone()
        qn[5, 7] = float("nan")
        res3 = sharded(qn, shard_mask=True)
        check(not bool(res3.row_valid[5]) and bool(res3.row_valid[:5].all())
              and bool(torch.isinf(res3.distances[5]).all())
              and bool((res3.ids[5] == -1).all()),
              "a NaN query row is not masked")
        nums["coverage_down"] = float(res.coverage.mean())
        log(f"[{card}] sharded degraded: rank {SHARD_DOWN} down, mean "
            f"coverage {nums['coverage_down']:.4f} (probe_coverage's "
            "formula), none of its ids; replication 2 with a FailoverPlan: "
            "coverage 1.0, distances bitwise the healthy search's, ids "
            f"equal up to ties ({swapped} queries' tied ids in the other "
            "order); a NaN row masked")

        # 6. a lost slab recovered from the archive
        path = os.path.join(tmp.name, "sharded.npz")
        t0 = time.perf_counter()
        save_index(sidx, path)
        nums["save_s"] = time.perf_counter() - t0
        wrecked = dataclasses.replace(
            sidx, vectors_sorted=sidx.vectors_sorted.clone(),
            sorted_ids=sidx.sorted_ids.clone())
        wrecked.vectors_sorted[SHARD_DOWN] = 0
        wrecked.sorted_ids[SHARD_DOWN] = 0
        t0 = time.perf_counter()
        healed = recover_rank(comms, wrecked, path, SHARD_DOWN)
        nums["recover_s"] = time.perf_counter() - t0
        dh, ih = sharded(qb, idx=healed)
        check(torch.equal(dh, d8) and torch.equal(ih, i8),
              "the recovered index does not answer bitwise as the healthy")
        log(f"[{card}] sharded recovery: archive written in "
            f"{nums['save_s']:.2f} s, rank {SHARD_DOWN} recovered in "
            f"{nums['recover_s']:.2f} s, answers bitwise the healthy")
        del wrecked, healed

        # 7. bucketed requests through the ServingExecutor
        reg = MetricRegistry()
        all_up = np.ones(SHARD_P, np.int32)

        served_kept, keeping = [], True

        def dispatch(batch, shard_mask=None):
            res = mnmg_ivf_flat_search(
                comms, sidx, batch, K, n_probes=N_PROBES,
                qcap=qc[batch.shape[0]], shard_mask=shard_mask)
            if keeping and len(served_kept) < SHARD_KEPT:
                served_kept.append((batch.clone(), res.distances.clone(),
                                    res.ids.clone()))
            return res

        sizes = np.exp(rng.uniform(0.0, np.log(513.0), SHARD_REQUESTS))
        reqs = [x[rng.integers(0, N_ROWS, int(m))]
                for m in np.clip(sizes, 1, 512)]
        with ServingExecutor(dispatch, SHARD_BUCKETS, dim=DIM, device=dev,
                             registry=reg,
                             runtime_inputs={"shard_mask": all_up}) as ex:
            t0 = time.perf_counter()
            outs = [f.result(timeout=120)
                    for f in [ex.submit(r) for r in reqs]]
            serve_s = time.perf_counter() - t0
            gauge = reg.gauge("serving_coverage_min", executor=ex.name)
            cov_up = gauge.value
            keeping = False    # every request above is answered
            ex.set_runtime(shard_mask=mask)
            # 64 rows: some probe rank SHARD_DOWN's lists
            out_down = ex.submit(qb[:64].cpu().numpy()).result(timeout=120)
            cov_down = gauge.value
        for r, o in zip(reqs, outs):
            check(o.distances.shape == (r.shape[0], K)
                  and np.isfinite(o.distances).all()
                  and ((o.ids >= 0) & (o.ids < N_ROWS)).all()
                  and (np.diff(o.distances, axis=1) >= 0).all(),
                  "a served sharded answer is malformed")
        check(cov_up == 1.0 and cov_down < 1.0
              and float(out_down.coverage.min()) < 1.0,
              f"serving_coverage_min {cov_up} all up, {cov_down} with rank "
              f"{SHARD_DOWN} down")
        # demux: each request of a kept batch got exactly its rows of the
        # batch's answer, and a direct search of the batch gives the same
        sync(dev)
        by_row = {}
        for r, o in zip(reqs, outs):
            by_row.setdefault(r[0].tobytes(), []).append((r, o))
        n_demuxed = 0
        check(len(served_kept) == SHARD_KEPT,
              f"kept {len(served_kept)} sharded executor batches")
        for staged, d, i in served_kept:
            direct = mnmg_ivf_flat_search(
                comms, sidx, staged, K, n_probes=N_PROBES,
                qcap=qc[staged.shape[0]], shard_mask=all_up)
            check(torch.equal(direct.distances, d)
                  and torch.equal(direct.ids, i),
                  "a direct search of a kept batch differs from its "
                  "sharded dispatch")
            host = staged.cpu().numpy()
            d, i = d.cpu().numpy(), i.cpu().numpy()
            o = 0
            while o < host.shape[0] and host[o].tobytes() in by_row:
                m = None
                for rows, out in by_row[host[o].tobytes()]:
                    if np.array_equal(host[o:o + rows.shape[0]], rows):
                        m = rows.shape[0]
                        break
                check(m is not None,
                      "a request's rows are not contiguous in its batch")
                check(out.distances.tobytes() == d[o:o + m].tobytes()
                      and out.ids.tobytes() == i[o:o + m].tobytes(),
                      "a served sharded answer differs from its rows of "
                      "the batch's answer")
                o += m
                n_demuxed += 1
            check(o > 0 and not host[o:].any(),
                  "a kept sharded batch holds rows of no request")
        del served_kept
        n_req_rows = int(sum(r.shape[0] for r in reqs))
        nums.update(serve_s=serve_s, served_rows=n_req_rows,
                    coverage_gauge_up=cov_up, coverage_gauge_down=cov_down,
                    demuxed_requests=n_demuxed)
        log(f"[{card}] sharded serving: {len(reqs)} requests, {n_req_rows} "
            f"rows through the ServingExecutor in {serve_s:.3f} s; "
            f"serving_coverage_min {cov_up} all up, {cov_down:.4f} with "
            f"rank {SHARD_DOWN} down; {n_demuxed} requests of the first "
            f"{SHARD_KEPT} batches bitwise their rows of the batch's "
            "answer and of a direct search")

        nums["launches"] = fk.LAUNCHES
        check(nums["launches"] > 0, "the sharded path never launched #2")

        # 7b. the sharded mutation tier on the replicated index
        nums["mutation"] = sharded_mutation_step(
            args, card, dev, comms, sidx2, qc[SHARD_BATCH], tmp.name)
        del sidx2

        # 8. the IVF-SQ sibling over the same rows: #3 on each shard
        sk.LAUNCHES = 0
        engine_fallbacks("ivf_sq", reset=True)
        sync(dev)
        t0 = time.perf_counter()
        sq = mnmg_ivf_sq_build(comms, x, IVFSQParams(n_lists=N_LISTS,
                                                     kmeans_n_iters=10))
        sync(dev)
        nums["sq_build_s"] = time.perf_counter() - t0
        qcs = sq.warmup(comms, SHARD_BATCH, k=K, n_probes=N_PROBES)
        keep = []
        before = sk.LAUNCHES
        with kernel_calls(sk, "sq_scan_lists", lambda a: a[1].shape, keep):
            _, i_sq = mnmg_ivf_sq_search(comms, sq, qb, K, n_probes=N_PROBES,
                                         qcap=qcs)
        sync(dev)
        sq_per_batch = sk.LAUNCHES - before
        _, i_sq_legacy = mnmg_ivf_sq_search(comms, sq, qb, K,
                                            n_probes=N_PROBES, qcap=qcs,
                                            use_kernel=False)
        saved = sk.LAUNCHES
        sq_err = max(compare_lists_to_plain(call) for call in keep)
        sk.LAUNCHES = saved
        del keep
        nums.update(sq_recall_kernel=recall(i_sq, true),
                    sq_recall_legacy=recall(i_sq_legacy, true),
                    sq_launches_per_batch=sq_per_batch,
                    sq_max_abs_err=sq_err, sq_launches=sk.LAUNCHES)
        log(f"[{card}] sharded IVF-SQ: built in {nums['sq_build_s']:.2f} s; "
            f"{SHARD_BATCH}-query batch recall@10 kernel "
            f"{nums['sq_recall_kernel']:.4f}, legacy "
            f"{nums['sq_recall_legacy']:.4f}; sq_scan_lists launched "
            f"{sq_per_batch} times a batch, within 1e-5 x (qn + yn) of the "
            f"plain version (max {sq_err:.3g})")
        check(nums["sq_recall_kernel"] >= nums["sq_recall_legacy"] - 0.005,
              f"sharded SQ kernel engine below legacy: {nums}")
        check(1 <= sq_per_batch <= SHARD_P,
              f"{sq_per_batch} SQ-scan launches for one batch")
        check(engine_fallbacks("ivf_sq") == 0,
              f"{engine_fallbacks("ivf_sq")} sharded SQ searches left the "
              "kernel")
        before = sk.LAUNCHES
        nums["sq_mutation"] = mutable_round(
            comms, sq, x, qb, qcs, rng, "IVF-SQ", card, dev,
            (sk, "sq_scan_lists", compare_lists_to_plain))
        nums["sq_mutation"]["launches"] = sk.LAUNCHES - before
        nums["sq_launches"] = sk.LAUNCHES
        check(engine_fallbacks("ivf_sq") == 0 and sk.LAUNCHES > before,
              "the sharded SQ mutation round left the kernel")
        del sq

        # 9. host clock, 5 calls each (not gated)
        def host_ms(fn, n=5):
            fn()
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            sync(dev)
            return 1e3 * (time.perf_counter() - t0) / n

        nums["p8_ms"] = host_ms(lambda: sharded(qb))
        nums["p1_ms"] = host_ms(lambda: sharded(qb, idx=idx1, c=comms1))
        nums["single_ms"] = host_ms(lambda: ivf_flat_search_grouped(
            index, qb, K, n_probes=N_PROBES, qcap=qcaps[SHARD_BATCH]))
        log(f"[{card}] sharded {SHARD_BATCH}-query batch, host clock over 5 "
            f"calls: P = 8 {nums['p8_ms']:.2f} ms, P = 1 "
            f"{nums['p1_ms']:.2f} ms, single-device index "
            f"{nums['single_ms']:.2f} ms")
    finally:
        dist.destroy_process_group()
        tmp.cleanup()
    nums["phase_s"] = time.perf_counter() - t_phase
    log(f"[{card}] sharded phase: " + json.dumps(nums))
    return nums


def mutable_round(comms, index, x, qb, qcap, rng, what, card, dev, hold,
                  n_probes=N_PROBES, **kw):
    """One upsert / delete round on a sharded index, both engines: 64
    dyadic rows upserted (each its own top-1 at distance 0), 1,024 main
    ids and a quarter of the fresh ones deleted (none surfaces in the
    4,096 batch). ``hold = (module, wrapper name, compare)``: the kernel
    engine's calls of that wrapper are kept and each held against its
    plain version by ``compare(call)`` (-> max |kernel - plain|), its
    launches not counted. Returns its numbers."""
    from raft_tpu_torch.comms import (
        mnmg_delete, mnmg_mutable_search, mnmg_upsert, wrap_mnmg_mutable,
    )

    n_main = int(index.n_rows)
    fresh = dyadic_rows(x, rng, 64)
    ids = np.arange(n_main + 10_000, n_main + 10_064, dtype=np.int32)
    dead = np.concatenate([
        rng.choice(n_main, 1024, replace=False).astype(np.int32), ids[::4]])
    sync(dev)
    t0 = time.perf_counter()
    mw = wrap_mnmg_mutable(comms, index, delta_cap=16)
    mw, acc = mnmg_upsert(comms, mw, fresh, ids)
    mw, found = mnmg_delete(comms, mw, dead)
    sync(dev)
    nums = {"writes_s": time.perf_counter() - t0}
    check(acc.all() and found.all(),
          f"{what} mutation round: {acc.sum()} of 64 acked, {found.sum()} "
          f"of {dead.size} deletes found")
    fresh_t = torch.as_tensor(fresh, device=dev)
    live = torch.as_tensor(~np.isin(ids, dead), device=dev)
    want = torch.as_tensor(ids, device=dev)[live]
    mod, wrapper, compare = hold
    keep = []
    for name, engine in (("kernel", None), ("legacy", False)):
        calls = (kernel_calls(mod, wrapper, lambda a: None, keep)
                 if engine is None else contextlib.nullcontext())
        with calls:
            d, i = mnmg_mutable_search(comms, mw, fresh_t, K,
                                       n_probes=n_probes, qcap=64,
                                       use_kernel=engine, **kw)
            check(torch.equal(i[live, 0], want)
                  and bool((d[live, 0] == 0).all()),
                  f"{what} {name}: an upserted row is not its own top-1 at 0")
            sync(dev)
            t0 = time.perf_counter()
            _, i = mnmg_mutable_search(comms, mw, qb, K, n_probes=n_probes,
                                       qcap=qcap, use_kernel=engine, **kw)
            sync(dev)
        nums[f"batch4096_{name}_ms"] = 1e3 * (time.perf_counter() - t0)
        check(not np.isin(i.cpu().numpy(), dead).any(),
              f"{what} {name}: a deleted id surfaced")
    # these launches are not the path's
    check(len(keep) > 0, f"{what} mutation round: no {wrapper} call")
    saved = mod.LAUNCHES
    nums["max_abs_err"] = max(compare(call) for call in keep)
    mod.LAUNCHES = saved
    nums["calls_held"] = len(keep)
    log(f"[{card}] sharded {what} mutation round: 64 upserts each its own "
        f"top-1 at 0, {dead.size} deletes masked, both engines; the kernel "
        f"engine's {len(keep)} {wrapper} calls held against the plain "
        "version; " + json.dumps(nums))
    return nums


def routing_witness(centroids, rows, split, card, what):
    """Each row's list with the rows in one batch and in two batches
    split at ``split``, as the upserts route it: the nearest centroid
    (``fused_l2_nn``), then the index's ``canonical_lists`` table (the
    lowest list sharing that centroid row). Logs how many rows the raw
    GEMM puts in another list (split pieces share a centroid, and the
    GEMM may round their distances apart at one batch size and not at
    another), with each such row's f32 distances as ``fused_l2_nn``
    forms them (its GEMM block) at each batch size and in f64, and how
    many the canonical table routes apart (the check: 0). Returns
    (raw records, rows routed apart)."""
    from raft_tpu_torch.cluster.kmeans import canonical_lists

    fl = importlib.import_module("raft_tpu_torch.distance.fused_l2_nn")
    cents = torch.as_tensor(centroids).float()
    canon = canonical_lists(cents)
    x = torch.as_tensor(rows, device=cents.device).float()
    yn = (cents * cents).sum(1)
    bn = fl._choose_block(cents.shape[0])
    whole = fl.fused_l2_nn(x, cents)[1]
    parts = torch.cat([fl.fused_l2_nn(x[:split], cents)[1],
                       fl.fused_l2_nn(x[split:], cents)[1]])
    apart = int((canon[whole.long()] != canon[parts.long()]).sum())

    def d2(xb, r, lst):
        g = xb @ cents[lst // bn * bn:lst // bn * bn + bn].T
        return float((xb[r] * xb[r]).sum() + yn[lst]
                     - 2.0 * g[r, lst % bn])

    out = []
    for r in torch.nonzero(whole != parts).flatten().tolist():
        a, b = int(whole[r]), int(parts[r])
        xb, rb = (x[:split], r) if r < split else (x[split:], r - split)
        rec = {"row": r, "list_whole": a, "list_split": b,
               "canonical": [int(canon[a]), int(canon[b])],
               "f32_whole": [d2(x, r, a), d2(x, r, b)],
               "f32_split": [d2(xb, rb, a), d2(xb, rb, b)],
               "f64": [float(((x[r].double() - cents[c].double()) ** 2)
                             .sum()) for c in (a, b)]}
        out.append(rec)
        log(f"[{card}] {what} raw GEMM routing witness: " + json.dumps(rec))
    n_dup = int((canon != torch.arange(canon.shape[0],
                                       device=canon.device)).sum())
    log(f"[{card}] {what} upsert routing: the raw GEMM puts {len(out)} of "
        f"{x.shape[0]} rows in another list in batches of {split} than in "
        f"one batch of {x.shape[0]}; through the canonical table "
        f"({n_dup} of {canon.shape[0]} centroids duplicate a lower one) "
        f"{apart} rows are routed apart")
    check(apart == 0, f"{what}: {apart} upserts routed to another list at "
          f"batch {split} than at {x.shape[0]}")
    return out, apart


def sharded_mutation_step(args, card, dev, comms, rep, qcap, tmpdir):
    """The sharded mutation tier over the replicated (R = 2) P = 8
    IVF-Flat index: the mutation phase's 256 upserts and 10% deletes,
    once on a healthy twin and once with rank SHARD_DOWN failed
    mid-ingest; the 4,096 batch on the twin on both engines (recall on
    the survivors within 0.005 of the single-device phase's, every live
    upsert its own top-1 at 0, no deleted id); every acked write served
    through the failover route, bitwise the twin; the lost rank
    recovered (``recover_rank`` from an archive, ``resync_rank`` from its
    replica) to the twin's state bitwise; then ``MnmgDurableIngest`` over
    8 per-rank WALs (24 batches of 128) and ``mnmg_recover`` onto a
    fresh wrap, state bitwise. #2's launches are counted over the step
    alone. Returns its numbers."""
    from raft_tpu_torch.comms import (
        MnmgDurableIngest, MnmgMutableIndex, MnmgMutationState, mnmg_delete,
        mnmg_mutable_search, mnmg_recover, mnmg_upsert, recover_rank,
        resync_rank, wrap_mnmg_mutable,
    )
    from raft_tpu_torch.resilience import (
        FailoverPlan, ReplicaPlacement, ShardHealth,
    )
    from raft_tpu_torch.spatial.ann import flat_kernel as fk
    from raft_tpu_torch.spatial.ann import save_index

    S = MUTATION_SCRIPT
    check(S, "the sharded mutation step needs the mutation phase's script")
    fresh, fresh_ids, dead = S["fresh"], S["fresh_ids"], S["dead"]
    qb, true = S["qb"], S["true"]
    rng = np.random.default_rng(args.seed + 41)
    nums = {"card": card}
    half = MUT_INGEST // 2
    state_keys = ("row_mask", "delta_vecs", "delta_ids", "delta_counts")

    def same_state(a, b):
        return all(torch.equal(getattr(a.state, f), getattr(b.state, f))
                   for f in state_keys)

    def search(m, q, **kw):
        kw.setdefault("qcap", qcap if q.shape[0] == SHARD_BATCH
                      else q.shape[0])
        return mnmg_mutable_search(comms, m, q, K, n_probes=N_PROBES, **kw)

    fk.LAUNCHES = 0
    engine_fallbacks("ivf_flat", reset=True)
    sync(dev)
    t0 = time.perf_counter()
    mw0 = wrap_mnmg_mutable(comms, rep, delta_cap=MUT_CAP)
    # the healthy twin: every write on every holder, the upserts in one
    # batch of 256 (the live path writes 2 x 128; the routing through the
    # canonical table makes the batching invisible)
    ref, acc = mnmg_upsert(comms, mw0, fresh, fresh_ids)
    ref, found = mnmg_delete(comms, ref, dead)
    check(acc.all() and found.all(), "the healthy twin's writes")
    sync(dev)
    nums["twin_writes_s"] = time.perf_counter() - t0
    nums["routing_witness"], nums["routed_apart"] = routing_witness(
        rep.centroids, fresh, half, card, "sharded")
    # rank SHARD_DOWN fails after half the upserts
    health = ShardHealth(SHARD_P, telemetry=False)
    t0 = time.perf_counter()
    live, acc1 = mnmg_upsert(comms, mw0, fresh[:half], fresh_ids[:half])
    health.mark_down(SHARD_DOWN)
    live, acc2 = mnmg_upsert(comms, live, fresh[half:], fresh_ids[half:],
                             alive=health.mask())
    live, found2 = mnmg_delete(comms, live, dead)
    sync(dev)
    nums["degraded_writes_s"] = time.perf_counter() - t0
    check(acc1.all() and acc2.all() and found2.all(),
          "writes with a rank down were not all acked")

    # the 4,096 batch on the twin: recall on the survivors, no dead id,
    # every live upsert its own top-1 at 0
    fresh_t = torch.as_tensor(fresh, device=dev)
    live_f = torch.as_tensor(~np.isin(fresh_ids, dead), device=dev)
    want_f = torch.as_tensor(fresh_ids, device=dev)[live_f]
    keep = []
    for name, engine in (("kernel", None), ("legacy", False)):
        before = fk.LAUNCHES
        sync(dev)
        t0 = time.perf_counter()
        with scan_calls(keep if engine is None else None):
            _, i = search(ref, qb, use_kernel=engine)
        sync(dev)
        nums[f"batch4096_{name}_ms"] = 1e3 * (time.perf_counter() - t0)
        nums[f"launches_batch_{name}"] = fk.LAUNCHES - before
        nums[f"recall_{name}"] = recall(i, true)
        check(not np.isin(i.cpu().numpy(), dead).any(),
              f"sharded mutable {name}: a deleted id surfaced")
        d, i = search(ref, fresh_t, use_kernel=engine)
        check(torch.equal(i[live_f, 0], want_f)
              and bool((d[live_f, 0] == 0).all()),
              f"sharded mutable {name}: an upsert is not its own top-1 at 0")
        check(nums[f"recall_{name}"] >= S["recall"][name] - 0.005,
              f"sharded mutable recall {nums[f'recall_{name}']} ({name}) "
              f"below the single device's {S['recall'][name]} - 0.005")
    log(f"[{card}] sharded mutation: {MUT_INGEST} upserts, {dead.size} "
        f"deletes; {SHARD_BATCH}-query batch recall@10 on the survivors "
        f"kernel {nums['recall_kernel']:.5f}, legacy "
        f"{nums['recall_legacy']:.5f} (single device "
        f"{S['recall']['kernel']:.5f} / {S['recall']['legacy']:.5f}); "
        f"{nums['batch4096_kernel_ms']:.2f} / "
        f"{nums['batch4096_legacy_ms']:.2f} ms; flat_scan_lists "
        f"{nums['launches_batch_kernel']} launches a kernel batch")

    # every acked write served through the failover route: bitwise the
    # healthy twin (ids up to ties: a tied pair across two shards can
    # merge in the other order)
    plan = FailoverPlan.from_health(ReplicaPlacement.of_index(rep), health)
    qcat = torch.cat([qb[:512], fresh_t])
    for name, engine in (("kernel", None), ("legacy", False)):
        want = search(ref, qcat, shard_mask=True, use_kernel=engine)
        with scan_calls(keep if engine is None else None):
            got = search(live, qcat, shard_mask=health, failover=plan,
                         use_kernel=engine)
        check(plan.fully_covered and bool((got.coverage == 1.0).all())
              and torch.equal(got.distances, want.distances)
              and ids_tied_only(want.distances, want.ids, got.ids) == 0
              and torch.equal(got.ids[512:][live_f, 0], want_f),
              f"failover after a rank failed mid-ingest ({name}): not "
              "coverage 1.0 and bitwise the healthy twin")
    # #2 against its plain version at the replicated slabs' shapes (the
    # twin's kernel batch and the failover search); these launches are
    # not the path's
    saved = fk.LAUNCHES
    nums["max_abs_err"] = max(compare_lists_to_plain(c) for c in keep)
    fk.LAUNCHES = saved
    log(f"[{card}] sharded mutation's {len(keep)} kept flat_scan_lists "
        f"calls (lists x Q x Lpad "
        f"{sorted({(*c[1].shape, c[5]) for c in keep})}) within 1e-5 x "
        f"(qn + yn) of the plain version, max |kernel - plain| "
        f"{nums['max_abs_err']:.3g}")
    del keep

    # the lost rank recovered: main slabs from the archive, mutation slabs
    # from its replica -> the twin's state, bitwise
    path = os.path.join(tmpdir, "replicated.npz")
    t0 = time.perf_counter()
    save_index(rep, path)
    nums["save_s"] = time.perf_counter() - t0
    vs, si = rep.vectors_sorted.clone(), rep.sorted_ids.clone()
    vs[SHARD_DOWN] = 0
    si[SHARD_DOWN] = 0
    st = live.state
    rm, dv, di, dc = (getattr(st, f).clone() for f in state_keys)
    rm[SHARD_DOWN], dv[SHARD_DOWN], di[SHARD_DOWN], dc[SHARD_DOWN] = \
        1, 0, -1, 0
    lost = MnmgMutableIndex(
        index=dataclasses.replace(rep, vectors_sorted=vs, sorted_ids=si),
        state=MnmgMutationState(rm, dv, di, dc, st.cap))
    sync(dev)
    t0 = time.perf_counter()
    healed = MnmgMutableIndex(
        index=recover_rank(comms, lost.index, path, SHARD_DOWN),
        state=lost.state)
    healed = resync_rank(comms, healed, SHARD_DOWN)
    sync(dev)
    nums["recover_resync_s"] = time.perf_counter() - t0
    os.remove(path)
    check(same_state(healed, ref),
          "recover_rank + resync_rank did not give the twin's state")
    dh, ih = search(healed, qb)
    dr, ir = search(ref, qb)
    check(torch.equal(dh, dr) and torch.equal(ih, ir),
          "the healed mesh does not answer bitwise as the twin")
    log(f"[{card}] sharded mutation: rank {SHARD_DOWN} failed after "
        f"{half} upserts, every acked write served through failover at "
        "coverage 1.0, distances bitwise the healthy twin, on both engines; "
        f"archive {nums['save_s']:.2f} s, recover_rank + resync_rank "
        f"{nums['recover_resync_s']:.2f} s, state and answers bitwise the "
        "twin's")
    del lost, healed, live

    # quorum-durable ingest over 8 per-rank WALs, and fleet recovery
    root = os.path.join(tmpdir, "mnmg-wal")
    rows = dyadic_rows(S["qb"].cpu().numpy(), rng, 24 * 128)
    ids = np.arange(3_000_000, 3_000_000 + rows.shape[0], dtype=np.int32)
    ing = MnmgDurableIngest(comms, wrap_mnmg_mutable(comms, rep,
                                                     delta_cap=MUT_CAP),
                            root)
    sync(dev)
    t0 = time.perf_counter()
    acked = [ing.upsert(rows[b:b + 128], ids[b:b + 128])
             for b in range(0, rows.shape[0], 128)]
    dt = time.perf_counter() - t0
    durable = ing.mindex
    frontiers = ing.frontiers()
    ing.close()
    nums["durable_rows_s"] = rows.shape[0] / dt
    check(all(a.all() for a in acked) and max(frontiers.values()) == 24,
          f"durable ingest: acks {[int(a.sum()) for a in acked]}, "
          f"frontiers {frontiers}")
    t0 = time.perf_counter()
    rec, rec_frontiers, n_replayed = mnmg_recover(
        comms, wrap_mnmg_mutable(comms, rep, delta_cap=MUT_CAP), root)
    sync(dev)
    nums["mnmg_recover_s"] = time.perf_counter() - t0
    check(n_replayed == 24 and rec_frontiers == frontiers
          and same_state(rec, durable),
          f"mnmg_recover replayed {n_replayed}, frontiers {rec_frontiers}")
    log(f"[{card}] sharded durable ingest: 24 batches of 128 over 8 "
        f"per-rank WALs at {nums['durable_rows_s']:.0f} rows/s, every row "
        f"acked; mnmg_recover replayed 24 in {nums['mnmg_recover_s']:.2f} s "
        "onto a fresh wrap, state bitwise")
    nums["launches"] = fk.LAUNCHES
    nums["engine_fallbacks"] = engine_fallbacks("ivf_flat")
    check(fk.LAUNCHES > 0 and engine_fallbacks("ivf_flat") == 0,
          f"sharded mutation: {fk.LAUNCHES} flat-scan launches, "
          f"{engine_fallbacks("ivf_flat")} fallbacks")
    return nums


# ---------------------------------------------------------------------------
# The library's public surface: approx_knn_*, the pylibraft facade, random
# ball cover
# ---------------------------------------------------------------------------

RBC_ROWS, RBC_HUBS, RBC_QUERIES, RBC_PROBES = 1_000_000, 1000, 4096, 16
RBC_FULL_Q = 256           # queries probing every ball
RBC_SAMPLE = 65_536        # rows of the all-kNN index
LIB_BF_QUERIES = 512       # the facade's brute-force batch
LIB_PAIRWISE = (4096, 65_536)
LIB_MASK_ROWS = 131_072    # two of fused_l2_nn's 65,536-row blocks


def ids_up_to_ties(d_ref, i_ref, i_got, tol):
    """Queries where an id the reference ranks below its k-th distance
    by more than ``tol`` (a (nq, 1) or scalar margin on the same scale)
    is missing from ``i_got``'s row: 0 when the answers agree up to
    ties."""
    inner = d_ref < d_ref[:, -1:] - tol
    present = (i_ref[:, :, None] == i_got[:, None, :]).any(-1)
    return int((inner & ~present).any(1).sum())


def geo_rows(rng, n, n_hubs, noise):
    """(lat, lon) radian rows clustered around ``n_hubs`` world hubs
    (tests/test_ann.py's ``geo_dataset`` recipe), latitudes clipped."""
    hubs = np.deg2rad(rng.uniform([-60, -170], [70, 170],
                                  size=(n_hubs, 2))).astype(np.float32)
    pts = hubs[rng.integers(0, n_hubs, n)] + rng.normal(
        0, noise, (n, 2)).astype(np.float32)
    pts[:, 0] = np.clip(pts[:, 0], -np.pi / 2, np.pi / 2)
    return pts


def ball_cover_step(args, card, dev):
    """Random ball cover at a size its users run (cuML's
    NearestNeighbors(algorithm="rbc") serves 2-D geospatial and 3-D
    data): 1,000,000 haversine rows around 1,000 hubs and 1,000,000 x 3
    l2 rows around 1,000 hubs, sqrt(n) = 1,000 landmarks each, 4,096
    queries at k = 10 and 16 probes; every certified query equal to its
    exact oracle; 256 l2 queries probing every ball, all certified;
    ``rbc_all_knn_query`` on a 65,536-row sample. Returns the numbers."""
    from raft_tpu_torch.spatial.ann import (
        rbc_all_knn_query, rbc_build_index, rbc_knn_query,
    )
    from raft_tpu_torch.spatial.knn import haversine_knn

    rng = np.random.default_rng(args.seed + 77)
    nums = {}

    def timed(fn):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        return out, time.perf_counter() - t0

    # haversine
    x = torch.as_tensor(geo_rows(rng, RBC_ROWS, RBC_HUBS, 0.02), device=dev)
    q = x[torch.as_tensor(rng.integers(0, RBC_ROWS, RBC_QUERIES),
                          device=dev)]
    q = q + torch.as_tensor(rng.normal(0, 0.01, (RBC_QUERIES, 2)),
                            device=dev).float()
    q[:, 0] = q[:, 0].clamp(-np.pi / 2, np.pi / 2)
    idx, nums["haversine_build_s"] = timed(
        lambda: rbc_build_index(x, metric="haversine", seed=args.seed))
    n_land = idx.landmarks.shape[0]
    check(n_land == int(np.sqrt(RBC_ROWS)), f"{n_land} landmarks")
    rbc_knn_query(idx, q[:64], K, n_probes=RBC_PROBES)     # first call
    (d, i, ex), t = timed(lambda: rbc_knn_query(idx, q, K,
                                                n_probes=RBC_PROBES))
    nums["haversine_batch_ms"] = 1e3 * t
    (od, oi), t = timed(lambda: haversine_knn(x, q, K))
    nums["haversine_oracle_ms"] = 1e3 * t
    exn = ex
    nums["haversine_certified"] = float(exn.float().mean())
    err = ((d[exn] - od[exn]).abs() / od[exn].clamp_min(1e-30)).max()
    nums["haversine_max_rel_err"] = float(err) if exn.any() else 0.0
    bad = ids_up_to_ties(od[exn], oi[exn], i[exn], 1e-5 * od[exn][:, -1:])
    log(f"[{card}] ball cover haversine: {RBC_ROWS} rows, {n_land} "
        f"landmarks, max_list {idx.storage.max_list}; build "
        f"{nums['haversine_build_s']:.2f} s, {RBC_QUERIES}-query batch at "
        f"{RBC_PROBES} probes {nums['haversine_batch_ms']:.1f} ms "
        f"(haversine_knn oracle {nums['haversine_oracle_ms']:.1f} ms); "
        f"certified {nums['haversine_certified']:.4f}, certified queries' "
        f"max relative error {nums['haversine_max_rel_err']:.3g}, {bad} "
        "with ids beyond ties")
    check(nums["haversine_max_rel_err"] <= 1e-5 and bad == 0,
          "ball cover haversine: a certified query differs from the oracle")
    del x, q, idx, d, i, ex, od, oi

    # l2 over 3-d rows
    hubs = rng.uniform(-10, 10, (RBC_HUBS, 3)).astype(np.float32)
    xh = hubs[rng.integers(0, RBC_HUBS, RBC_ROWS)] + rng.normal(
        0, 0.3, (RBC_ROWS, 3)).astype(np.float32)
    x = torch.as_tensor(xh, device=dev)
    q = x[torch.as_tensor(rng.integers(0, RBC_ROWS, RBC_QUERIES),
                          device=dev)]
    q = q + torch.as_tensor(rng.normal(0, 0.1, (RBC_QUERIES, 3)),
                            device=dev).float()
    idx, nums["l2_build_s"] = timed(
        lambda: rbc_build_index(x, seed=args.seed))
    n_land = idx.landmarks.shape[0]
    rbc_knn_query(idx, q[:64], K, n_probes=RBC_PROBES)
    (d, i, ex), t = timed(lambda: rbc_knn_query(idx, q, K,
                                                n_probes=RBC_PROBES))
    nums["l2_batch_ms"] = 1e3 * t
    oi = exact_knn(x, q, K)
    od2 = ((x[oi].double() - q[:, None, :].double()) ** 2).sum(-1)
    # the gram form's f32 error scale of each query
    tol = 1e-6 * ((q * q).sum(1, keepdim=True).double()
                  + float((x * x).sum(1).max()))
    nums["l2_certified"] = float(ex.float().mean())
    diff = ((d.double() ** 2 - od2).abs() - tol)[ex]
    bad = ids_up_to_ties(od2[ex], oi[ex], i[ex], tol[ex])
    nums["l2_max_excess"] = float(diff.max()) if ex.any() else 0.0
    log(f"[{card}] ball cover l2: {RBC_ROWS} x 3 rows, {n_land} landmarks, "
        f"max_list {idx.storage.max_list}; build {nums['l2_build_s']:.2f} s, "
        f"{RBC_QUERIES}-query batch at {RBC_PROBES} probes "
        f"{nums['l2_batch_ms']:.1f} ms; certified {nums['l2_certified']:.4f}"
        f", certified queries' squared distances within 1e-6 (|q|^2 + "
        f"max|x|^2) of the f64 oracle ({nums['l2_max_excess']:.3g} past), "
        f"{bad} with ids beyond ties")
    check(nums["l2_max_excess"] <= 0 and bad == 0,
          "ball cover l2: a certified query differs from the oracle")

    # every ball probed: all certified, every neighbour found
    qf = q[:RBC_FULL_Q]
    (d, i, ex), t = timed(lambda: rbc_knn_query(idx, qf, K,
                                                n_probes=n_land))
    nums["l2_full_probe_ms"] = 1e3 * t
    nums["l2_full_recall"] = recall(i, oi[:RBC_FULL_Q])
    bad = ids_up_to_ties(od2[:RBC_FULL_Q], oi[:RBC_FULL_Q], i,
                         tol[:RBC_FULL_Q])
    log(f"[{card}] ball cover l2, {RBC_FULL_Q} queries probing all "
        f"{n_land} balls: {nums['l2_full_probe_ms']:.1f} ms (query blocks "
        f"bound the candidate gather), certified {int(ex.sum())} of "
        f"{RBC_FULL_Q}, recall@10 {nums['l2_full_recall']:.4f} ({bad} "
        "queries with ids beyond ties)")
    check(bool(ex.all()) and bad == 0,
          "ball cover l2 with every ball probed: not all certified exact")
    del d, i, ex, oi, od2

    # all-kNN over a sample index. A row within 1e-3 (squared) of another
    # is left out of the sample: the f32 gram form cannot order such a
    # pair against a row's own zero distance (its error is ~1e-4 here)
    pick = x[torch.as_tensor(np.sort(rng.choice(
        RBC_ROWS, RBC_SAMPLE + RBC_SAMPLE // 8, replace=False)), device=dev)]
    nn = exact_knn(pick, pick, 2)
    sep = ((pick[nn].double() - pick[:, None, :].double()) ** 2).sum(-1)
    sep = torch.where(nn == torch.arange(pick.shape[0], device=dev)[:, None],
                      float("inf"), sep).min(1).values
    far = torch.nonzero(sep >= 1e-3).flatten()
    check(far.numel() >= RBC_SAMPLE, f"only {far.numel()} separated rows")
    nums["all_knn_dropped"] = pick.shape[0] - far.numel()
    sample = pick[far[:RBC_SAMPLE]]
    del pick, nn, sep, far
    small, nums["all_knn_build_s"] = timed(
        lambda: rbc_build_index(sample, seed=args.seed))
    (d, i, ex), t = timed(lambda: rbc_all_knn_query(small, 4,
                                                    n_probes=RBC_PROBES))
    nums["all_knn_ms"] = 1e3 * t
    self_first = bool(torch.equal(
        i[:, 0].long(), torch.arange(RBC_SAMPLE, device=dev)))
    log(f"[{card}] ball cover all-kNN over {RBC_SAMPLE} sampled rows "
        f"({nums['all_knn_dropped']} of the draw within 1e-3 of another "
        f"left out): build "
        f"{nums['all_knn_build_s']:.2f} s, query {nums['all_knn_ms']:.1f} "
        f"ms, certified {float(ex.float().mean()):.4f}, every row its own "
        f"first neighbour: {self_first}")
    check(self_first, "rbc_all_knn_query: a row's first neighbour is "
          "not itself")
    return nums


def library_phase(args, card, dev, index, qcaps, x):
    """The library's public entry surface over the IVF-Flat cell's data:
    ``approx_knn_build_index`` / ``approx_knn_search`` (auto at 4,096 ->
    the grouped kernel engine, 8 -> per query, throughput at 512), each
    answer bitwise the direct call's, recall within 0.005 of the served
    index's; the ``pylibraft`` facade on a CUDA ``Handle``
    (``neighbors.ivf_flat`` against the direct calls, ``brute_force.knn``
    over the 1M rows on the fused kernels bitwise ``brute_force_knn``,
    ``cluster.fit`` / ``predict`` / ``cluster_cost``, ``KMeans`` with
    ``transform``, ``distance.pairwise_distance`` with numpy and CUDA
    ``out=``, ``fused_l2_nn_argmin`` and a ``mask_op`` across a 65,536-row
    block); then random ball cover (:func:`ball_cover_step`). #2, #6 and
    #7 are counted over the phase, and every call held against its plain
    version (those launches taken back out). Returns the numbers."""
    from raft_tpu_torch import pylibraft
    from raft_tpu_torch.distance import fused_l2_nn
    from raft_tpu_torch.spatial import brute_force_knn
    from raft_tpu_torch.spatial import fused_knn as fz
    from raft_tpu_torch.spatial.ann import (
        IVFFlatParams, approx_knn_build_index, approx_knn_search,
        ivf_flat_search, ivf_flat_search_grouped,
    )
    from raft_tpu_torch.spatial.ann import flat_kernel as fk

    rng = np.random.default_rng(args.seed + 61)
    nums = {"card": card}
    params = IVFFlatParams(n_lists=N_LISTS, kmeans_n_iters=10,
                           kmeans_init="random")
    xd = torch.as_tensor(x, device=dev)
    qb = torch.as_tensor(
        x[rng.integers(0, N_ROWS, max(BUCKETS))]
        + 0.3 * rng.standard_normal((max(BUCKETS), DIM), dtype=np.float32),
        device=dev)
    true = exact_knn(xd, qb, K)

    def same(a, b, what):
        check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
              f"{what}: not bitwise the direct call")

    def timed(fn):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        return out, time.perf_counter() - t0

    # the path's launches: those of the approx_knn_* and facade calls
    # alone, not of the direct calls they are compared with
    path = {"flat_scan_lists": 0, "chunk_mins": 0, "rescore_scores": 0}

    def counted(fn):
        """``timed(fn)``, its #2 / #6 / #7 launches added to ``path``.
        Returns (out, seconds, launches of this call by kernel)."""
        b0, z0 = fk.LAUNCHES, dict(fz.LAUNCHES)
        out, t = timed(fn)
        n = {"flat_scan_lists": fk.LAUNCHES - b0,
             "chunk_mins": fz.LAUNCHES["chunk_mins"] - z0["chunk_mins"],
             "rescore_scores": (fz.LAUNCHES["rescore_scores"]
                                - z0["rescore_scores"])}
        for key, v in n.items():
            path[key] += v
        return out, t, n

    fk.LAUNCHES = 0
    engine_fallbacks("ivf_flat", reset=True)
    for key in fz.LAUNCHES:
        fz.LAUNCHES[key] = 0
    keep, fkeep = [], {}
    with scan_calls(keep) as shapes, fused_calls(fkeep) as fshapes:
        # approx_knn_* on the IVF-Flat cell
        built, nums["approx_build_s"], _ = counted(
            lambda: approx_knn_build_index(x, params, device=dev))
        check(built.device.type == dev.type, f"approx build on {built.device}")
        nbig = max(BUCKETS)
        for nq, mode, grouped in ((nbig, "auto", True),
                                  (8, "auto", False),
                                  (512, "throughput", True)):
            q = qb[:nq]
            got, t, n = counted(lambda: approx_knn_search(built, q, K,
                                                          n_probes=N_PROBES,
                                                          mode=mode))
            n = n["flat_scan_lists"]
            direct = ivf_flat_search_grouped if grouped else ivf_flat_search
            same(got, direct(built, q, K, n_probes=N_PROBES),
                 f"approx_knn_search {mode} at {nq}")
            check(n == (1 if grouped else 0),
                  f"approx_knn_search {mode} at {nq}: {n} flat-scan "
                  "launches")
            nums[f"approx_{mode}_{nq}_ms"] = 1e3 * t
            if nq == nbig:
                nums["approx_recall"] = recall(got[1], true)
        _, served_ids = ivf_flat_search_grouped(
            index, qb, K, n_probes=N_PROBES, qcap=qcaps[max(BUCKETS)])
        nums["served_recall"] = recall(served_ids, true)
        _, t = timed(lambda: ivf_flat_search_grouped(built, qb, K,
                                                     n_probes=N_PROBES))
        nums["direct_grouped_ms"] = 1e3 * t
        log(f"[{card}] approx_knn_build_index: {N_ROWS} x {DIM} in "
            f"{nums['approx_build_s']:.2f} s; approx_knn_search bitwise the "
            f"direct calls (auto {nbig} -> grouped "
            f"{nums[f'approx_auto_{nbig}_ms']:.2f} ms against the direct "
            f"call's {nums['direct_grouped_ms']:.2f} ms, auto 8 -> per query "
            f"{nums['approx_auto_8_ms']:.2f} ms, throughput 512 "
            f"{nums['approx_throughput_512_ms']:.2f} ms); recall@10 "
            f"{nums['approx_recall']:.4f} against the served index's "
            f"{nums['served_recall']:.4f}")
        check(abs(nums["approx_recall"] - nums["served_recall"]) <= 0.005,
              "approx build's recall is not within 0.005 of the served "
              "index's")

        # the pylibraft facade on a CUDA handle
        h = pylibraft.Handle(device=dev)
        nb = pylibraft.neighbors
        fidx, nums["facade_build_s"], _ = counted(
            lambda: nb.ivf_flat.build(x, params, handle=h))
        q64 = qb[:64].cpu().numpy()
        got, _, _ = counted(lambda: nb.ivf_flat.search(
            fidx, q64, K, n_probes=N_PROBES, handle=h))
        same(got, ivf_flat_search(fidx, qb[:64], K, n_probes=N_PROBES),
             "pylibraft ivf_flat.search")
        qbf = qb[:LIB_BF_QUERIES]
        # the expanded l2 (brute_force_knn's default) takes the fused
        # kernels; the facade's own default, "l2", is the unexpanded scan
        got, t, bf_launches = counted(lambda: nb.brute_force.knn(
            x, qbf, K, metric="l2_sqrt_expanded", handle=h))
        nums["facade_bf_ms"] = 1e3 * t
        same(got, brute_force_knn(xd, qbf, K, metric="l2_sqrt_expanded"),
             "pylibraft brute_force.knn")
        nums["facade_bf_recall"] = recall(got[1], true[:LIB_BF_QUERIES])
        # phase 2's kernel reads 128-wide chunks of rows whose width is a
        # multiple of 128 (the JAX package's rule too); at width 96 the
        # rescore gathers. The same call over 1M rows of SIFT's width 128
        # runs both kernels.
        gen = torch.Generator(device=dev).manual_seed(args.seed + 62)
        c128 = 2.0 * torch.randn((2000, 128), generator=gen, device=dev)
        x128 = c128[torch.randint(0, 2000, (N_ROWS,), generator=gen,
                                  device=dev)]
        x128 += torch.randn(x128.shape, generator=gen, device=dev)
        q128 = x128[:LIB_BF_QUERIES] + 0.3 * torch.randn(
            (LIB_BF_QUERIES, 128), generator=gen, device=dev)
        got, t, bf128 = counted(lambda: nb.brute_force.knn(
            x128, q128, K, metric="l2_sqrt_expanded", handle=h))
        nums["facade_bf128_ms"] = 1e3 * t
        same(got, brute_force_knn(x128, q128, K,
                                  metric="l2_sqrt_expanded"),
             "pylibraft brute_force.knn at width 128")
        nums["facade_bf128_recall"] = recall(got[1], exact_knn(x128, q128,
                                                               K))
        del x128, c128
        check(bf_launches["chunk_mins"] > 0 and bf128["chunk_mins"] > 0
              and bf128["rescore_scores"] > 0,
              f"pylibraft brute_force.knn did not take the fused kernels: "
              f"width {DIM} {bf_launches}, width 128 {bf128}")
        log(f"[{card}] pylibraft: ivf_flat.build {nums['facade_build_s']:.2f}"
            f" s, ivf_flat.search bitwise the direct call; brute_force.knn "
            f"at {LIB_BF_QUERIES} queries, bitwise brute_force_knn: over "
            f"{N_ROWS} x {DIM} {nums['facade_bf_ms']:.2f} ms ({bf_launches}"
            f", the rescore gathered), recall@10 "
            f"{nums['facade_bf_recall']:.4f}; over {N_ROWS} x 128 "
            f"{nums['facade_bf128_ms']:.2f} ms ({bf128}), recall@10 "
            f"{nums['facade_bf128_recall']:.4f}")
        check(min(nums["facade_bf_recall"], nums["facade_bf128_recall"])
              >= 0.999, "brute-force recall below 0.999")

    # the kernel calls of the phase (the direct calls' too) against their
    # plain versions; only the path's launches go into the kernels line
    nums["launches"] = path["flat_scan_lists"]
    nums["fused_launches"] = {k: path[k]
                              for k in ("chunk_mins", "rescore_scores")}
    check(engine_fallbacks("ivf_flat") == 0,
          f"{engine_fallbacks("ivf_flat")} library searches left the kernel")
    phase_all = {"flat_scan_lists": fk.LAUNCHES, **fz.LAUNCHES}
    nums["max_abs_err"] = max(compare_lists_to_plain(c) for c in keep)
    ferr = {"chunk_mins": 0.0, "rescore_scores": 0.0}
    for key, call in fkeep.items():
        if key[0] == "chunk_mins":
            ferr["chunk_mins"] = max(ferr["chunk_mins"],
                                     compare_chunk_mins(*call))
        elif key[0] == "rescore_scores" and isinstance(key, tuple):
            ferr["rescore_scores"] = max(ferr["rescore_scores"],
                                         compare_rescore(*call))
    nums["fused_max_abs_err"] = ferr
    log(f"[{card}] library phase kernels: the path's approx_knn_* and "
        f"facade calls launched {path} (the phase with its direct "
        f"reference calls {phase_all}); flat_scan_lists by (Q, Lpad) "
        f"{dict(shapes)}, each within 1e-5 x (qn + yn) of the plain "
        f"version (max {nums['max_abs_err']:.3g}); fused by shape "
        f"{ {k: dict(v) for k, v in fshapes.items()} }, within the f32 "
        f"summation bound (max {ferr})")
    check(path["flat_scan_lists"] > 0,
          "the library path never launched flat_scan_lists")
    del keep, fkeep, built, fidx

    # clustering and distances through the facade (no kernel of the port)
    cl = pylibraft.cluster
    (cents, labels, inertia, n_iter), nums["cluster_fit_s"] = timed(
        lambda: cl.fit(x, N_LISTS, max_iter=10, handle=h))
    pred = cl.predict(x, cents, handle=h)
    cost = cl.cluster_cost(x, cents, handle=h)
    minv, _ = fused_l2_nn(xd, cents)
    check(torch.equal(pred, labels) and torch.equal(cost, minv.sum()),
          "cluster.predict / cluster_cost disagree with fit / fused_l2_nn")
    log(f"[{card}] pylibraft cluster.fit: {N_LISTS} clusters, {n_iter} "
        f"iterations in {nums['cluster_fit_s']:.2f} s, inertia "
        f"{float(inertia):.6g}; predict equals the fit's labels, "
        "cluster_cost the sum of fused_l2_nn's minima")
    from raft_tpu_torch.cluster import KMeans

    km, nums["kmeans_fit_s"] = timed(
        lambda: KMeans(n_clusters=N_LISTS, max_iter=10).fit(xd))
    tr = km.transform(qb)
    kp = km.predict(qb)
    at = tr.gather(1, kp.long()[:, None])[:, 0]
    check(bool((at <= tr.min(1).values * (1 + 1e-5) + 1e-5).all()),
          "KMeans.transform's argmin is not predict's label up to ties")
    nums["kmeans_transform_agree"] = float(
        (tr.argmin(1) == kp.long()).float().mean())
    log(f"[{card}] KMeans(n_clusters={N_LISTS}, max_iter=10).fit "
        f"{nums['kmeans_fit_s']:.2f} s; transform {tuple(tr.shape)}, its "
        f"argmin equals predict on {nums['kmeans_transform_agree']:.4f} of "
        "the rows, the rest at ties")
    del km, tr

    ds = pylibraft.distance
    m_, n_ = LIB_PAIRWISE
    xq, yq = qb[:m_], xd[:n_]
    out_np = np.zeros((m_, n_), np.float32)
    dmat, t = timed(lambda: ds.pairwise_distance(xq, yq, out_np, handle=h))
    nums["pairwise_ms"] = 1e3 * t
    out_t = torch.empty((m_, n_), device=dev)
    d2 = ds.pairwise_distance(xq, yq, out_t, handle=h)
    check(torch.equal(out_t, dmat) and torch.equal(d2, dmat)
          and np.array_equal(out_np, dmat.cpu().numpy()),
          "pairwise_distance out= (numpy / CUDA tensor) not written")
    del out_np, out_t, d2, dmat
    am = ds.fused_l2_nn_argmin(qb, xd, handle=h)
    check(torch.equal(am, fused_l2_nn(qb, xd)[1]),
          "fused_l2_nn_argmin against fused_l2_nn")
    colour_r = torch.as_tensor(rng.integers(0, 3, LIB_MASK_ROWS), device=dev)
    colour_c = torch.as_tensor(rng.integers(0, 3, N_LISTS), device=dev)
    xm = xd[:LIB_MASK_ROWS]
    mv, mi = fused_l2_nn(xm, cents, mask_op=lambda r, c: (
        colour_r[r] != colour_c[c]))
    blk = importlib.import_module(
        "raft_tpu_torch.distance.fused_l2_nn")._ROW_BLOCK
    lo, hi = blk - 500, blk + 500
    sv, si = fused_l2_nn(xm[lo:hi], cents, mask_op=lambda r, c: (
        colour_r[r + lo] != colour_c[c]))
    check(torch.equal(mv[lo:hi], sv) and torch.equal(mi[lo:hi], si)
          and bool((colour_c[mi.long()] != colour_r).all()),
          "fused_l2_nn's mask_op across the 65,536-row block boundary")
    log(f"[{card}] pylibraft distance: pairwise_distance {m_} x {n_} "
        f"{nums['pairwise_ms']:.1f} ms (out= numpy and CUDA tensor "
        "written), fused_l2_nn_argmin equal to fused_l2_nn's ids, a "
        "same-colour mask_op across the 65,536-row block boundary equal to "
        "the rows searched alone")
    del xm, mv, mi, cents, labels, xd

    nums["ball_cover"] = ball_cover_step(args, card, dev)
    return nums


# ---------------------------------------------------------------------------
# Single linkage and spectral partitioning (sparse/hierarchy.py, spectral/)
# ---------------------------------------------------------------------------

# single linkage as cuML's AgglomerativeClustering(linkage="single",
# connectivity="knn") takes it from RAFT: SIFT's width, 262,144 rows
# around 512 well-separated centres (uniform in [-10, 10]^128, unit
# Gaussian noise), k = 16 (raft_tpu/sparse/hierarchy.py:176), 512 clusters
LINK_ROWS, LINK_DIM, LINK_CENTRES, LINK_K = 262_144, 128, 512, 16
# spectral partitioning: 131,072 x 128 rows around 8 centres 8 sigma apart
# in random directions, scaled by 0.01 (the Laplacian's spectrum O(10));
# at this spread the k = 16 graph is one component (PERF.md §4;
# raft_tpu_torch/tools/sweep_spectral.py's corpus)
SPEC_ROWS, SPEC_CENTRES, SPEC_SEP, SPEC_SCALE = 131_072, 8, 8.0, 0.01
SPEC_SUB = 4096            # rows of the dense-eigh check


def labels_match(got, truth):
    """Whether two labelings are equal up to a permutation of the ids."""
    got, truth = got.long(), truth.long()
    pairs = torch.unique(got * (int(truth.max()) + 1) + truth).numel()
    return pairs == torch.unique(got).numel() == torch.unique(truth).numel()


def reset_fused_counts():
    from raft_tpu_torch import native
    from raft_tpu_torch.spatial import fused_knn as fz
    from raft_tpu_torch.spatial import knn as bfk

    for key in fz.LAUNCHES:
        fz.LAUNCHES[key] = 0
    bfk.SCAN_FALLBACKS = 0
    fz.RESCORE_GATHER_CALLS = 0
    native.NATIVE_FALLBACKS = 0


def check_fused_path(what, launches):
    """The path's #6 and #7 launches, and no route that hides the card."""
    from raft_tpu_torch import native
    from raft_tpu_torch.spatial import fused_knn as fz
    from raft_tpu_torch.spatial import knn as bfk

    check(launches["chunk_mins"] > 0 and launches["rescore_scores"] > 0,
          f"{what}: the kNN graph did not launch both fused kernels "
          f"({launches})")
    check(bfk.SCAN_FALLBACKS == 0,
          f"{what}: {bfk.SCAN_FALLBACKS} partitions left the fused kernels")
    check(fz.RESCORE_GATHER_CALLS == 0,
          f"{what}: {fz.RESCORE_GATHER_CALLS} calls took the gather rescore")
    check(native.NATIVE_FALLBACKS == 0,
          f"{what}: {native.NATIVE_FALLBACKS} host routes left the native "
          "library")


def compare_fused_calls(calls):
    """Every kept #6 / #7 call against its plain version; returns the max
    |kernel - plain| of each."""
    errs = {"chunk_mins": 0.0, "rescore_scores": 0.0}
    for name, call in calls:
        fn = compare_chunk_mins if name == "chunk_mins" else compare_rescore
        errs[name] = max(errs[name], fn(*call))
    return errs


def timed_s(fn, dev):
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


def linkage_phase(args, card, dev, feed):
    """Single linkage (``sparse.hierarchy.single_linkage``) over 262,144 x
    128 rows around 512 centres: the kNN graph on the fused kernels (16
    query blocks, #6 and #7), the Borůvka MST and the connect-components
    rounds on the card, the dendrogram on the native host library. The
    labels must equal the centres up to a permutation, the stitching
    must hold (:func:`stitch_checks`: ROADMAP C4's repair and an 8-cluster
    cut against a host oracle), and the same call with the graph on the
    scan path must agree (labels, MST weight within 1e-5 relative);
    every #6 / #7 call of the path is held against its plain version.
    Then :func:`spectral_step`. Returns the numbers; ``feed`` receives
    the labels and rows :func:`toolkit_phase` reads."""
    from raft_tpu_torch.sparse import knn_graph
    from raft_tpu_torch.sparse.hierarchy import single_linkage
    from raft_tpu_torch.spatial import fused_knn as fz
    from raft_tpu_torch.tools.sweep_spectral import purity

    nums = {"card": card}
    gen = torch.Generator(device=dev).manual_seed(args.seed + 71)
    centres = 20.0 * torch.rand((LINK_CENTRES, LINK_DIM), generator=gen,
                                device=dev) - 10.0
    truth = torch.randint(0, LINK_CENTRES, (LINK_ROWS,), generator=gen,
                          device=dev)
    x = centres[truth] + torch.randn((LINK_ROWS, LINK_DIM), generator=gen,
                                     device=dev)
    del centres

    # the main path, with every counter at 0 just before it
    reset_fused_counts()
    keep, calls, stats = {}, [], {}
    with fused_calls(keep, calls) as shapes:
        res = single_linkage(x, n_clusters=LINK_CENTRES, k=LINK_K,
                             stats=stats)
    launches = {k: fz.LAUNCHES[k] for k in ("chunk_mins", "rescore_scores")}
    check_fused_path("single linkage", launches)
    check(res.labels.device.type == dev.type,
          f"linkage labels on {res.labels.device}")
    check(labels_match(res.labels, truth),
          "single linkage's labels are not the generating centres up to a "
          "permutation")
    nums.update(
        fused_launches=launches,
        launches_by_shape={k: {"x".join(map(str, s)): v for s, v in c.items()}
                           for k, c in shapes.items()},
        knn_graph_s=stats["knn_graph_s"], mst_s=stats["mst_s"],
        dendrogram_s=stats["dendrogram_s"], total_s=stats["total_s"],
        mst_solves=len(stats["mst"]),
        mst_rounds=[m["rounds"] for m in stats["mst"]],
        mst_syncs=[m["syncs"] for m in stats["mst"]],
        mst_solve_s=[m["seconds"] for m in stats["mst"]],
        connect_s=stats["connect_s"],
        connect_rounds=stats["connect_rounds"],
        component_syncs=stats["component_syncs"],
        mst_weight=float(res.deltas.sum()),
        forest_weight=stats["forest_weight"],
        stitch_edges=LINK_ROWS - 1 - stats["forest_edges"],
        purity=purity(res.labels, truth))
    nums["knn_share"] = nums["knn_graph_s"] / nums["total_s"]
    log(f"[{card}] single_linkage {LINK_ROWS} x {LINK_DIM}, k {LINK_K}, "
        f"{LINK_CENTRES} clusters: kNN graph {nums['knn_graph_s']:.2f} s "
        f"({nums['knn_share']:.1%} of {nums['total_s']:.2f} s; #6 / #7 "
        f"launches {launches}), MST + connect {nums['mst_s']:.2f} s "
        f"({nums['mst_solves']} Borůvka solves, rounds {nums['mst_rounds']}, "
        f"host syncs {nums['mst_syncs']} = {sum(nums['mst_syncs'])}, "
        f"seconds {[round(v, 3) for v in nums['mst_solve_s']]}; "
        f"{nums['connect_rounds']} connect_components rounds, seconds "
        f"{[round(v, 3) for v in nums['connect_s']]}, "
        f"{nums['component_syncs']} component-count syncs), dendrogram "
        f"{nums['dendrogram_s']:.3f} s; MST weight {nums['mst_weight']:.9g} "
        f"with its {nums['stitch_edges']} stitching edges in the graph's "
        f"metric, the kNN graph's own forest "
        f"{nums['forest_weight']:.9g}; labels equal the centres up to a permutation (purity "
        f"{nums['purity']})")
    nums["stitching"] = stitch_checks(x, res, stats, card)
    feed.update(link_labels=res.labels, link_truth=truth)

    # the same call with the graph on the scan path
    before = dict(fz.LAUNCHES)
    scan_stats = {}
    scan_graph, nums["scan_knn_graph_s"] = timed_s(
        lambda: knn_graph(x, LINK_K, use_fused=False), dev)
    scan, scan_call_s = timed_s(lambda: single_linkage(
        x, n_clusters=LINK_CENTRES, graph=scan_graph, stats=scan_stats), dev)
    nums["scan_total_s"] = nums["scan_knn_graph_s"] + scan_call_s
    check(fz.LAUNCHES == before, "the scan-path linkage launched a fused "
          "kernel")
    nums["scan_mst_weight"] = float(scan.deltas.sum())
    nums["scan_forest_weight"] = scan_stats["forest_weight"]
    rel = abs(nums["scan_mst_weight"] - nums["mst_weight"]) / nums[
        "mst_weight"]
    rel_forest = abs(nums["scan_forest_weight"] - nums["forest_weight"]) / (
        nums["forest_weight"])
    nums.update(scan_weight_rel=rel, scan_forest_rel=rel_forest)
    check(labels_match(scan.labels, res.labels),
          "fused and scan-path graphs give different labels")
    check(rel <= 1e-5 and rel_forest <= 1e-5,
          f"fused and scan-path MST weights {rel:.3g} apart (forests "
          f"{rel_forest:.3g})")
    log(f"[{card}] the scan-path graph: kNN graph "
        f"{nums['scan_knn_graph_s']:.2f} s, total "
        f"{nums['scan_total_s']:.2f} s, labels equal the fused path's up to "
        f"a permutation, MST weight {nums['scan_mst_weight']:.9g} "
        f"({rel:.3g} relative), forest {nums['scan_forest_weight']:.9g} "
        f"({rel_forest:.3g} relative)")
    del scan_graph
    del scan, res, x, truth

    nums["max_abs_err"] = compare_fused_calls(calls)
    log(f"[{card}] linkage path's {len(calls)} fused calls each within the "
        f"f32 summation bound of the plain version (max |kernel - plain| "
        f"{nums['max_abs_err']})")
    del keep, calls

    nums["spectral"] = spectral_step(args, card, dev, feed)
    for key, v in nums["spectral"]["fused_launches"].items():
        nums["fused_launches"][key] += v
    for key, v in nums["spectral"]["max_abs_err"].items():
        nums["max_abs_err"][key] = max(nums["max_abs_err"][key], v)
    return nums


def stitch_checks(x, res, stats, card):
    """ROADMAP C4's repair on the card. The connect rounds stay 3 and
    their round-1 pairs those of ``connect_components`` on the kNN
    forest's colours; no pair enters the graph twice; each stitching edge
    carries its pair's distance (within 1e-5 relative of the f64 host
    distance); the MST is the kNN forest plus the stitching edges. Then
    the dendrogram cut into 8 clusters (merges above the kNN graph's
    components) against a numpy f64 oracle of the same cut on the same
    MST edges. Returns the numbers."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    from raft_tpu_torch.sparse.connect import connect_components
    from raft_tpu_torch.sparse.hierarchy import extract_flattened_clusters

    n = x.shape[0]
    rounds = stats["connect_rounds"]
    check(rounds == 3, f"{rounds} connect rounds, not 3")
    pairs = [(min(a, b), max(a, b)) for rows, cols, _, _ in stats["stitches"]
             for a, b in zip(rows.tolist(), cols.tolist())]
    repeats = [r for _, _, _, r in stats["stitches"]]
    check(len(pairs) == len(set(pairs)),
          f"{len(pairs) - len(set(pairs))} stitching pairs entered twice")
    # round 1 again, from the forest's colours: the same pairs
    fc = torch.as_tensor(stats["forest_color"], device=x.device)
    extra = connect_components(x, fc)
    k1 = int(extra.nnz)
    raw = {(min(a, b), max(a, b)) for a, b in zip(
        extra.rows[:k1].tolist(), extra.cols[:k1].tolist())}
    rows1, cols1, _, _ = stats["stitches"][0]
    check(raw == {(min(a, b), max(a, b)) for a, b in zip(rows1.tolist(),
                                                         cols1.tolist())},
          "round 1's stitching pairs are not connect_components' pairs")
    check(k1 - len(raw) == repeats[0],
          f"round 1: {k1} edges, {len(raw)} pairs, {repeats[0]} repeats")

    src, dst, w = stats["mst_edges"]
    forest = stats["forest_color"]
    cross = forest[src] != forest[dst]
    n_cross = int(cross.sum())
    check(n_cross == n - 1 - stats["forest_edges"],
          f"{n_cross} MST edges cross the kNN forest's components, not "
          f"{n - 1 - stats['forest_edges']}")
    # every stitching edge (entered and in the MST) against f64
    s_rows = np.concatenate([r for r, _, _, _ in stats["stitches"]])
    s_cols = np.concatenate([c for _, c, _, _ in stats["stitches"]])
    s_w = np.concatenate([v for _, _, v, _ in stats["stitches"]])
    xh = x.cpu().double()

    def f64_dist(a, b):
        a, b = torch.as_tensor(a).long(), torch.as_tensor(b).long()
        return torch.sqrt(((xh[a] - xh[b]) ** 2).sum(1)).numpy()

    rel = np.abs(s_w - f64_dist(s_rows, s_cols)) / f64_dist(s_rows, s_cols)
    rel_mst = np.abs(w[cross] - f64_dist(src[cross], dst[cross])) / \
        f64_dist(src[cross], dst[cross])
    check(rel.max() <= 1e-5 and rel_mst.max() <= 1e-5,
          f"a stitching edge {max(rel.max(), rel_mst.max()):.3g} from its "
          "pair's f64 distance")
    stitch_w = float(w[cross].astype(np.float64).sum())
    mst_w = float(res.deltas.astype(np.float64).sum())
    gap = abs(mst_w - (stats["forest_weight"] + stitch_w)) / mst_w
    check(gap <= 1e-9, f"the MST weight {mst_w:.9g} is not the forest plus "
          f"the stitching edges ({gap:.3g} apart)")

    # the cut into 8 clusters against the f64 oracle on the same edges
    cut = 8
    labels = extract_flattened_clusters(res.children, n, cut)
    order = np.argsort(w.astype(np.float64), kind="stable")
    keep = order[:n - cut]
    g = coo_matrix((np.ones(keep.shape[0]), (src[keep], dst[keep])),
                   shape=(n, n))
    n_comp, oracle = connected_components(g, directed=False)
    top = np.sort(w.astype(np.float64))[::-1][:cut]
    check(n_comp == cut and labels_match(torch.as_tensor(labels),
                                         torch.as_tensor(oracle)),
          f"the {cut}-cluster cut is not the f64 oracle's ({n_comp} "
          "components)")
    out = dict(connect_rounds=rounds, stitch_pairs=len(pairs),
               repeats_dropped=repeats, stitch_weight=stitch_w,
               stitch_mean=stitch_w / max(n_cross, 1),
               stitch_max_rel=float(max(rel.max(), rel_mst.max())),
               cut_heights=top.tolist(),
               cut_sizes=sorted(np.bincount(labels).tolist()))
    log(f"[{card}] C4 on the card: {rounds} connect rounds, {len(pairs)} "
        f"stitching pairs each entered once ({repeats} repeats dropped; "
        f"round 1's pairs are connect_components' on the forest), "
        f"{n_cross} in the MST at mean {out['stitch_mean']:.4f}, each "
        f"within {out['stitch_max_rel']:.3g} of its f64 distance; MST "
        f"{mst_w:.9g} = forest {stats['forest_weight']:.9g} + stitches "
        f"{stitch_w:.9g}; the {cut}-cluster cut (heights "
        f"{[round(float(v), 4) for v in top]}, sizes {out['cut_sizes']}) equals "
        "the f64 oracle's")
    return out


def spectral_step(args, card, dev, feed):
    """Spectral partitioning over 131,072 x 128 rows around 8 centres:
    the k = 16 kNN graph on the fused kernels (8 query blocks), one
    component, ``fit_embedding`` and ``partition`` (Lanczos over the CSR
    Laplacian, then k-means) with purity >= 0.95 against the centres;
    on a 4,096-row subsample the 8 smallest Lanczos eigenvalues equal the
    dense Laplacian's (f64 ``eigvalsh``) within 1e-4 relative, 1e-5
    absolute. Returns the numbers."""
    from raft_tpu_torch.linalg import lanczos_smallest_eigenvectors
    from raft_tpu_torch.sparse import csr_from_coo, knn_graph
    from raft_tpu_torch.sparse.connect import get_n_components
    from raft_tpu_torch.sparse.linalg import fit_embedding
    from raft_tpu_torch.sparse.mst import boruvka_mst
    from raft_tpu_torch.spatial import fused_knn as fz
    from raft_tpu_torch.spectral import (
        ClusterSolverConfig, EigenSolverConfig, LaplacianMatrix,
        analyze_partition, partition,
    )
    from raft_tpu_torch.tools.sweep_spectral import corpus, purity

    nums = {}
    gen = torch.Generator(device=dev).manual_seed(args.seed + 72)
    x, truth = corpus(SPEC_ROWS, SPEC_SEP, gen, dev, centres=SPEC_CENTRES,
                      dim=LINK_DIM, scale=SPEC_SCALE)

    reset_fused_counts()
    calls = []
    with fused_calls({}, calls):
        graph, nums["knn_graph_s"] = timed_s(lambda: knn_graph(x, LINK_K),
                                             dev)
    launches = {k: fz.LAUNCHES[k] for k in ("chunk_mins", "rescore_scores")}
    check_fused_path("spectral", launches)
    nums["fused_launches"] = launches
    n_comp = int(get_n_components(boruvka_mst(graph).color))
    check(n_comp == 1, f"the spectral corpus's k = {LINK_K} graph has "
          f"{n_comp} components")
    csr = csr_from_coo(graph)
    valid = graph.valid_mask()
    cross = (truth[graph.rows[valid].long()]
             != truth[graph.cols[valid].long()]).float().mean().item()

    info_e = {}
    emb, nums["fit_embedding_s"] = timed_s(
        lambda: fit_embedding(csr, SPEC_CENTRES, info=info_e), dev)
    check(tuple(emb.shape) == (SPEC_ROWS, SPEC_CENTRES)
          and bool(torch.isfinite(emb).all()),
          f"fit_embedding gave {tuple(emb.shape)} or non-finite values")
    info_p = {}
    res, nums["partition_s"] = timed_s(lambda: partition(
        csr, EigenSolverConfig(n_eig_vecs=SPEC_CENTRES),
        ClusterSolverConfig(n_clusters=SPEC_CENTRES), info=info_p), dev)
    nums["purity"] = purity(res.labels, truth)
    cut, cost = analyze_partition(csr, res.labels, SPEC_CENTRES)
    nums.update(
        components=n_comp, cross_edge_share=cross,
        embedding_restarts=info_e["restarts"],
        embedding_residuals=info_e["residuals"].tolist(),
        partition_restarts=info_p["restarts"],
        partition_residuals=info_p["residuals"].tolist(),
        eigenvalues=res.eigenvalues.tolist(), kmeans_iters=res.kmeans_iters,
        edge_cut=float(cut), cost=float(cost))
    log(f"[{card}] spectral {SPEC_ROWS} x {LINK_DIM}, {SPEC_CENTRES} "
        f"centres: kNN graph {nums['knn_graph_s']:.2f} s (#6 / #7 "
        f"{launches}), one component, cross-centre edges "
        f"{cross:.4%}; fit_embedding {nums['fit_embedding_s']:.2f} s "
        f"({info_e['restarts']} restarts, max residual "
        f"{max(nums['embedding_residuals']):.3g}); partition "
        f"{nums['partition_s']:.2f} s ({info_p['restarts']} restarts, max "
        f"residual {max(nums['partition_residuals']):.3g}, eigenvalues "
        f"{nums['eigenvalues']}, {res.kmeans_iters} k-means iterations): "
        f"purity {nums['purity']:.6f}, edge cut {nums['edge_cut']:.6g}, "
        f"cost {nums['cost']:.6g}")
    check(nums["purity"] >= 0.95,
          f"spectral purity {nums['purity']:.4f} below 0.95")
    feed.update(spec_x=x, spec_labels=res.labels, spec_truth=truth)
    del emb, res, csr, graph

    # the subsample: Lanczos against the dense Laplacian's eigenvalues
    pick = torch.randperm(SPEC_ROWS, generator=torch.Generator().manual_seed(
        args.seed + 73))[:SPEC_SUB].to(dev)
    sub = csr_from_coo(knn_graph(x[pick], LINK_K))
    lap = LaplacianMatrix(sub)
    w, _, resid, restarts = lanczos_smallest_eigenvectors(
        lap.matvec, SPEC_SUB, SPEC_CENTRES, tol=1e-6, max_iter=4000,
        return_info=True, device=dev)
    a = sub.to_dense().double()
    want = torch.linalg.eigvalsh(torch.diag(a.sum(1)) - a)[:SPEC_CENTRES]
    err = (w.double() - want).abs()
    nums.update(sub_restarts=restarts, sub_eigenvalues=w.tolist(),
                sub_dense_eigenvalues=want.tolist(),
                sub_max_err=float(err.max()))
    log(f"[{card}] spectral subsample {SPEC_SUB} rows: Lanczos "
        f"({restarts} restarts) {nums['sub_eigenvalues']} against f64 "
        f"eigvalsh {nums['sub_dense_eigenvalues']}, max |diff| "
        f"{nums['sub_max_err']:.3g}")
    check(bool((err <= torch.clamp_min(1e-4 * want.abs(), 1e-5)).all()),
          "the subsample's Lanczos eigenvalues are not within 1e-4 "
          "relative (1e-5 absolute) of the dense Laplacian's")
    nums["max_abs_err"] = compare_fused_calls(calls)
    log(f"[{card}] spectral path's {len(calls)} fused calls each within the "
        f"f32 summation bound of the plain version (max |kernel - plain| "
        f"{nums['max_abs_err']})")
    return nums


# ---------------------------------------------------------------------------
# The toolkit: sparse distances and kNN, random/, stats/, lap/, label/,
# matrix/ (none reaches a kernel)
# ---------------------------------------------------------------------------

# bench/bench_sparse.py:36-58's card cell: 20,000 index rows, 2,000
# queries, 100,000 columns, ~100 nonzeros a row (scipy.sparse.random,
# values uniform in [0, 1)), k = 10, sqeuclidean, the prebuilt index at
# column blocks of 4,096
SP_ROWS, SP_QUERIES, SP_DIM, SP_NNZ, SP_K = 20_000, 2_000, 100_000, 100, 10
SP_COL_BLOCK = 4096
SP_SAMPLE = 256            # queries held against the scipy f64 oracle
SP_ITERS = 8               # warmed calls timed a route (bench_fn's 8)
SP_DENSE_DIM = 2048        # auto -> dense at the same rows
SP_L1_DIM, SP_L1_NNZ = 256, 16   # the unexpanded metric at a cut width
# random/: bench/common.py:262-267's make_blobs recipe
BLOB_ROWS, BLOB_DIM, BLOB_CENTRES = 1_000_000, 128, 1000
MVG_POINTS, MVG_DIM = 1_000_000, 64
DRAWS = 10_000_000
Z_BOUND = 6.0              # |z| of a moment over DRAWS (p ~ 2e-9 a test)
TRUST_ROWS, TRUST_DIM, TRUST_SUB = 16_384, 16, 2048
LAP_N, LAP_BATCH, LAP_BATCH_N = 1024, 16, 256
LABELS_N, MATRIX_N = 1_000_000, 4096


def sparse_rand(rng, m, d, nnz):
    import scipy.sparse as ss

    return ss.random(m, d, density=nnz / d, format="csr", dtype=np.float32,
                     random_state=rng,
                     data_rvs=lambda k: rng.random(k).astype(np.float32))


def sparse_oracle(qry, idx, metric):
    """The f64 distances of ``qry``'s rows to every index row on the host:
    squared L2 from scipy's CSR products, l1 from dense f64 rows."""
    from scipy.spatial.distance import cdist

    q64, i64 = qry.astype(np.float64), idx.astype(np.float64)
    if metric == "l1":
        return cdist(q64.toarray(), i64.toarray(), "cityblock")
    return np.maximum(np.asarray(q64.multiply(q64).sum(1))
                      + np.asarray(i64.multiply(i64).sum(1)).T
                      - 2.0 * (q64 @ i64.T).toarray(), 0.0)


def hold_sparse(what, d, ids, full, k, tol):
    """Distances against the f64 oracle within ``tol`` (relative to the
    row's scale), and ids up to ties: each id's oracle distance within
    ``tol`` of its own and of the oracle's k-th."""
    d, ids = d.cpu().numpy().astype(np.float64), ids.cpu().numpy()
    want = np.sort(full, 1)[:, :k]
    scale = np.maximum(np.abs(want).max(1, keepdims=True), 1.0)
    err = np.abs(d - want) / scale
    got = np.take_along_axis(full, ids.astype(np.int64), 1)
    err_ids = np.abs(got - d) / scale
    check(err.max() <= tol and err_ids.max() <= tol,
          f"{what}: distances {err.max():.3g} / ids {err_ids.max():.3g} "
          f"from the f64 oracle (tolerance {tol})")
    return float(max(err.max(), err_ids.max()))


def timed_calls(fn, dev, iters):
    """Host ms of each of ``iters`` warmed calls, synchronized."""
    fn()
    sync(dev)
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync(dev)
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def sparse_step(args, card, dev):
    """Sparse kNN at bench/bench_sparse.py's cell on three routes (the
    CSR colblock route, the prebuilt index, the prebuilt route at
    ``precision="default"``, which must be bitwise the f32 route): 256
    sampled queries against scipy's f64 CSR product within 1e-5 of the
    row's scale (the f32 expanded form's error), ids up to ties, a repeat
    call bitwise, host syncs a call, 8 warmed calls timed. Then auto ->
    dense at width 2,048 and l1 at width 256 against the same oracle."""
    from raft_tpu_torch.sparse import csr_from_scipy
    from raft_tpu_torch.sparse import distance as sd

    rng = np.random.default_rng(args.seed)
    idx = sparse_rand(rng, SP_ROWS, SP_DIM, SP_NNZ)
    qry = sparse_rand(rng, SP_QUERIES, SP_DIM, SP_NNZ)
    index, queries = csr_from_scipy(idx, device=dev), csr_from_scipy(
        qry, device=dev)
    t0 = time.perf_counter()
    layout = sd.sparse_colblock_index_build(idx, SP_COL_BLOCK, device=dev)
    build_s = time.perf_counter() - t0
    pick = np.sort(rng.choice(SP_QUERIES, SP_SAMPLE, replace=False))
    full = sparse_oracle(qry[pick], idx, "sqeuclidean")
    routes = {
        "csr_colblock": lambda: sd.sparse_brute_force_knn(
            index, queries, SP_K, metric="sqeuclidean", strategy="colblock"),
        "prebuilt": lambda: sd.sparse_brute_force_knn(
            layout, queries, SP_K, metric="sqeuclidean"),
        "prebuilt_default": lambda: sd.sparse_brute_force_knn(
            layout, queries, SP_K, metric="sqeuclidean",
            precision="default"),
    }
    nums = {"build_s": build_s, "nnz": int(idx.nnz + qry.nnz)}
    answers = {}
    for name, fn in routes.items():
        before = sd.HOST_SYNCS
        d, i = fn()
        syncs = sd.HOST_SYNCS - before
        d2, i2 = fn()
        check(torch.equal(d, d2) and torch.equal(i, i2),
              f"sparse {name}: a repeat call gave other bits")
        err = hold_sparse(f"sparse {name}", d[pick], i[pick], full, SP_K,
                          1e-5)
        ms = timed_calls(fn, dev, SP_ITERS)
        answers[name] = (d, i)
        nums[name] = dict(ms=ms, ms_median=float(np.median(ms)),
                          host_syncs=syncs, max_rel_err=err)
        log(f"[{card}] sparse kNN {SP_ROWS} x {SP_QUERIES} x {SP_DIM}, k "
            f"{SP_K}, {name}: {np.median(ms):.2f} ms a call ({SP_ITERS} "
            f"warmed calls {[round(v, 2) for v in ms]}), {syncs} host sync a "
            f"call, {SP_SAMPLE} queries within {err:.3g} of scipy's f64 "
            "product, ids up to ties, a repeat bitwise")
    check(all(nums[n]["host_syncs"] == 1 for n in routes),
          f"sparse host syncs a call {[nums[n]['host_syncs'] for n in routes]}")
    d0, i0 = answers["prebuilt"]
    check(torch.equal(d0, answers["prebuilt_default"][0])
          and torch.equal(i0, answers["prebuilt_default"][1]),
          "precision='default' is not bitwise the f32 prebuilt route (R3)")
    del answers, index, layout

    # auto -> dense at width 2,048, and l1 at a cut width
    for what, dim, nnz, metric in (("auto dense", SP_DENSE_DIM, SP_NNZ,
                                    "sqeuclidean"),
                                   ("l1", SP_L1_DIM, SP_L1_NNZ, "l1")):
        idx = sparse_rand(rng, SP_ROWS, dim, nnz)
        qry = sparse_rand(rng, SP_QUERIES, dim, nnz)
        index = csr_from_scipy(idx, device=dev)
        queries = csr_from_scipy(qry, device=dev)
        before = sd.HOST_SYNCS
        d, i = sd.sparse_brute_force_knn(index, queries, SP_K, metric=metric)
        check(sd.HOST_SYNCS == before, f"sparse {what} took the colblock "
              "route")
        err = hold_sparse(f"sparse {what}", d[pick], i[pick],
                          sparse_oracle(qry[pick], idx, metric), SP_K, 1e-5)
        ms = timed_calls(lambda: sd.sparse_brute_force_knn(
            index, queries, SP_K, metric=metric), dev, 3)
        nums[what] = dict(dim=dim, ms=ms, max_rel_err=err)
        log(f"[{card}] sparse kNN {what} at width {dim} ({metric}, "
            f"~{nnz} nonzeros a row): {np.median(ms):.2f} ms a call, no "
            f"host sync, within {err:.3g} of the f64 oracle")
    return nums


def z_of(mean, want_mean, want_var, n):
    return abs(mean - want_mean) / math.sqrt(want_var / n)


def random_step(args, card, dev):
    """make_blobs at bench/common.py's recipe (round-robin counts exact,
    each cluster's mean within Z_BOUND of its centre, its pooled std
    within Z_BOUND of 1.0), multi_variable_gaussian's sample covariance
    against ``cov`` (each entry within Z_BOUND standard errors), 10**7
    draws of each distribution (the mean within Z_BOUND, the variance
    within 1%), permute and sample_without_replacement."""
    from raft_tpu_torch import random as rr

    nums = {}
    gen = torch.Generator(device=dev).manual_seed(args.seed + 7)
    twin = torch.Generator(device=dev)
    twin.set_state(gen.get_state())
    (x, labels), s = timed_s(lambda: rr.make_blobs(
        BLOB_ROWS, BLOB_DIM, n_clusters=BLOB_CENTRES, cluster_std=1.0,
        generator=gen, device=dev), dev)
    # the centres are make_blobs' first draw
    centres = -10.0 + 20.0 * torch.rand((BLOB_CENTRES, BLOB_DIM),
                                        generator=twin, device=dev)
    counts = torch.bincount(labels.long(), minlength=BLOB_CENTRES)
    check(bool((counts == BLOB_ROWS // BLOB_CENTRES).all()),
          "make_blobs' round-robin counts are not exact")
    lab = labels.long()
    sums = torch.zeros((BLOB_CENTRES, BLOB_DIM), dtype=torch.float64,
                       device=dev).index_add_(0, lab, x.double())
    means = sums / counts[:, None]
    m = BLOB_ROWS // BLOB_CENTRES
    z_mean = float(((means - centres.double()).abs() * math.sqrt(m)).max())
    dev2 = torch.zeros(BLOB_CENTRES, dtype=torch.float64,
                       device=dev).index_add_(
        0, lab, ((x.double() - means[lab]) ** 2).sum(1))
    std = torch.sqrt(dev2 / ((m - 1) * BLOB_DIM))
    z_std = float(((std - 1.0).abs() * math.sqrt(2 * (m - 1) * BLOB_DIM))
                  .max())
    check(z_mean <= Z_BOUND and z_std <= Z_BOUND,
          f"make_blobs: cluster means z {z_mean:.2f}, stds z {z_std:.2f}")
    nums.update(make_blobs_s=s, blob_mean_z=z_mean, blob_std_z=z_std)
    del x, labels, sums, means, dev2
    log(f"[{card}] make_blobs {BLOB_ROWS} x {BLOB_DIM}, {BLOB_CENTRES} "
        f"centres: {1e3 * s:.2f} ms, round-robin counts exact, the largest "
        f"|z| of a cluster mean {z_mean:.2f} and of a cluster std "
        f"{z_std:.2f} (bound {Z_BOUND})")

    a = torch.randn((MVG_DIM, MVG_DIM), generator=gen, device=dev,
                    dtype=torch.float64) / 8
    cov = (a @ a.T + 0.5 * torch.eye(MVG_DIM, dtype=torch.float64,
                                     device=dev)).float()
    mu = torch.linspace(-1, 1, MVG_DIM, device=dev)
    pts, s = timed_s(lambda: rr.multi_variable_gaussian(
        None, MVG_POINTS, mu, cov, generator=gen), dev)
    c64, pd = cov.double(), pts.double()
    emp = torch.cov(pd)
    se = torch.sqrt((torch.outer(c64.diag(), c64.diag()) + c64 ** 2)
                    / MVG_POINTS)
    z_cov = float(((emp - c64).abs() / se).max())
    z_mu = float(((pd.mean(1) - mu.double()).abs()
                  / torch.sqrt(c64.diag() / MVG_POINTS)).max())
    check(z_cov <= Z_BOUND and z_mu <= Z_BOUND,
          f"multi_variable_gaussian: covariance z {z_cov:.2f}, mean z "
          f"{z_mu:.2f}")
    nums.update(mvg_s=s, mvg_cov_z=z_cov, mvg_mean_z=z_mu)
    log(f"[{card}] multi_variable_gaussian {MVG_POINTS} points of width "
        f"{MVG_DIM}: {1e3 * s:.2f} ms, sample covariance within |z| "
        f"{z_cov:.2f} of cov, mean within {z_mu:.2f}")
    del pts, pd

    g = math.pi ** 2
    cases = {   # name: (draw, mean, variance)
        "uniform": (lambda st, dv: rr.uniform(st, DRAWS, -2.0, 4.0,
                                              device=dv), 1.0, 3.0),
        "normal": (lambda st, dv: rr.normal(st, DRAWS, 1.5, 2.0,
                                            device=dv), 1.5, 4.0),
        "lognormal": (lambda st, dv: rr.lognormal(st, DRAWS, 0.0, 0.5,
                                                  device=dv),
                      math.exp(0.125),
                      (math.exp(0.25) - 1) * math.exp(0.25)),
        "exponential": (lambda st, dv: rr.exponential(st, DRAWS, 2.0,
                                                      device=dv), 0.5, 0.25),
        "rayleigh": (lambda st, dv: rr.rayleigh(st, DRAWS, 1.5, device=dv),
                     1.5 * math.sqrt(math.pi / 2),
                     (4 - math.pi) / 2 * 2.25),
        "laplace": (lambda st, dv: rr.laplace(st, DRAWS, 0.5, 1.0,
                                              device=dv), 0.5, 2.0),
        "logistic": (lambda st, dv: rr.logistic(st, DRAWS, 0.5, 1.0,
                                                device=dv), 0.5, g / 3),
        "gumbel": (lambda st, dv: rr.gumbel(st, DRAWS, 0.0, 1.0, device=dv),
                   0.5772156649, g / 6),
        "bernoulli": (lambda st, dv: rr.bernoulli(
            st, DRAWS, 0.3, dtype=torch.float32, device=dv), 0.3, 0.21),
        "scaled_bernoulli": (lambda st, dv: rr.scaled_bernoulli(
            st, DRAWS, 0.25, 2.0, device=dv), 1.0, 3.0),
        "uniform_int": (lambda st, dv: rr.uniform_int(st, DRAWS, 3, 9,
                                                      device=dv), 5.5,
                        35 / 12),
        "normal_int": (lambda st, dv: rr.normal_int(st, DRAWS, 5.0, 2.0,
                                                    device=dv), 5.0,
                       4.0 + 1 / 12),
        "discrete": (lambda st, dv: rr.discrete(st, DRAWS, [0.1, 0.6, 0.3],
                                                device=dv), 1.2, 0.36),
        "custom_distribution": (lambda st, dv: rr.custom_distribution(
            st, DRAWS, lambda u: -torch.log1p(-u), device=dv), 1.0, 1.0),
        "normal_table": (lambda st, dv: rr.normal_table(
            st, DRAWS // 2, [0.0, 3.0], [1.0, 1.0], device=dv).reshape(-1),
            1.5, 1.0 + 2.25),
    }
    state = rr.RngState(args.seed + 11)
    worst = {}
    t0 = time.perf_counter()
    for name, (draw, want_m, want_v) in cases.items():
        v = draw(state, dev).double()
        check(v.device.type == dev.type and v.numel() == DRAWS,
              f"{name}: {v.numel()} draws on {v.device}")
        mean, var = float(v.mean()), float(v.var())
        z = z_of(mean, want_m, want_v, DRAWS)
        check(z <= Z_BOUND and abs(var / want_v - 1) <= 0.01,
              f"{name}: mean {mean:.6g} (z {z:.2f}), variance {var:.6g} "
              f"against {want_v:.6g}")
        worst[name] = round(z, 3)
    perm, _ = rr.permute(state, DRAWS, device=dev)
    check(torch.equal(torch.sort(perm).values,
                      torch.arange(DRAWS, device=dev)),
          "permute is not a permutation")
    ids, _ = rr.sample_without_replacement(state, DRAWS // 10, DRAWS,
                                           device=dev)
    check(torch.unique(ids).numel() == DRAWS // 10,
          "sample_without_replacement repeated an id")
    again = rr.normal(rr.RngState(args.seed + 11), DRAWS, 1.5, 2.0,
                      device=dev)
    check(torch.equal(again, rr.normal(rr.RngState(args.seed + 11), DRAWS,
                                       1.5, 2.0, device=dev)),
          "the same RngState gave other bits")
    sync(dev)
    nums.update(draws_s=time.perf_counter() - t0, mean_z=worst)
    log(f"[{card}] {DRAWS} draws of each of {len(cases)} distributions in "
        f"{nums['draws_s']:.2f} s: mean |z| {worst} (bound {Z_BOUND}), "
        "variances within 1%; permute a permutation, "
        "sample_without_replacement distinct, the same state the same bits")
    return nums


def silhouette_f64(x, labels, k):
    """The mean silhouette in f64 on the host (numpy)."""
    from scipy.spatial.distance import cdist

    x = x.astype(np.float64)
    d = cdist(x, x)
    oh = np.eye(k)[labels]
    sums = d @ oh
    counts = oh.sum(0)
    own = counts[labels]
    a = np.where(own > 1, sums[np.arange(len(x)), labels]
                 / np.maximum(own - 1, 1), 0.0)
    other = np.where((np.arange(k)[None, :] == labels[:, None])
                     | (counts[None, :] == 0), np.inf,
                     sums / np.maximum(counts, 1)[None, :])
    b = other.min(1)
    return float(np.where(own > 1, (b - a) / np.maximum(a, b), 0.0).mean())


def trust_f64(x, emb, k):
    """Trustworthiness in f64 on the host (numpy)."""
    from scipy.spatial.distance import cdist

    n = x.shape[0]
    order = np.argsort(cdist(x.astype(np.float64), x.astype(np.float64)),
                       1, kind="stable")
    ranks = np.empty((n, n), np.int64)
    np.put_along_axis(ranks, order, np.arange(n)[None, :].repeat(n, 0), 1)
    nn = np.argsort(cdist(emb.astype(np.float64), emb.astype(np.float64)),
                    1, kind="stable")[:, 1:k + 1]
    pen = np.maximum(np.take_along_axis(ranks, nn, 1) - k, 0).sum()
    return 1.0 - 2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0)) * pen


def stats_step(args, card, dev, feed):
    """ARI, v-measure and homogeneity of single linkage's labels against
    the centres (1.0); the batched silhouette over the spectral rows and
    labels, and on a 4,096-row subsample against silhouette_score and a
    numpy f64 oracle; trustworthiness of a fixed random projection to 16
    dimensions of 16,384 rows, and on a 2,048-row subsample against a
    numpy f64 oracle. Each timed."""
    from raft_tpu_torch import stats as ts

    nums = {}
    lab, truth = feed["link_labels"], feed["link_truth"]
    k = int(truth.max()) + 1
    for name in ("adjusted_rand_index", "v_measure", "homogeneity_score"):
        v, s = timed_s(lambda: getattr(ts, name)(truth, lab.long(), k), dev)
        check(abs(float(v) - 1.0) <= 1e-5,
              f"{name} of single linkage's labels {float(v):.7f}, not 1")
        nums[name] = dict(value=float(v), s=s)
    x, sl = feed["spec_x"], feed["spec_labels"].long()
    kk = int(sl.max()) + 1
    v, s = timed_s(lambda: ts.batched_silhouette_score(x, sl, kk), dev)
    nums["batched_silhouette"] = dict(value=float(v), s=s)
    pick = torch.randperm(x.shape[0], generator=torch.Generator().manual_seed(
        args.seed + 21))[:SPEC_SUB].to(dev)
    xs, ls = x[pick], sl[pick]
    sub_b = float(ts.batched_silhouette_score(xs, ls, kk, batch_size=1024))
    sub_w = float(ts.silhouette_score(xs, ls, kk))
    sub_64 = silhouette_f64(xs.cpu().numpy(), ls.cpu().numpy(), kk)
    check(abs(sub_b - sub_w) <= 1e-5 and abs(sub_b - sub_64) <= 1e-4,
          f"silhouette on the subsample: batched {sub_b:.7f}, whole "
          f"{sub_w:.7f}, f64 {sub_64:.7f}")
    nums["silhouette_sub"] = dict(batched=sub_b, whole=sub_w, f64=sub_64)
    log(f"[{card}] stats: ARI / v-measure / homogeneity of single linkage "
        f"against the centres {[nums[n]['value'] for n in ('adjusted_rand_index', 'v_measure', 'homogeneity_score')]} "
        f"({[round(1e3 * nums[n]['s'], 2) for n in ('adjusted_rand_index', 'v_measure', 'homogeneity_score')]} ms); "
        f"batched silhouette over {x.shape[0]} x {x.shape[1]} rows, {kk} "
        f"labels: {nums['batched_silhouette']['value']:.6f} in {s:.3f} s; "
        f"on {SPEC_SUB} rows batched {sub_b:.7f}, whole {sub_w:.7f}, f64 "
        f"{sub_64:.7f}")

    rows = x[:TRUST_ROWS]
    proj = torch.randn((x.shape[1], TRUST_DIM), generator=torch.Generator(
        ).manual_seed(args.seed + 22)).to(dev)
    emb = rows @ proj
    v, s = timed_s(lambda: ts.trustworthiness_score(rows, emb, 5), dev)
    check(0.0 < float(v) <= 1.0, f"trustworthiness {float(v)}")
    sub = float(ts.trustworthiness_score(rows[:TRUST_SUB], emb[:TRUST_SUB],
                                         5))
    sub_64 = trust_f64(rows[:TRUST_SUB].cpu().numpy(),
                       emb[:TRUST_SUB].cpu().numpy(), 5)
    check(abs(sub - sub_64) <= 1e-4,
          f"trustworthiness on {TRUST_SUB} rows {sub:.7f} against f64 "
          f"{sub_64:.7f}")
    nums["trustworthiness"] = dict(value=float(v), s=s, sub=sub,
                                   sub_f64=sub_64)
    log(f"[{card}] trustworthiness of a projection to {TRUST_DIM} of "
        f"{TRUST_ROWS} rows: {float(v):.6f} in {s:.3f} s; on {TRUST_SUB} "
        f"rows {sub:.7f} against f64 {sub_64:.7f}")
    return nums


def lap_step(args, card, dev):
    """solve_lap on a 1,024 x 1,024 integer cost matrix in [0, 1000], as
    f64 and as f32 (whose auction stalled before each phase's epsilon was
    floored at the prices' spacing): each objective equals scipy's
    exactly and each assignment is a permutation; solve_lap_batched on 16
    x 256 x 256 (f64) bitwise 16 single solves. Rounds, host syncs and
    seconds."""
    from scipy.optimize import linear_sum_assignment

    from raft_tpu_torch.lap import solve_lap, solve_lap_batched

    rng = np.random.default_rng(args.seed + 30)
    cost = rng.integers(0, 1001, (LAP_N, LAP_N)).astype(np.float64)
    info = {}
    (rows, total), s = timed_s(lambda: solve_lap(
        torch.as_tensor(cost, device=dev), info=info), dev)
    r, c = linear_sum_assignment(cost)
    check(float(total) == cost[r, c].sum(),
          f"LAP objective {float(total)} against scipy's {cost[r, c].sum()}")
    check(torch.equal(torch.sort(rows).values.cpu(),
                      torch.arange(LAP_N, dtype=torch.int32)),
          "the LAP assignment is not a permutation")
    info32 = {}
    (rows32, total32), s32 = timed_s(lambda: solve_lap(
        torch.as_tensor(cost, dtype=torch.float32, device=dev),
        info=info32), dev)
    check(total32.dtype == torch.float32
          and float(total32) == cost[r, c].sum(),
          f"f32 LAP objective {float(total32)} against scipy's "
          f"{cost[r, c].sum()}")
    check(torch.equal(torch.sort(rows32).values.cpu(),
                      torch.arange(LAP_N, dtype=torch.int32)),
          "the f32 LAP assignment is not a permutation")
    costs = rng.integers(0, 1001, (LAP_BATCH, LAP_BATCH_N, LAP_BATCH_N)
                         ).astype(np.float64)
    binfo = {}
    (brows, bobj), bs = timed_s(lambda: solve_lap_batched(
        torch.as_tensor(costs, device=dev), info=binfo), dev)
    for b in range(LAP_BATCH):
        r1, o1 = solve_lap(torch.as_tensor(costs[b], device=dev))
        check(torch.equal(r1, brows[b]) and torch.equal(o1, bobj[b]),
              f"batched LAP problem {b} differs from its single solve")
        rb, cb = linear_sum_assignment(costs[b])
        check(float(o1) == costs[b][rb, cb].sum(),
              f"LAP problem {b}: objective against scipy")
    nums = dict(n=LAP_N, rounds=info["rounds"], syncs=info["syncs"], s=s,
                objective=float(total), batch_rounds=binfo["rounds"],
                batch_syncs=binfo["syncs"], batch_s=bs,
                f32_rounds=info32["rounds"], f32_s=s32)
    log(f"[{card}] LAP {LAP_N} x {LAP_N} (f64, integer costs in [0, 1000]): "
        f"objective {float(total):.0f} = scipy's, {info['rounds']} auction "
        f"rounds, {info['syncs']} host syncs, {s:.3f} s; f32: objective "
        f"{float(total32):.0f} = scipy's, {info32['rounds']} rounds, "
        f"{info32['syncs']} host syncs, {s32:.3f} s; batched "
        f"{LAP_BATCH} x {LAP_BATCH_N}: {binfo['rounds']} rounds, "
        f"{binfo['syncs']} syncs, {bs:.3f} s, bitwise the single solves")
    return nums


def label_matrix_step(args, card, dev):
    """make_monotonic / get_unique_labels / merge_labels over 1,000,000
    labels against numpy (merge_labels against the connected components
    of the labelings' bipartite graph: each point takes its component's
    least index), then the matrix helpers on a 4,096² matrix against
    numpy."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    from raft_tpu_torch import label as tl
    from raft_tpu_torch import matrix as tm

    rng = np.random.default_rng(args.seed + 40)
    n = LABELS_N
    lab = rng.integers(-5000, 5000, n).astype(np.int32)
    tlab = torch.as_tensor(lab, device=dev)
    uniq = np.unique(lab)
    (got_u, n_u), s_u = timed_s(lambda: tl.get_unique_labels(tlab), dev)
    check(int(n_u) == len(uniq) and np.array_equal(
        got_u[:len(uniq)].cpu().numpy(), uniq), "get_unique_labels")
    mono, s_m = timed_s(lambda: tl.make_monotonic(tlab), dev)
    check(np.array_equal(mono.cpu().numpy(),
                         np.unique(lab, return_inverse=True)[1]),
          "make_monotonic")
    a = rng.integers(0, n // 2, n)
    b = rng.integers(0, n // 2, n)
    mask = rng.random(n) < 0.5
    merged, s_g = timed_s(lambda: tl.merge_labels(
        torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev),
        torch.as_tensor(mask, device=dev)), dev)
    pts = np.arange(n)
    g = coo_matrix((np.ones(n + int(mask.sum())),
                    (np.concatenate([pts, pts[mask]]),
                     np.concatenate([n + a, n + n // 2 + b[mask]]))),
                   shape=(2 * n, 2 * n))
    _, comp = connected_components(g, directed=False)
    least = np.full(2 * n, n, np.int64)
    np.minimum.at(least, comp[:n], pts)
    check(np.array_equal(merged.cpu().numpy(), least[comp[:n]]),
          "merge_labels against the components' least indices")
    nums = dict(unique_s=s_u, monotonic_s=s_m, merge_s=s_g,
                n_unique=int(n_u),
                merged_groups=int(np.unique(least[comp[:n]]).size))

    m = rng.integers(-50, 51, (MATRIX_N, MATRIX_N)).astype(np.float32)
    tmx = torch.as_tensor(m, device=dev)
    idx = rng.integers(0, MATRIX_N, 4096)
    t0 = time.perf_counter()
    pairs = {
        "copy_rows": (tm.copy_rows(tmx, torch.as_tensor(idx, device=dev)),
                      m[idx]),
        "slice_matrix": (tm.slice_matrix(tmx, 5, 7, 3000, 4000),
                         m[5:3000, 7:4000]),
        "col_reverse": (tm.col_reverse(tmx), m[:, ::-1]),
        "row_reverse": (tm.row_reverse(tmx), m[::-1]),
        "get_diagonal": (tm.get_diagonal(tmx), np.diagonal(m)),
        "argmax": (tm.argmax(tmx), m.argmax(1)),
        "argmin_cols": (tm.argmin(tmx, 0), m.argmin(0)),
        "copy_upper_triangular": (tm.copy_upper_triangular(tmx), np.triu(m)),
        "seq_root": (tm.seq_root(tmx, 2.0, True),
                     np.sqrt(np.maximum(m * 2.0, 0))),
        "zero_small_values": (tm.zero_small_values(tmx, 3.0),
                              np.where(np.abs(m) <= 3.0, 0, m)),
    }
    vals, order = tm.sort_cols_per_row(tmx)
    want_order = np.argsort(m, 1, kind="stable")
    pairs["sort_cols_per_row"] = (order, want_order)
    pairs["sort_cols_per_row values"] = (vals, np.take_along_axis(
        m, want_order, 1))
    sync(dev)
    nums["matrix_s"] = time.perf_counter() - t0
    for name, (got, want) in pairs.items():
        check(np.array_equal(got.cpu().numpy(), want), f"matrix {name}")
    log(f"[{card}] labels over {n}: get_unique_labels {1e3 * s_u:.2f} ms, "
        f"make_monotonic {1e3 * s_m:.2f} ms, merge_labels {1e3 * s_g:.2f} "
        f"ms ({nums['merged_groups']} groups), each equal to numpy; "
        f"{len(pairs)} matrix helpers on {MATRIX_N}² in "
        f"{nums['matrix_s']:.3f} s, each equal to numpy")
    return nums


def toolkit_phase(args, card, dev, feed):
    """The toolkit modules on the card, none of which reaches a
    kernel: :func:`sparse_step`, :func:`random_step`, :func:`stats_step`
    (fed by the linkage phase's labels and the spectral rows),
    :func:`lap_step` and :func:`label_matrix_step`. Raises on any failed
    check; returns the numbers."""
    nums = {"card": card}
    for name, fn in (("sparse", lambda: sparse_step(args, card, dev)),
                     ("random", lambda: random_step(args, card, dev)),
                     ("stats", lambda: stats_step(args, card, dev, feed)),
                     ("lap", lambda: lap_step(args, card, dev)),
                     ("label_matrix", lambda: label_matrix_step(
                         args, card, dev))):
        t0 = time.perf_counter()
        nums[name] = fn()
        nums[name]["step_s"] = time.perf_counter() - t0
        log(f"toolkit {name}: {nums[name]['step_s']:.1f} s")
    return nums


HEAL_WATCHDOG_S = 300      # the self-heal phase's stall limit


def self_heal_phase(args, card, dev, x):
    """The self-healing supervisor at P = 8 on the card, replication 2,
    under a stall watchdog: bench/bench_serving.py's ``self_heal_row``
    recipe (``raft_tpu_torch.testing.heal_rows``: 65,536 of the main
    path's rows, 32 lists, requests of 8 rows from 32 Zipf(1.1)
    templates through a ``ServingExecutor``, rank 4 killed at 0.6 s and
    its slabs wrecked, healed at 2.0 s, recover_rank from an archive and
    resync_rank run by the supervisor), then a short schedule that also
    flaps rank 1's probe. #2's launches are counted over the phase, and
    every one of its calls is held against the plain version afterwards
    (at the shapes the rows gave it: bucket 8, the replicated slabs)."""
    from raft_tpu_torch.comms import build_comms
    from raft_tpu_torch.spatial.ann import flat_kernel as fk
    from raft_tpu_torch.testing.heal_rows import self_heal_row

    faulthandler.dump_traceback_later(HEAL_WATCHDOG_S, exit=True)
    try:
        rng = np.random.default_rng(args.seed + 50)
        cuda0 = (torch.device("cuda", torch.cuda.current_device())
                 if dev.type == "cuda" else dev)
        comms = build_comms([cuda0] * SHARD_P)
        q = (x[rng.integers(0, min(65_536, x.shape[0]), 512)]
             + 0.3 * rng.standard_normal((512, DIM), dtype=np.float32))
        fk.LAUNCHES = 0
        keep = []
        t0 = time.perf_counter()
        with scan_calls(keep):
            row = self_heal_row(comms, x, q, k=K, n_probes=16,
                                seed=args.seed + 43)
        row["row_s"] = time.perf_counter() - t0
        n_row_calls = len(keep)
        log(f"[{card}] self-heal row (P = {SHARD_P}, R = 2, rank 4 killed "
            "and healed): detection_ms "
            f"{row.get('detection_ms', float('nan')):.1f}, "
            "route_convergence_ms "
            f"{row.get('route_convergence_ms', float('nan')):.1f}, "
            "reintegration_ms "
            f"{row.get('reintegration_ms', float('nan')):.1f}; p99 ms "
            f"healthy {row.get('p99_ms_healthy', float('nan')):.2f}, "
            f"degraded {row.get('p99_ms_degraded', float('nan')):.2f}, "
            f"healed {row.get('p99_ms_healed', float('nan')):.2f}; "
            f"{row['answers_after_push']} answers of "
            f"{row['submitted_after_push']} requests submitted after the "
            f"route push, {row['answers_after_push_bad']} not bitwise "
            f"healthy; {row['failed_requests']} requests failed")
        check("error" not in row and all(
            key in row for key in ("detection_ms", "route_convergence_ms",
                                   "reintegration_ms")),
              f"self-heal row incomplete: {row}")
        check(row["failed_requests"] == 0
              and row["answers_after_push"] > 0
              and row["answers_after_push"] == row["submitted_after_push"]
              and row["answers_after_push_bad"] == 0,
              f"{row['failed_requests']} requests failed; "
              f"{row['answers_after_push']} of "
              f"{row['submitted_after_push']} requests submitted after the "
              f"route push answered, {row['answers_after_push_bad']} not "
              "the healthy answer")
        check(row["supervisor_heals_ok"] == 1 and row["all_serving"],
              f"supervisor_heals_total{{outcome=ok}} "
              f"{row['supervisor_heals_ok']}, all serving "
              f"{row['all_serving']}")
        check(1 <= row["route_pushes"] <= row["transitions"]
              and row["chaos_ok"],
              f"route pushes {row['route_pushes']} against "
              f"{row['transitions']} confirmed transitions; "
              + row["chaos_summary"])
        t0 = time.perf_counter()
        with scan_calls(keep):
            flap = self_heal_row(comms, x, q, k=K, n_probes=16,
                                 kill_at_s=0.2, heal_at_s=0.9,
                                 duration_s=1.6,
                                 oscillate=(1, 0.4, 0.02, 0.3),
                                 seed=args.seed + 44)
        flap["row_s"] = time.perf_counter() - t0
        log(f"[{card}] chaos schedule (kill rank 4, flap rank 1, heal): "
            + flap["chaos_summary"].replace("\n", "; ")
            + f"; {flap['transitions']} confirmed transitions, "
            f"{flap['route_pushes']} route pushes, heals ok "
            f"{flap['heals_ok']}, {flap['answers_after_push_bad']} of "
            f"{flap['answers_after_push']} answers "
            f"({flap['submitted_after_push']} submitted) after the push "
            "not bitwise healthy, "
            f"{flap['failed_requests']} requests failed")
        check(flap["chaos_ok"] and flap["all_serving"]
              and flap["failed_requests"] == 0
              and flap["answers_after_push"] == flap["submitted_after_push"]
              and flap["answers_after_push_bad"] == 0,
              "the chaos schedule's invariants: " + flap["chaos_summary"])
        check(fk.LAUNCHES > 0 and len(keep) == fk.LAUNCHES,
              f"the self-heal phase launched #2 {fk.LAUNCHES} times in "
              f"{len(keep)} flat_scan_lists calls")
        # every call of both rows against the plain version; these
        # launches are not the path's
        saved = fk.LAUNCHES
        max_err = max(compare_lists_to_plain(call) for call in keep)
        fk.LAUNCHES = saved
        shapes = collections.Counter(
            "x".join(map(str, (*c[1].shape, c[5]))) for c in keep)
        log(f"[{card}] self-heal phase's {len(keep)} flat_scan_lists calls "
            f"({n_row_calls} in the row, {len(keep) - n_row_calls} in the "
            f"schedule; lists x Q x Lpad {dict(shapes)}) within 1e-5 x "
            f"(qn + yn) of the plain version, max |kernel - plain| "
            f"{max_err:.3g}")
        del keep
    finally:
        faulthandler.cancel_dump_traceback_later()
    nums = {"card": card, "row": row, "max_abs_err": max_err,
            "flap": {key: flap.get(key) for key in (
                "chaos_ok", "transitions", "route_pushes", "heals_ok",
                "detection_ms", "route_convergence_ms", "reintegration_ms",
                "answers_after_push", "answers_after_push_bad",
                "submitted_after_push", "failed_requests", "row_s")},
            "launches": fk.LAUNCHES}
    row.pop("chaos_summary", None)
    log(f"[{card}] self-heal phase: " + json.dumps(nums))
    return nums


# ---------------------------------------------------------------------------
# The two-level coarse probe at the deployment's centroid count
# ---------------------------------------------------------------------------

# tests/test_coarse_probe.py:143 and bench.py:956-990: 65,792 centroids of
# width 96 (the served IVF-Flat index's and jittered draws of them), 16
# probes at overprobe 2, the fused dispatch's 16,384 queries, the recall
# audit on 1,024 of them. 4,096 supers with the default cap rule
# (ceil(1.5 x mean) = 26 members): on these inputs the default ~sqrt(n) =
# 256 supers keep 0.9077 (legacy) / 0.8820 (kernel) of the flat probe's
# lists at overprobe 2 and reach 0.99 only at overprobe 6, where the FLOP
# ratio is 1.76; 2,048 supers keep 0.9971 / 0.9857 (the kernel engine's
# qcap drops pairs of these clustered queries)
# (python3 -m raft_tpu_torch.tools.sweep_coarse --smoke); the phase
# still audits the default geometry
COARSE_CENTS, COARSE_PROBES, COARSE_OVERPROBE = 65_792, 16, 2.0
COARSE_SUPERS = 4096
COARSE_CAP = max(8, -(-3 * -(-COARSE_CENTS // COARSE_SUPERS) // 2))
COARSE_QUERIES, COARSE_AUDIT = 16_384, 1024


def probes_agree(d_a, i_a, d_b, i_b, qn, cn):
    """Per query, whether two best-first probe lists agree up to ties:
    distances within 1e-5 x (qn + cn) of each other position by position,
    and each list's ids closer than the other's last distance (less the
    tolerance) among the other's ids. Host arrays; returns (agree (nq,)
    bool, max |d_a - d_b|)."""
    tol = 1e-5 * (qn[:, None] + cn[i_b])
    err = np.abs(d_a - d_b)
    agree = (err <= tol).all(1)
    for a_ids, a_d, b_ids, b_d in ((i_a, d_a, i_b, d_b),
                                   (i_b, d_b, i_a, d_a)):
        inner = a_d < (b_d[:, -1:] - tol[:, -1:])
        for r in np.nonzero(agree)[0]:
            if not set(a_ids[r][inner[r]].tolist()) <= set(
                    b_ids[r].tolist()):
                agree[r] = False
    return agree, float(err.max())


def coarse_phase(args, card, dev, index, x):
    """The two-level coarse probe over 65,792 centroids: build, the FLOP
    ratio, the recall audit of both engines, the kernel engine's 16,384-
    query batch against the legacy engine's (up to ties where no (query,
    super) pair dropped), the flat-scan kernel's launches on both stages
    held against its plain versions, and the three probes' times. Returns
    the numbers for the flat scan's entry of the ``kernels`` line."""
    from raft_tpu_torch.spatial.ann import coarse as tco
    from raft_tpu_torch.spatial.ann import common as cm
    from raft_tpu_torch.spatial.ann import flat_kernel as fk

    rng = np.random.default_rng(args.seed + 9)
    base = index.centroids.float()
    nb = base.shape[0]
    sel = torch.as_tensor(rng.integers(0, nb, COARSE_CENTS - nb), device=dev)
    jitter = torch.as_tensor(0.5 * rng.standard_normal(
        (COARSE_CENTS - nb, DIM), dtype=np.float32), device=dev)
    cents = torch.cat([base, base[sel] + jitter])
    qb = torch.as_tensor(
        x[rng.integers(0, N_ROWS, COARSE_QUERIES)]
        + 0.3 * rng.standard_normal((COARSE_QUERIES, DIM), dtype=np.float32),
        device=dev)

    # the default geometry, audited and not gated (see COARSE_SUPERS)
    default = cm.build_coarse_index(cents)
    rec_default = [tco.coarse_probe_recall(
        qb[:COARSE_AUDIT], cents, default, COARSE_PROBES,
        overprobe=COARSE_OVERPROBE, use_kernel=k) for k in (False, True)]
    flops_default = cm.probe_flop_accounting(
        default, COARSE_PROBES, overprobe=COARSE_OVERPROBE)["ratio"]
    log(f"[{card}] default coarse geometry ({default.n_super} supers, "
        f"max_members {default.max_members}), not gated: recall legacy "
        f"{rec_default[0]:.4f} / kernel {rec_default[1]:.4f}, FLOP ratio "
        f"{flops_default:.2f}")
    del default

    t0 = time.perf_counter()
    coarse = cm.build_coarse_index(cents, n_super=COARSE_SUPERS,
                                   member_cap=COARSE_CAP)
    sync(dev)
    build_s = time.perf_counter() - t0
    check(coarse.super_cents.device.type == "cuda",
          f"coarse index built on {coarse.super_cents.device}")
    ns, mm = coarse.n_super, coarse.max_members
    S = cm.n_super_probes(COARSE_PROBES, ns, COARSE_OVERPROBE)
    flops = cm.probe_flop_accounting(coarse, COARSE_PROBES,
                                     overprobe=COARSE_OVERPROBE)
    log(f"[{card}] coarse index over {COARSE_CENTS} x {DIM} centroids in "
        f"{build_s:.2f} s: {ns} supers ({COARSE_SUPERS} asked, cap "
        f"{COARSE_CAP}), max_members {mm}, S {S}; FLOP "
        f"ratio {flops['ratio']:.2f} (flat {flops['flat']:.0f}, two-level "
        f"{flops['two_level']:.0f} a query)")
    check(flops["ratio"] >= 4.0, f"probe FLOP ratio {flops['ratio']} < 4")
    check(tco.two_level_probe_kernel_supported(
        DIM, COARSE_QUERIES, COARSE_PROBES, ns, mm, S),
        "the kernel engine does not apply at the deployment geometry")
    args_c = (coarse.super_cents, coarse.member_ids, coarse.cents_padded,
              coarse.n_cents, COARSE_PROBES, S)

    # the probe's path, with the counts at 0 just before it: the kernel
    # engine's recall audit and its 16,384-query batch
    fk.LAUNCHES = 0
    tco.COARSE_ENGINE_FALLBACKS = 0
    keep1, keep2 = [], []
    with kernel_calls(fk, "flat_scan_subchunk_min",
                      lambda a: (a[0].shape[1], a[1].shape[2]),
                      keep1) as shapes1, \
            kernel_calls(fk, "flat_scan_lists",
                         lambda a: (a[1].shape[0], a[1].shape[1], a[5]),
                         keep2) as shapes2:
        rec_k = tco.coarse_probe_recall(
            qb[:COARSE_AUDIT], cents, coarse, COARSE_PROBES,
            overprobe=COARSE_OVERPROBE, use_kernel=True)
        pk, dk = tco.two_level_probe(qb, *args_c, use_kernel=True)
        sync(dev)
    launches = fk.LAUNCHES
    log(f"coarse probe path: flat-scan launches {launches}: stage 1 "
        f"(flat_scan_subchunk_min) by (queries, supers padded) "
        f"{dict(shapes1)}, stage 2 (flat_scan_lists) by (supers, qcap, "
        f"Lpad) {dict(shapes2)}; COARSE_ENGINE_FALLBACKS "
        f"{tco.COARSE_ENGINE_FALLBACKS}")
    check(tco.COARSE_ENGINE_FALLBACKS == 0,
          f"{tco.COARSE_ENGINE_FALLBACKS} kernel-engine probes ran legacy")
    check(sum(shapes1.values()) == 2 and sum(shapes2.values()) == 2
          and launches == 4,
          f"{launches} flat-scan launches for 2 probes (one a stage "
          "expected)")

    rec_l = tco.coarse_probe_recall(
        qb[:COARSE_AUDIT], cents, coarse, COARSE_PROBES,
        overprobe=COARSE_OVERPROBE)
    log(f"[{card}] coarse_probe_recall on {COARSE_AUDIT} queries: kernel "
        f"engine {rec_k:.4f}, legacy {rec_l:.4f}")
    check(min(rec_k, rec_l) >= 0.99,
          f"two-level probe recall {rec_k} / {rec_l} < 0.99")
    pl, dl = tco.two_level_probe(qb, *args_c)

    # the first launch at each shape against its plain version
    err = 0.0
    for call in keep1:
        err = max(err, compare_to_plain(*call))
    for call in keep2:
        err = max(err, compare_lists_to_plain(call))
    log(f"kernel check on the probe's path: {len(keep1)} + {len(keep2)} "
        f"launches within 1e-5 x (qn + yn) of plain, max |kernel - plain| "
        f"{err:.3g}")

    # kernel engine against legacy, up to ties. Ties come at two levels:
    # equal member distances, and equal super distances at the S-th
    # super (split supers share their centroid), where the engines may
    # keep different supers and so different members; and the stage-2
    # qcap drops (query, super) pairs by design. So: (1) the two super
    # sets differ only inside the tie at the S-th super; (2) the kernel
    # engine's probes equal the legacy member stage over the (query,
    # super) pairs it kept, up to member ties, on every query; (3) on
    # the queries with no dropped pair and equal super sets they equal
    # legacy's up to member ties.
    sup_k = tco._super_scan_kernel(qb, coarse.super_cents, S, 256)
    qcap = keep2[-1][1].shape[1]
    slot = cm.invert_probe_map_ranked(sup_k, ns, qcap)[3]
    keep_pairs = (slot < qcap).reshape(COARSE_QUERIES, S)
    kept = keep_pairs.all(1).cpu().numpy()
    n_drop = int((~kept).sum())
    sup_l, sd2 = cm.coarse_probe(qb, coarse.super_cents, S)
    d_ref, p_ref = cm.map_query_blocks(
        lambda a: cm.rerank_members(a[0], a[1], coarse.member_ids,
                                    coarse.cents_padded, coarse.n_cents,
                                    COARSE_PROBES, keep=a[2]),
        (qb, sup_k, keep_pairs), 256)
    qn = (qb * qb).sum(1).cpu().numpy()
    cn = (cents * cents).sum(1).cpu().numpy()
    sn = (coarse.super_cents ** 2).sum(1).cpu().numpy()
    sd2 = sd2.cpu().numpy()
    s_tie = np.sort(sd2, 1)[:, S - 1]
    same_sup = np.zeros(COARSE_QUERIES, bool)
    tied_only = np.ones(COARSE_QUERIES, bool)
    for r, (a, b) in enumerate(zip(sup_k.cpu().numpy(), sup_l.cpu().numpy())):
        diff = np.asarray(sorted(set(a.tolist()) ^ set(b.tolist())), int)
        same_sup[r] = diff.size == 0
        tied_only[r] = (np.abs(sd2[r, diff] - s_tie[r])
                        <= 1e-5 * (qn[r] + sn[diff])).all()
    own, own_err = probes_agree(dk.cpu().numpy(), pk.cpu().numpy(),
                                d_ref.cpu().numpy(), p_ref.cpu().numpy(),
                                qn, cn)
    agree, d_err = probes_agree(dk.cpu().numpy(), pk.cpu().numpy(),
                                dl.cpu().numpy(), pl.cpu().numpy(), qn, cn)
    log(f"[{card}] {COARSE_QUERIES}-query batch: {n_drop} queries had "
        f"some of their {S} (query, super) pairs dropped by the qcap "
        f"{qcap} ({int((~keep_pairs).sum())} pairs); super sets equal on "
        f"{int(same_sup.sum())} queries and differ only at a tie of the "
        f"S-th super on {int((~same_sup & tied_only).sum())}; kernel "
        f"engine equals the legacy member stage over its kept pairs up to "
        f"ties on {int(own.sum())} of {COARSE_QUERIES} queries (max |d| "
        f"diff {own_err:.3g}), and legacy up to ties on "
        f"{int(agree[kept & same_sup].sum())} of "
        f"{int((kept & same_sup).sum())} queries without drops and with "
        f"equal super sets ({int(agree.sum())} of all, max |d kernel - d "
        f"legacy| {d_err:.3g})")
    check(tied_only.all(), "kernel and legacy super sets differ beyond "
          f"the S-th super's tie on {int((~tied_only).sum())} queries")
    check(own.all(), "kernel-engine probes differ from the member stage "
          f"over its kept pairs on {int((~own).sum())} queries")
    check(agree[kept & same_sup].all(), "kernel-engine probes differ from "
          f"legacy beyond ties on {int((~agree[kept & same_sup]).sum())} "
          "queries with equal super sets")

    # ms a 16,384-query batch: the flat probe (f32 GEMM + selection, the
    # library yardstick), the two engines
    timed = {
        "flat": cuda_time_ms(lambda: cm.coarse_probe(qb, cents,
                                                     COARSE_PROBES),
                             [()], iters=3, warm=1),
        "legacy": cuda_time_ms(lambda: tco.two_level_probe(qb, *args_c),
                               [()], iters=3, warm=1),
        "kernel": cuda_time_ms(lambda: tco.two_level_probe(
            qb, *args_c, use_kernel=True), [()], iters=5, warm=1),
    }
    log(f"[{card}] {COARSE_QUERIES}-query probe ms: flat coarse_probe "
        f"{timed['flat']:.3f}, two-level legacy {timed['legacy']:.3f}, "
        f"two-level kernel {timed['kernel']:.3f}")

    # the kernel at the probe's two shapes: the batch's stage-1 and
    # stage-2 launches
    call1 = keep1[-1]
    s1 = time_kernel(*call1)
    qr, slabs_t, bounds = call1
    nq1, l1 = qr.shape[1], slabs_t.shape[2]
    b1 = lists_scan_bound(
        torch.cat([qr[0], qr.new_zeros((1, DIM))]),
        torch.arange(nq1, device=dev, dtype=torch.int32)[None],
        slabs_t.transpose(1, 2)[0], torch.zeros(1, dtype=torch.int32,
                                                device=dev), bounds, l1)
    call2 = keep2[-1]
    s2 = time_lists(call2)
    b2 = lists_scan_bound(*call2)
    b2_live = lists_scan_bound(*call2, live_only=True)
    shape1 = [1, nq1, DIM, l1]
    shape2 = [call2[1].shape[0], call2[1].shape[1], DIM, call2[5]]
    log(f"[{card}] flat_scan_subchunk_min, stage 1 at {tuple(shape1)}: "
        f"kernel {s1[0]:.4f} ms ({b1[0] / s1[0]:.1%} of the bound), plain "
        f"{s1[1]:.4f} ms, library {s1[2]:.4f} ms, bound {b1[0]:.4f} ms "
        f"({b1[1]})")
    log(f"[{card}] flat_scan_lists, stage 2 at {tuple(shape2)}: kernel "
        f"{s2[0]:.4f} ms ({b2[0] / s2[0]:.1%} of the bound, "
        f"{b2_live[0] / s2[0]:.1%} of the live-minima bound), plain "
        f"{s2[1]:.4f} ms, gathered form {s2[2]:.4f} ms, library "
        f"{s2[3]:.4f} ms, bound {b2[0]:.4f} ms ({b2[1]}), live-minima "
        f"bound {b2_live[0]:.4f} ms")
    del keep1, keep2
    return {
        "launches": launches,
        "launches_by_shape": {
            **{f"stage1:{a}x{b}": n for (a, b), n in shapes1.items()},
            **{f"stage2:{a}x{b}x{c}": n for (a, b, c), n in
               shapes2.items()}},
        "max_abs_err": err,
        "stage1": {"shape": shape1, "ms": s1[0], "plain_ms": s1[1],
                   "library_ms": s1[2], "bound_ms": b1[0],
                   "bound_by": b1[1]},
        "stage2": {"shape": shape2, "ms": s2[0], "plain_ms": s2[1],
                   "gathered_ms": s2[2], "library_ms": s2[3],
                   "bound_ms": b2[0], "bound_by": b2[1],
                   "bound_live_ms": b2_live[0]},
        "probe_ms": timed, "recall": {"kernel": rec_k, "legacy": rec_l},
        "flop_ratio": flops["ratio"], "n_super": ns, "max_members": mm,
        "queries_with_drops": n_drop, "build_s": build_s,
        "default_geometry": {"recall": rec_default,
                             "flop_ratio": flops_default},
    }


# ---------------------------------------------------------------------------
# Quantized IVF: IVF-SQ (int8 dequant scan) and IVF-PQ (ADC scan + refine)
# ---------------------------------------------------------------------------


def ann_dataset(seed):
    """bench.py's ann_bench_dataset geometry, made with numpy: 500,000 x
    96 rows around 1,000 centres uniform in [-10, 10)^96 (std 1), and
    4,096 queries that are dataset rows plus 0.3-std noise."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10.0, 10.0, (QZ_CENTERS, DIM)).astype(np.float32)
    x = (centers[rng.integers(0, QZ_CENTERS, QZ_ROWS)]
         + rng.standard_normal((QZ_ROWS, DIM), dtype=np.float32))
    q = (x[rng.integers(0, QZ_ROWS, QZ_QUERIES)]
         + 0.3 * rng.standard_normal((QZ_QUERIES, DIM), dtype=np.float32))
    return x, q, rng


def quantized_path(kind, x, qb, true, rng, card, dev):
    """Build -> warm each bucket -> serve requests -> the 4,096-query
    batch at qcap="throughput" on both engines, for ``kind`` "sq" or
    "pq"; recall@10 against exact brute force. Returns the index and the
    warmed qcap of each bucket."""
    from raft_tpu_torch.spatial import brute_force_knn
    from raft_tpu_torch.spatial.ann import (
        IVFPQParams, IVFSQParams, ivf_pq_build, ivf_pq_search_grouped,
        ivf_sq_build, ivf_sq_search_grouped,
    )

    t0 = time.perf_counter()
    if kind == "sq":
        index = ivf_sq_build(x, IVFSQParams(
            n_lists=QZ_LISTS, kmeans_n_iters=10, max_list_cap=512),
            device=dev)

        def search(q, qcap, use_kernel=None):
            return ivf_sq_search_grouped(index, q, K, n_probes=QZ_PROBES,
                                         qcap=qcap, use_kernel=use_kernel)
        warm = {}
    else:
        index = ivf_pq_build(x, IVFPQParams(
            n_lists=QZ_LISTS, pq_dim=PQ_DIM, pq_bits=PQ_BITS,
            kmeans_n_iters=10, kmeans_init="random", max_list_cap=512),
            device=dev)

        def search(q, qcap, use_kernel=None):
            return ivf_pq_search_grouped(
                index, q, K, n_probes=QZ_PROBES, qcap=qcap,
                refine_ratio=PQ_REFINE, use_kernel=use_kernel)
        warm = {"refine_ratio": PQ_REFINE}
    sync(dev)
    build_s = time.perf_counter() - t0
    check(index.device.type == dev.type, f"{kind} index on {index.device}")
    log(f"[{card}] {kind} build: {QZ_ROWS} x {DIM} -> "
        f"{index.centroids.shape[0]} lists in {build_s:.2f} s (max_list "
        f"{index.storage.max_list})")

    t0 = time.perf_counter()
    qcaps = {b: index.warmup(b, k=K, n_probes=QZ_PROBES, **warm)
             for b in BUCKETS}
    log(f"[{card}] {kind} warmup: qcap per bucket {qcaps} in "
        f"{time.perf_counter() - t0:.2f} s")

    def noisy_rows(m):
        return (x[rng.integers(0, QZ_ROWS, m)]
                + 0.3 * rng.standard_normal((m, DIM), dtype=np.float32))

    requests, served, _ = serve_requests(
        lambda q, b: search(q, qcaps[b]), noisy_rows, rng, QZ_REQUESTS,
        DIM, QZ_ROWS, card, kind)
    sample = requests[:20]
    qs = torch.as_tensor(np.concatenate(sample), device=dev)
    _, want = brute_force_knn(torch.as_tensor(x, device=dev), qs, K)
    r_served = recall(torch.cat([served[id(r)][1] for r in sample]), want)
    log(f"[{card}] {kind} served recall@10 (first 20 requests): "
        f"{r_served:.4f}")
    check(r_served >= 0.8, f"{kind} served recall@10 {r_served}")

    results = {}
    for name, engine in (("kernel", None), ("legacy", False)):
        sync(dev)
        t0 = time.perf_counter()
        d, ids = search(qb, "throughput", use_kernel=engine)
        sync(dev)
        ms = 1e3 * (time.perf_counter() - t0)
        check(bool(torch.isfinite(d).all()), f"{kind} {name}: non-finite")
        results[name] = (recall(ids, true), ms)
    log(f"[{card}] {kind} {QZ_QUERIES}-query batch (qcap 'throughput'): "
        + ", ".join(f"{n} recall@10 {r:.4f} ({ms:.2f} ms, "
                    f"{1e3 * QZ_QUERIES / ms:.0f} queries/s)"
                    for n, (r, ms) in results.items()))
    check(results["kernel"][0] >= results["legacy"][0] - 0.005,
          f"{kind} kernel engine recall below legacy: {results}")
    return index, qcaps


def sq_int_inputs(gen, lb, q, d, l_pad, dev, dyadic):
    """SQ scan inputs: bf16 queries, an int8 (LB, Lpad, d) slab passed
    transposed, and affine stats — dyadic (every value and sum exact)
    or generic."""
    if dyadic:
        qr = torch.randint(-64, 64, (lb, q, d), generator=gen).float()
        vmin = torch.randint(-8, 8, (d,), generator=gen).float()
        vscale = torch.full((d,), 0.5)
    else:
        qr = torch.randn((lb, q, d), generator=gen)
        vmin = torch.randn((d,), generator=gen)
        vscale = torch.rand((d,), generator=gen) / 64 + 1e-3
    codes = torch.randint(-128, 128, (lb, l_pad, d), generator=gen,
                          dtype=torch.int8)
    return (qr.to(torch.bfloat16).to(dev), codes.to(dev).transpose(1, 2),
            vmin.to(dev), vscale.to(dev))


def pq_inputs(gen, lb, q, m, k_codes, l_pad, dev, integer):
    """ADC scan inputs: a bf16 LUT (integer-valued or Gaussian) and a
    uint8 (LB, Lpad, M) code slab passed transposed."""
    luts = (torch.randint(-64, 64, (lb, q, m * k_codes), generator=gen)
            .float() if integer else
            torch.randn((lb, q, m * k_codes), generator=gen))
    codes = torch.randint(0, k_codes, (lb, l_pad, m), generator=gen,
                          dtype=torch.uint8)
    return luts.to(torch.bfloat16).to(dev), codes.to(dev).transpose(1, 2)


def bitwise(fn, plain, args, what):
    """The kernel against its plain version on ``args``: equal bit for
    bit; returns max |kernel - plain| (0.0)."""
    got = fn(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = (got != want).sum().item()
        raise AssertionError(
            f"chip_smoke: {what}: {bad} entries differ from the plain "
            f"version (max |diff| {(got - want).abs().max().item()})")
    return (got - want).abs().max().item()


def check_sq_lists_kernel(seed, dev):
    """sq_scan_lists against its plain version: bitwise on dyadic stats
    with integer queries, within 1e-5 x (qn + yn) on generic stats and
    Gaussian queries, at query tiles of 8, 24, 64 and two of 40, d = 96
    (16-byte code copies) and d = 20 (plain loads), with dead slots,
    empty and full ranges and the clamped tail window. Returns the
    generic cases' max |kernel - plain| over live slots."""
    from raft_tpu_torch.spatial.ann import sq_kernel as sk

    gen = torch.Generator().manual_seed(seed)
    n_lists, nq, l_pad, err = 9, 60, 1160, 0.0
    for d in (DIM, 20):
        n_rows = 4 * l_pad + 3
        origins, bounds = list_windows(gen, n_lists, n_rows, l_pad, dev)
        codes = torch.randint(-128, 128, (n_rows, d), generator=gen,
                              dtype=torch.int8).to(dev)
        for dyadic in (True, False):
            qr, _, vmin, vscale = sq_int_inputs(gen, 1, nq, d, 8, dev, dyadic)
            queries = torch.cat([qr[0], qr.new_zeros((1, d))])
            for q in (8, 24, 64, 65):
                call = (queries, slot_map(gen, n_lists, q, nq, nq, dev), codes,
                        origins, bounds, l_pad, vmin, vscale)
                if dyadic:
                    bitwise(sk.sq_scan_lists, sk.sq_scan_lists_plain, call,
                            f"sq_scan_lists d={d} Q={q}")
                else:
                    err = max(err, compare_lists_to_plain(call))
    return err


def compare_sq_to_plain(args):
    """sq_scan_subchunk_min (the gathered entry) vs its plain version on
    generic stats: masked entries equal, valid ones within 1e-5 x (qn +
    yn). Returns max |kernel - plain|."""
    from raft_tpu_torch.spatial.ann import sq_kernel as sk

    qr, codes_t, bounds, vmin, vscale = args
    lb, q, d = qr.shape
    got = sk.sq_scan_subchunk_min(*args)
    want = sk.sq_scan_subchunk_min_plain(*args)
    y = sk._dequant_tile(codes_t, vmin.reshape(1, d, 1),
                         vscale.reshape(1, d, 1)).float()
    qn = (qr.float() ** 2).sum(-1)[:, :, None]
    yn = (y ** 2).sum(1).reshape(lb, 1, -1, 8).amax(-1)
    err = (got - want).abs()
    check(bool((err <= 1e-5 * (qn + yn)).all()),
          f"sq_scan_subchunk_min {tuple(qr.shape)} x {tuple(codes_t.shape)}: "
          f"off by {err.max().item()} > 1e-5 x (qn + yn)")
    return err.max().item()


def quantized_phase(kind, args, card, dev, data):
    """The IVF-SQ path ("sq") and its scan kernel; returns the kernel's
    entry of the ``kernels`` line. (IVF-PQ is :func:`pq_phase`.)"""
    from raft_tpu_torch.spatial.ann import sq_kernel as sk

    check(kind == "sq", f"quantized_phase runs IVF-SQ, not {kind}")
    x, q_np, true = data
    gen = torch.Generator().manual_seed(args.seed)
    fn_name = "sq_scan_subchunk_min"
    # the gathered entry: bitwise on dyadic stats (integer queries), within
    # 1e-5 x (qn + yn) on generic ones, at the old per-block shape and a
    # ragged one (Q off the 8-slot grain, d off the 16-byte code grain)
    errs = []
    for lb, q, d, l_pad in ((32, 24, DIM, 512), (3, 13, 24, 136)):
        bounds = _bounds(gen, lb, l_pad, dev)
        for dyadic in (True, False):
            qr, codes_t, vmin, vscale = sq_int_inputs(
                gen, lb, q, d, l_pad, dev, dyadic)
            call = (qr, codes_t, bounds, vmin, vscale)
            if dyadic:
                errs.append(bitwise(sk.sq_scan_subchunk_min,
                                    sk.sq_scan_subchunk_min_plain, call,
                                    f"{fn_name} ({lb},{q},{d},{l_pad})"))
            else:
                errs.append(compare_sq_to_plain(call))
    errs.append(check_sq_lists_kernel(args.seed, dev))
    log(f"kernel check {fn_name} and sq_scan_lists: bitwise on dyadic "
        "stats, generic stats within 1e-5 x (qn + yn), max |kernel - "
        f"plain| {max(errs):.3g} (gathered (32, 24, 96, 512), (3, 13, 24, "
        "136); lists Q 8/24/64/65, d 96 and 20, dead slots, empty/full/"
        "tail windows)")

    def key(a):
        # (query slots, Lpad) of one launch
        return (a[1].shape[1], a[5])

    # the main path, with every launch counter at 0 just before it; each
    # kernel-engine batch and the calls it launched are kept
    rng = np.random.default_rng(args.seed + 2)
    qb = torch.as_tensor(q_np, device=dev)
    sk.LAUNCHES = 0
    engine_fallbacks("ivf_sq", reset=True)
    keep = []
    with kernel_calls(sk, "sq_scan_lists", key, keep) as shapes, \
            path_batches("ivf_sq", keep) as batches, \
            rerank_path() as reranked:
        index, _ = quantized_path(kind, x, qb, true, rng, card, dev)
    launches = sk.LAUNCHES
    reranks = rerank_path_entry(reranked, "IVF-SQ main path", card,
                                kernel=False)
    del reranked
    log(f"sq path: sq_scan_lists launched {launches} times, by (Q, Lpad): "
        f"{dict(shapes)}; ENGINE_FALLBACKS {engine_fallbacks("ivf_sq")}")
    check(launches > 0, "the sq path never launched sq_scan_lists")
    check(engine_fallbacks("ivf_sq") == 0,
          f"{engine_fallbacks("ivf_sq")} sq searches left the kernel")
    per_batch = collections.Counter(len(c) for _, c in batches)
    log(f"sq path: {len(batches)} kernel-engine batches, sq_scan_lists "
        f"launches per batch {dict(per_batch)} (68 per batch before)")
    check(set(per_batch) == {1} and len(batches) == launches,
          f"sq launches per batch {dict(per_batch)} (one expected)")

    # the kernel against its plain version on every launch of the path:
    # its own query rows, slot maps, in-place codes and windows
    max_err = max(compare_lists_to_plain(call) for call in keep)
    log(f"kernel check on the sq path: all {len(keep)} sq_scan_lists calls "
        "within 1e-5 x (qn + yn) of the plain version, max |kernel - "
        f"plain| {max_err:.3g}")
    by_batch = batch_per_key(batches, lambda nq, c: (nq,) + key(c[0]))
    n_lists = index.centroids.shape[0]
    del keep, batches

    timed = {}
    for (nq, q_, l_pad), (_, (call,), warm) in sorted(by_batch.items()):
        ms, plain_ms, gathered_ms, library_ms = time_lists(call)
        bound_ms, bound_by = lists_scan_bound(*call)
        live_ms, _ = lists_scan_bound(*call, live_only=True)
        timed[nq, q_, l_pad] = (ms, plain_ms, library_ms, bound_ms, bound_by,
                                gathered_ms, live_ms)
        live = int((call[1] < call[0].shape[0] - 1).any(1).sum())
        log(f"[{card}] sq_scan_lists per batch of {nq}"
            f"{' (the warmup, all zeros)' if warm else ''} at (lists, Q, d, "
            f"Lpad) ({n_lists}, {q_}, {DIM}, {l_pad}), {live} lists with a "
            f"live slot, {shapes[q_, l_pad]} launches at this (Q, Lpad): "
            f"kernel {ms:.4f} ms ({bound_ms / ms:.1%} of the bound, "
            f"{live_ms / ms:.1%} of the live-minima bound), bound "
            f"{bound_ms:.5f} ms ({bound_by}), live-minima bound "
            f"{live_ms:.5f} ms, gathered form {gathered_ms:.4f} ms (32-list "
            f"gathers + launches), library {library_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms")
    # the line reports the batch size of the (Q, Lpad) launched most, its
    # smallest bucket
    qc, l_pad = shapes.most_common(1)[0][0]
    nq = min(k[0] for k in timed if k[1:] == (qc, l_pad))
    ms, plain_ms, library_ms, bound_ms, bound_by, gathered_ms, live_ms = \
        timed[nq, qc, l_pad]

    # the mutation tier on this index, its counters at 0 just before it
    sk.LAUNCHES = 0
    engine_fallbacks("ivf_sq", reset=True)
    mnums, n_kernel = mutable_quantized("sq", index, x, qb, dev, card)
    mnums.update(launches=sk.LAUNCHES, kernel_searches=n_kernel,
                 engine_fallbacks=engine_fallbacks("ivf_sq"))
    log(f"[{card}] sq mutation: " + json.dumps(mnums))
    check(sk.LAUNCHES == n_kernel and engine_fallbacks("ivf_sq") == 0,
          f"sq mutation: {sk.LAUNCHES} sq_scan_lists launches for "
          f"{n_kernel} kernel-engine searches, fallbacks "
          f"{engine_fallbacks("ivf_sq")}")
    # the cold tier over this index, on its pinned legacy engine
    before = (sk.LAUNCHES, engine_fallbacks("ivf_sq"))
    tnums = sq_tier(index, qb, card, dev)
    check((sk.LAUNCHES, engine_fallbacks("ivf_sq")) == before,
          f"the SQ tier launched sq_scan_lists or fell back: {before} -> "
          f"{(sk.LAUNCHES, engine_fallbacks("ivf_sq"))}")
    # approx_knn_search on this index takes the per-query path at any
    # batch size (the JAX package's dispatch table: IVF-SQ has no
    # throughput path), so it launches no SQ scan
    from raft_tpu_torch.spatial.ann import approx_knn_search, ivf_sq_search

    sync(dev)
    t0 = time.perf_counter()
    got = approx_knn_search(index, qb, K, n_probes=QZ_PROBES)
    sync(dev)
    tnums["approx_4096_ms"] = 1e3 * (time.perf_counter() - t0)
    want = ivf_sq_search(index, qb, K, n_probes=QZ_PROBES)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
          and (sk.LAUNCHES, engine_fallbacks("ivf_sq")) == before,
          "approx_knn_search on IVF-SQ: not the per-query search's answer, "
          "or it launched sq_scan_lists")
    log(f"[{card}] approx_knn_search on IVF-SQ at {qb.shape[0]} queries: "
        f"the per-query path ({tnums['approx_4096_ms']:.1f} ms), bitwise "
        "ivf_sq_search, 0 sq_scan_lists launches")
    return {
        "name": fn_name,
        "route": "cuda",
        "source": "raft_tpu_torch/csrc/flat_scan.cu",
        "replaces": "raft_tpu/spatial/ann/sq_kernel.py:114",
        "entry": "sq_scan_lists",
        "launches": launches,
        "launches_by_shape": {f"{a}x{b}": n for (a, b), n in shapes.items()},
        "max_abs_err": max(max(errs), max_err),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_live_ms": live_ms,
        "library_ms": library_ms,
        "gathered_ms": gathered_ms,
        "batch": nq,
        "shape": [n_lists, qc, DIM, l_pad],
        "card": card,
        "per_batch": {"x".join(map(str, k[:2])): dict(zip(
            ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "gathered_ms", "bound_live_ms"), v)) for k, v in timed.items()},
        "mutation": mnums,
        "tier": tnums,
        "rerank_path": reranks,
    }


def sq_tier(index, qb, card, dev):
    """The cold tier over the IVF-SQ index: at capacity 4 its hot buffer
    holds the int8 codes, and the batch's queries that probe only hot
    lists get the resident legacy SQ search's answer; with every list hot
    (a store of ``n_lists`` slots) the whole 4,096 batch gets it — ids
    equal and distances bitwise. Returns the numbers."""
    from raft_tpu_torch.obs import MetricRegistry
    from raft_tpu_torch.spatial.ann.common import coarse_probe, static_qcap
    from raft_tpu_torch.spatial.ann.ivf_sq import ivf_sq_search_grouped
    from raft_tpu_torch.tier import TieredListStore

    st = index.storage
    n_lists = st.list_index.shape[0]
    cold = st.n * DIM
    store = TieredListStore(index, hbm_budget_bytes=cold // TIER_CAPACITY,
                            name="smoke_sq_tier", registry=MetricRegistry())
    cap = cold / (store.n_slots * st.max_list * DIM)
    check(store._hot_data.dtype == torch.int8 and store._hot_data.is_cuda
          and cap >= TIER_CAPACITY,
          f"SQ tier: hot buffer {store._hot_data.dtype} on "
          f"{store._hot_data.device}, capacity {cap:.2f}x")

    def same(tier_store, q):
        qc = static_qcap(None, q.shape[0], QZ_PROBES, n_lists)
        tv, ti = tier_store.search(q, K, n_probes=QZ_PROBES, qcap=qc)
        rv, ri = ivf_sq_search_grouped(index, q, K, n_probes=QZ_PROBES,
                                       qcap=qc, use_kernel=False)
        return torch.equal(ti, ri) and torch.equal(tv, rv)

    probes, _ = coarse_probe(qb, index.centroids, QZ_PROBES)
    hist = torch.bincount(probes.flatten(), minlength=n_lists).cpu().numpy()
    store.promote(np.argsort(-hist, kind="stable")[:store.n_slots].tolist())
    hot = torch.zeros(n_lists, dtype=torch.bool, device=dev)
    hot[torch.as_tensor(store.hot_lists(), device=dev).long()] = True
    ok = torch.nonzero(hot[probes].all(1)).squeeze(1)
    n_ok = int(ok.numel())
    check(n_ok == 0 or same(store, qb[ok]),
          "SQ tier at capacity 4: the hot-only queries' answer differs")
    n_slots = store.n_slots
    del store
    full = TieredListStore(index, n_slots=n_lists, name="smoke_sq_tier_all",
                           registry=MetricRegistry())
    full.promote(range(n_lists))
    check(same(full, qb), "SQ tier, every list hot: the answer differs from "
          "the resident legacy SQ search")
    nums = {"n_slots": n_slots, "capacity_x": cap, "hot_dtype": "int8",
            "hot_bytes_all": full.stats().hot_bytes,
            "hot_only_queries": n_ok}
    log(f"[{card}] SQ tier: int8 hot buffer at {cap:.2f}x capacity "
        f"({nums['n_slots']} of {n_lists} lists), {n_ok} of "
        f"{qb.shape[0]} queries probing only hot lists answered as the "
        f"resident legacy SQ search; with all {n_lists} lists hot "
        f"({full.stats().hot_bytes / 1e6:.1f} MB of codes) the "
        f"{qb.shape[0]}-query batch too, ids equal and distances bitwise")
    return nums


def pq_lists_inputs(gen, n_lists, q, m, k_codes, l_pad, dev, integer):
    """An ADC list-scan case: LUT rows (integer-valued or Gaussian), a
    slot map with dead slots (-1), code rows and their windows."""
    n_luts, n_rows = 60, 4 * l_pad + 3
    luts = (torch.randint(-64, 64, (n_luts, m * k_codes), generator=gen)
            .float() if integer else
            torch.randn((n_luts, m * k_codes), generator=gen))
    codes = torch.randint(0, k_codes, (n_rows, m), generator=gen,
                          dtype=torch.uint8).to(dev)
    origins, bounds = list_windows(gen, n_lists, n_rows, l_pad, dev)
    return (luts.to(torch.bfloat16).to(dev),
            slot_map(gen, n_lists, q, n_luts, -1, dev), codes, origins,
            bounds, l_pad)


def pq_batch_bound(calls, live_only=False):
    """(bound_ms, bound_by) of one batch's ADC launches, counted on
    these inputs: the LUT rows of the live slots (bf16), the codes of the
    [lo, hi) rows of the lists with a live slot, the slot maps, origins
    and bounds read once, and every minimum written once (f32), or with
    ``live_only`` the live slots' minima only (those the pool reads); one
    f32 add per (live slot, in-range row, subspace)."""
    nbytes, adds = 0, 0
    for luts, lut_map, codes, _, bounds, l_pad in calls:
        m = codes.shape[1]
        n_lists, q = lut_map.shape
        n_live = ((lut_map >= 0) & (lut_map < luts.shape[0])).sum(1)
        span = (bounds[:, 1].clamp(0, l_pad)
                - bounds[:, 0].clamp(0, l_pad)).clamp(min=0)
        span = torch.where(n_live > 0, span, 0)
        n_out = int(n_live.sum()) if live_only else n_lists * q
        nbytes += (int(n_live.sum()) * luts.shape[1] * 2
                   + int(span.sum()) * m + n_lists * q * 4 + n_lists * 12
                   + n_out * (l_pad // 8) * 4)
        adds += int((n_live * span).sum()) * m
    return bound(nbytes, 1.0 * adds, FP32_FLOP_PER_S)


def batch_copies(calls):
    """Copies of a batch's launch arguments (each tensor cloned) that
    together fill four times the L2 cache, at least two."""
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                 50 << 20)
    nbytes = sum(t.numel() * t.element_size() for c in calls for t in c
                 if isinstance(t, torch.Tensor))
    return [tuple(tuple(t.clone() if isinstance(t, torch.Tensor) else t
                        for t in c) for c in calls)
            for _ in range(max(2, math.ceil(4 * l2 / nbytes)))]


def dense_batch(calls):
    """A batch's LUT rows laid out per (list, slot), zeros in dead slots,
    and its windows over all lists: the gathered form's operands."""
    luts = [c[0][c[1].clamp(min=0).long()]
            * (c[1] >= 0)[:, :, None].to(torch.bfloat16)
            if c[0].shape[0] else
            c[0].new_zeros(tuple(c[1].shape) + (c[0].shape[1],))
            for c in calls]
    return (torch.cat(luts), torch.cat([c[3] for c in calls]),
            torch.cat([c[4] for c in calls]))


def time_pq_batch(calls):
    """ms of one batch's ADC launches (every LUT chunk), of their plain
    versions, of the gathered form they replaced (per 8-list block a
    code-slab gather and one launch over the block's dense LUT; the LUT
    build not included) and of the library yardstick (per 8-list block
    a one-hot bf16 expansion of the pre-gathered codes, bmm with the
    dense LUT, the 8-row amin; timed only), each over copies of the
    inputs that overflow L2."""
    from raft_tpu_torch.spatial.ann import pq_kernel as pk

    def run(fn):
        def batch(*cs):
            for c in cs:
                fn(*c)
        return batch

    sets = batch_copies(calls)
    ms = cuda_time_ms(run(pk.pq_adc_lists), sets)
    plain_ms = cuda_time_ms(run(pk.pq_adc_lists_plain), sets, iters=2,
                            warm=1)
    del sets
    codes, l_pad = calls[0][2], calls[0][5]
    win = torch.arange(l_pad, device=codes.device)
    dsets = [dense_batch(calls) for _ in range(2)]

    def gathered(dense, origins, bounds):
        for s in range(0, dense.shape[0], 8):
            slab = codes[origins[s:s + 8].long()[:, None] + win]
            pk.pq_adc_subchunk_min(dense[s:s + 8], slab.transpose(1, 2),
                                   bounds[s:s + 8])

    gathered_ms = cuda_time_ms(gathered, dsets, iters=3, warm=1)
    m = codes.shape[1]
    lib_sets = [(dense, codes[origins.long()[:, None] + win])
                for dense, origins, _ in dsets]
    del dsets
    mk = lib_sets[0][0].shape[2]
    kidx = torch.arange(mk // m, device=codes.device, dtype=torch.uint8)

    def library(dense, slabs):
        q = dense.shape[1]
        for s in range(0, dense.shape[0], 8):
            sl = slabs[s:s + 8].transpose(1, 2)
            lb = sl.shape[0]
            oh = (sl[:, :, None, :] == kidx[None, None, :, None]).to(
                torch.bfloat16).reshape(lb, mk, l_pad)
            torch.bmm(dense[s:s + 8], oh).reshape(
                lb, q, l_pad // 8, 8).amin(-1)

    library_ms = cuda_time_ms(library, lib_sets, iters=2, warm=1)
    return ms, plain_ms, gathered_ms, library_ms


def einsum_lut_rows(queries, cents, cb, cb_n, lists, qids):
    """The f32 PyTorch chain the LUT kernel replaced (an einsum, the
    norms, the sum, the difference, the bf16 cast): the yardstick of
    ``pq_lut_step``, which the port never calls."""
    m, _, ds = cb.shape
    res = (queries[qids] - cents[lists]).reshape(-1, m, ds)
    dots = torch.einsum("pmd,mkd->pmk", res, cb)
    res_n = torch.sum(res * res, dim=2)
    return (res_n[..., None] + cb_n[None] - 2.0 * dots).flatten(1).to(
        torch.bfloat16)


def pq_lut_step(card, dev, seed):
    """The ADC table build (``pq_kernel.pq_lut_rows``) on the card:
    bitwise its plain version at the DEEP-10M cell's LUT chunk (10,922
    pairs of 10,000 queries over 4,096 lists, M 24, K 256, ds 4) and at
    odd shapes (the register path's ds 3 and 8, and ds 12 and K 7 off
    it), then timed at the chunk beside its bound (the bf16 rows written
    once, the distinct query and centroid rows, the codebooks and ids
    read once), the plain version and the einsum chain it replaced. The
    inputs stay in L2 across launches, as across a search's chunks."""
    from raft_tpu_torch.spatial.ann import ivf_pq
    from raft_tpu_torch.spatial.ann import pq_kernel as pk

    gen = torch.Generator(device=dev).manual_seed(seed)

    def case(n_pairs, m, k, ds, nq, n_lists):
        d = m * ds
        queries = torch.randn((nq + 1, d), generator=gen, device=dev)
        queries[nq] = 0.0
        cents = torch.randn((n_lists, d), generator=gen, device=dev)
        cb = torch.randn((m, k, ds), generator=gen, device=dev)
        lists = torch.randint(0, n_lists, (n_pairs,), generator=gen,
                              device=dev)
        qids = torch.randint(0, nq + 1, (n_pairs,), generator=gen,
                             device=dev)
        return queries, cents, cb, (cb * cb).sum(2), lists, qids

    k_codes = 1 << PQ_BITS
    mk = PQ_DIM * k_codes
    chunk = ivf_pq._max_lut_pairs(mk)
    shapes = ((chunk, PQ_DIM, k_codes, DIM // PQ_DIM, 10_000, 4096),
              (7, 3, 16, 3, 5, 6), (7, 2, 256, 8, 5, 6),
              (37, 5, 16, 12, 9, 4), (41, 3, 7, 3, 9, 4))
    errs = []
    for shp in shapes:
        args = case(*shp)
        before = pk.LUT_LAUNCHES
        errs.append(bitwise(pk.pq_lut_rows, pk.pq_lut_rows_plain, args,
                            f"pq_lut_rows (P, M, K, ds) {shp[:4]}"))
        check(pk.LUT_LAUNCHES == before + 1,
              f"pq_lut_rows {shp[:4]}: {pk.LUT_LAUNCHES - before} launches")
    log("kernel check pq_lut_rows: bitwise the plain version at (P, M, K, "
        "ds) " + ", ".join(str(s[:4]) for s in shapes))
    args = case(*shapes[0])
    queries, cents, cb, cb_n, lists, qids = args
    ms = cuda_time_ms(pk.pq_lut_rows, [args])
    plain_ms = cuda_time_ms(pk.pq_lut_rows_plain, [args], iters=5, warm=1)
    library_ms = cuda_time_ms(einsum_lut_rows, [args], iters=5, warm=1)
    d = queries.shape[1]
    nbytes = (chunk * mk * 2 + 4 * d * (int(torch.unique(qids).numel())
                                        + int(torch.unique(lists).numel()))
              + 4 * (cb.numel() + cb_n.numel()) + 16 * chunk)
    ds = d // PQ_DIM
    bound_ms, bound_by = bound(nbytes, chunk * mk * (2.0 * ds + 2)
                               + chunk * PQ_DIM * 2.0 * ds,
                               FP32_FLOP_PER_S)
    log(f"[{card}] pq_lut_rows at (P, M*K, ds) ({chunk}, {mk}, {ds}): "
        f"kernel {ms:.4f} ms ({bound_ms / ms:.1%} of the bound), bound "
        f"{bound_ms:.5f} ms ({bound_by}, {nbytes / 1e6:.1f} MB), plain "
        f"{plain_ms:.4f} ms, einsum chain {library_ms:.4f} ms")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": [chunk, mk, ds], "max_abs_err": max(errs)}


# top_k_smallest's kernel at the cells' shapes: (rows, n, k) of the IVF
# pool (32 probes x 448 sub-chunks, c = 40), the coarse probe (4,096
# lists), and the brute force's two selections at SIFT-1M's shape
SELECT_K_SHAPES = ((10_000, 14_336, 40), (10_000, 4096, 32),
                   (10_000, 7824, 48), (10_000, 6144, 10))


def select_k_rows(kind, rows, n, gen, dev):
    """(rows, n) f32 rows of one kind: distance-like (positive, 5% BIG),
    tie-heavy (four values), or special values (-0.0 and 0.0, both
    infinities, both NaN signs, BIG, ties)."""
    big = 1e30
    if kind == "distance":
        x = torch.rand((rows, n), generator=gen, device=dev) * 400 + 100
        return torch.where(torch.rand((rows, n), generator=gen, device=dev)
                           < 0.05, big, x)
    if kind == "ties":
        return torch.randint(0, 4, (rows, n), generator=gen,
                             device=dev).float()
    neg_nan = torch.tensor([0xffc00000 - 2 ** 32], dtype=torch.int32)
    special = torch.cat([
        torch.tensor([0.0, -0.0, math.inf, -math.inf, math.nan, big, 1.0,
                      1.0]), neg_nan.view(torch.float32)]).to(dev)
    return special[torch.randint(0, special.numel(), (rows, n),
                                 generator=gen, device=dev)]


def time_select_k(x, k):
    """(ms, plain_ms, library_ms, bound_ms, bound_by) of the selection
    kernel at ``x``'s shape, over copies that overflow the L2: the
    kernel, the sort route, ``torch.topk`` (which the port never calls),
    and the byte bound (each entry read once, k values and indices
    written)."""
    from raft_tpu_torch.spatial import selection as tsel

    n = x.shape[-1]
    rows = x.numel() // n
    sets = input_copies(x.contiguous())
    ms = cuda_time_ms(lambda t: tsel.top_k_smallest_kernel(t, k), sets)
    plain_ms = cuda_time_ms(lambda t: tsel.top_k_smallest_plain(t, k), sets,
                            iters=10, warm=2)
    library_ms = cuda_time_ms(
        lambda t: torch.topk(t, k, largest=False, sorted=True), sets,
        iters=10, warm=2)
    bound_ms, bound_by = bound(rows * n * 4 + rows * k * 12, 0.0,
                               FP32_FLOP_PER_S)
    return ms, plain_ms, library_ms, bound_ms, bound_by


def select_k_step(card, dev, seed):
    """``top_k_smallest``'s selection kernel on the card at the cells'
    shapes, which the smoke's paths are too small to give it: bitwise the
    stable-sort route (values' bits and indices, and twice alike) on
    distance-like, tie-heavy and special-value rows, then timed
    (:func:`time_select_k`) on distance-like rows."""
    from raft_tpu_torch.spatial import selection as tsel

    gen = torch.Generator(device=dev).manual_seed(seed)
    for rows, n, k in SELECT_K_SHAPES:
        for kind in ("distance", "ties", "special"):
            x = select_k_rows(kind, rows, n, gen, dev)
            before = tsel.SELECT_K_LAUNCHES
            v, i = tsel.top_k_smallest(x, k)
            v2, i2 = tsel.top_k_smallest(x, k)
            wv, wi = tsel.top_k_smallest_plain(x, k)
            torch.cuda.synchronize()
            check(tsel.SELECT_K_LAUNCHES == before + 2,
                  f"top_k_smallest {(rows, n, k)} left the kernel")
            bits = [t.view(torch.int32) for t in (v, v2, wv)]
            check(torch.equal(i, wi) and torch.equal(i2, wi)
                  and torch.equal(bits[0], bits[2])
                  and torch.equal(bits[1], bits[2]),
                  f"select_k {(rows, n, k)} {kind}: differs from the sort")
    log("kernel check select_k: bitwise the stable sort, twice alike, at "
        f"(rows, n, k) {SELECT_K_SHAPES} on distance, tie and special rows")
    out = []
    for rows, n, k in SELECT_K_SHAPES:
        ms, plain_ms, library_ms, bound_ms, bound_by = time_select_k(
            select_k_rows("distance", rows, n, gen, dev), k)
        log(f"[{card}] select_k at (rows, n, k) {(rows, n, k)}: kernel "
            f"{ms:.4f} ms ({bound_ms / ms:.1%} of the bound), bound "
            f"{bound_ms:.4f} ms ({bound_by}), sort {plain_ms:.4f} ms, "
            f"torch.topk {library_ms:.4f} ms")
        out.append({"shape": [rows, n, k], "ms": ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by})
    return out


# the exact rerank R at the cells' shapes: (queries, candidates, d, rows)
# of the DEEP-10M cells (both rerank 10,000 x 40 sub-chunks of 8 rows
# over 10M x 96 rows) and the GIST-1M cell (1M x 960)
RERANK_SHAPES = ((10_000, 320, 96, 10_000_000),
                 (10_000, 320, 960, 1_000_000))


def rerank_gather_chain(qf, src, rpos, valid, n):
    """What R replaced: the rows gathered in query blocks whose gather
    stays under ``grouped.RERANK_BLOCK_BYTES``, each block scored by
    ``score_l2_candidates`` (the gather route of ``grouped._rerank``
    without its selection)."""
    from raft_tpu_torch.spatial.ann import common as cm, grouped

    nq, c = rpos.shape
    rpos = rpos.long()
    blk = max(8, min(nq, grouped.RERANK_BLOCK_BYTES // (c * qf.shape[1] * 4)))
    return torch.cat([
        cm.score_l2_candidates(qf[s:s + blk],
                               src[torch.clamp(rpos[s:s + blk], 0, n)],
                               valid[s:s + blk] & (rpos[s:s + blk] < n))
        for s in range(0, nq, blk)])


def time_rerank(args):
    """R on ``args`` = (qf, src, rpos, valid), timed beside two byte
    bounds: every valid candidate's row read once for each query that
    holds it (as R reads them), and each distinct valid row read once
    (what a rerank that shares a row among its queries must still read);
    each with the queries, positions, mask and output. Also times the
    plain version (the batch gathered) and the gather chain R replaced."""
    from raft_tpu_torch.spatial.ann import rerank as rr

    qf, src, rpos, valid = args
    nq, c = rpos.shape
    n, d = src.shape[0] - 1, src.shape[1]
    live_mask = valid & (rpos >= 0) & (rpos < n)
    live = int(live_mask.sum())
    distinct = int(torch.unique(rpos[live_mask]).numel())
    rest = 4 * d * nq + nq * c * (8 + 1 + 4)
    ms = cuda_time_ms(rr.rescore_rows_kernel, [args], iters=20, warm=3)
    plain_ms = cuda_time_ms(rr.rescore_rows_plain, [args], iters=3, warm=1)
    library_ms = cuda_time_ms(rerank_gather_chain, [args + (n,)], iters=3,
                              warm=1)
    bound_ms, bound_by = bound(4 * d * live + rest, 4.0 * d * live,
                               FP32_FLOP_PER_S)
    distinct_ms, distinct_by = bound(4 * d * distinct + rest,
                                     4.0 * d * live, FP32_FLOP_PER_S)
    return {"shape": [nq, c, d, n + 1], "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "live_rows": live,
            "distinct_rows": distinct, "bound_distinct_ms": distinct_ms,
            "bound_distinct_by": distinct_by}


def rerank_line(t):
    """The log line's part of :func:`time_rerank`'s timing ``t``."""
    ms, reads = t["ms"], t["live_rows"] / max(t["distinct_rows"], 1)
    return (f"kernel {ms:.4f} ms ({t['bound_ms'] / ms:.1%} of the bound "
            f"over every valid candidate, {t['bound_distinct_ms'] / ms:.1%} "
            f"of the bound over the distinct rows), bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}, {t['live_rows']} "
            f"rows), distinct-row bound {t['bound_distinct_ms']:.4f} ms "
            f"({t['bound_distinct_by']}, {t['distinct_rows']} rows, "
            f"{reads:.2f} reads a row), "
            f"plain {t['plain_ms']:.4f} ms, gather chain "
            f"{t['library_ms']:.4f} ms")


def rerank_step(card, dev, seed):
    """R (``rerank.rescore_rows_kernel``) at the cells' shapes, which no
    smoke path reaches: pools of 40 sub-chunks a query at random 8-aligned
    slab positions (2% of the rows masked, the sentinel among them),
    bitwise its plain version on integer-valued rows, then timed
    (:func:`time_rerank`), then held to the plain version within the f32
    summation bound on Gaussian rows."""
    from raft_tpu_torch.spatial.ann import rerank as rr

    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for nq, c, d, n in RERANK_SHAPES:
        src = torch.randint(-64, 64, (n + 1, d), generator=gen, device=dev,
                            dtype=torch.int32).float()
        src[n] = 0.0
        qf = torch.randint(-64, 64, (nq, d), generator=gen, device=dev,
                           dtype=torch.int32).float()
        base = torch.randint(0, (n + 8) // 8, (nq, c // 8), generator=gen,
                             device=dev) * 8
        rpos = (base[:, :, None] + torch.arange(8, device=dev)).reshape(nq, c)
        valid = torch.rand((nq, c), generator=gen, device=dev) >= 0.02
        args = (qf, src, rpos, valid)
        before = rr.RERANK_LAUNCHES
        bitwise(rr.rescore_rows_kernel, rr.rescore_rows_plain, args,
                f"rescore_rows_kernel (nq, C, d) {(nq, c, d)}")
        check(rr.RERANK_LAUNCHES == before + 1,
              f"rescore_rows_kernel {(nq, c, d)}: "
              f"{rr.RERANK_LAUNCHES - before} launches")
        timed = time_rerank(args)
        src.normal_(generator=gen)
        qf.normal_(generator=gen)
        got = rr.rescore_rows_kernel(*args)
        want = rr.rescore_rows_plain(*args)
        yn = (src * src).sum(1)[torch.clamp(rpos, 0, n)]
        tol = (4 * d + 8) * 2.0 ** -24 * ((qf * qf).sum(1)[:, None] + yn)
        fin = torch.isfinite(want)
        err = float((got - want).abs()[fin].max())
        check(torch.equal(fin, torch.isfinite(got))
              and bool(((got - want).abs() <= tol)[fin].all()),
              f"rescore_rows_kernel {(nq, c, d)}: Gaussian rows off the "
              f"plain version beyond the f32 summation bound (max {err})")
        del src, got, want, yn, tol
        log(f"[{card}] rescore_rows_kernel (R) at (nq, C, d) {(nq, c, d)} "
            f"over {n + 1} rows, uniform pools: {rerank_line(timed)}; "
            f"bitwise on integer rows, Gaussian max |diff| {err:.3g} within "
            "the f32 summation bound")
        out.append(dict(timed, gaussian_max_abs_err=err))
    return out


@contextlib.contextmanager
def rerank_path():
    """The exact rerank on a main path: ``RERANK_LAUNCHES`` at 0 just
    before it, the route of each rerank counted (and, where it gathers,
    its engine's source), and each launch of R held against
    ``rescore_rows_plain`` on its own inputs as it runs: +inf exactly
    where the plain version has it, elsewhere within the f32 summation
    bound (4 d + 8) u (qn + yn). The mismatches and the largest
    difference are kept on the card and read once after the path (so
    the path's times include the plain version). The inputs of the last
    launch of each (queries, candidates, d) are kept for
    :func:`rerank_path_entry`."""
    from raft_tpu_torch.spatial.ann import rerank as rr

    fits, launch = rr.rerank_kernel_fits, rr.rescore_rows_kernel
    seen = {"routes": collections.Counter(),
            "gathered": collections.Counter(),
            "shapes": collections.Counter(), "last": {}, "norms": {},
            "mismatches": 0, "max_err": 0.0, "launching": False}

    def routing(qf, src):
        kernel = fits(qf, src)
        if seen["launching"]:
            # the launch's own check of the rule, not a rerank
            return kernel
        seen["routes"]["kernel" if kernel else "gather"] += 1
        if not kernel:
            seen["gathered"]["no source" if src is None else (
                f"{src.device.type} {src.dtype} {tuple(src.shape)}")] += 1
        return kernel

    def recording(qf, src, rpos, valid):
        seen["launching"] = True
        try:
            got = launch(qf, src, rpos, valid)
        finally:
            seen["launching"] = False
        shape = (*rpos.shape, src.shape[1])
        seen["shapes"][shape] += 1
        seen["last"][shape] = (qf, src, rpos, valid)
        if not got.numel():
            return got
        want = rr.rescore_rows_plain(qf, src, rpos, valid)
        # the rows' squared norms, once for each state of the rows
        key = (src.data_ptr(), tuple(src.shape), src._version)
        if key not in seen["norms"]:
            seen["norms"] = {key: (src * src).sum(1)}
        yn = seen["norms"][key][torch.clamp(rpos.long(), 0,
                                            src.shape[0] - 1)]
        tol = (4 * src.shape[1] + 8) * 2.0 ** -24 * (
            (qf * qf).sum(1)[:, None] + yn)
        fin = torch.isfinite(want)
        diff = torch.where(fin, (got - want).abs(), 0.0)
        seen["mismatches"] = seen["mismatches"] + (
            torch.isfinite(got) != fin).sum() + (diff > tol).sum()
        seen["max_err"] = torch.maximum(torch.as_tensor(seen["max_err"],
                                                        device=got.device),
                                        diff.max())
        return got

    rr.RERANK_LAUNCHES = 0
    rr.rerank_kernel_fits = routing
    rr.rescore_rows_kernel = recording
    try:
        yield seen
    finally:
        rr.rerank_kernel_fits = fits
        rr.rescore_rows_kernel = launch
        seen["norms"].clear()


def rerank_path_entry(seen, what, card, kernel=True):
    """Check what :func:`rerank_path` saw on a path. With ``kernel``: R's
    launch count equals the reranks routed to it and the launches it
    recorded, no rerank gathered, and no launch left the plain version's
    bound; then R is timed (:func:`time_rerank`) on the path's widest
    pool, the last launch at the most queries. Without it (an engine with
    no f32 rows): every rerank gathered and R never launched. Returns the
    counts, the largest difference measured and the timing."""
    from raft_tpu_torch.spatial.ann import rerank as rr

    launches, routes, shapes = (rr.RERANK_LAUNCHES, seen["routes"],
                                seen["shapes"])
    recorded = sum(shapes.values())
    if kernel:
        check(launches > 0 and launches == routes["kernel"] == recorded
              and routes["gather"] == 0,
              f"{what}: {launches} R launches, {routes['kernel']} reranks "
              f"routed to it, {recorded} recorded, {routes['gather']} "
              f"gathered ({dict(seen['gathered'])})")
    else:
        check(launches == routes["kernel"] == recorded == 0
              and routes["gather"] > 0,
              f"{what}: {launches} R launches, {routes['kernel']} reranks "
              f"routed to it, {routes['gather']} gathered")
    mismatches = int(seen["mismatches"])
    err = float(seen["max_err"])
    check(mismatches == 0, f"{what}: {mismatches} R distances off "
          "rescore_rows_plain beyond the f32 summation bound")
    log(f"{what}: R launched {launches} times"
        + (f", each within the f32 summation bound of rescore_rows_plain "
           f"(max |kernel - plain| {err:.3g}), by (queries, C, d) "
           f"{dict(shapes)}" if launches else "")
        + f"; {routes['gather']} reranks gathered, by source "
        f"{dict(seen['gathered'])}")
    out = {"launches": launches, "kernel_calls": routes["kernel"],
           "recorded": recorded, "gather_calls": routes["gather"],
           "max_abs_err": err,
           "by_shape": {"x".join(map(str, k)): v for k, v in shapes.items()}}
    if kernel:
        t = time_rerank(seen["last"][max(shapes)])
        log(f"[{card}] rescore_rows_kernel on the {what}'s widest pool "
            f"(nq, C, d) {tuple(t['shape'][:3])} over {t['shape'][3]} rows: "
            f"{rerank_line(t)}")
        out["timed"] = t
    return out


def rerank_entry(paths, cells, card):
    """The ``kernels`` entry of R: its launches and the largest difference
    from the plain version on each path checked by :func:`rerank_path`
    (``paths``, by path), and its times at the cells' shapes (``cells``,
    from :func:`rerank_step`; the entry's top level at GIST's)."""
    check(set(paths) == {"ivf_flat", "gist_width", "ivf_sq", "ivf_pq"},
          f"rerank paths {sorted(paths)}")
    top = cells[-1]
    return {
        "name": "rescore_rows", "route": "cuda",
        "source": "raft_tpu_torch/csrc/rerank.cu",
        "replaces": "none (score_l2_candidates in jnp, fused by XLA)",
        "entry": "rerank.rescore_rows_kernel",
        "launches": sum(p["launches"] for p in paths.values()),
        "paths": paths,
        "max_abs_err": max([p["max_abs_err"] for p in paths.values()]
                           + [c["gaussian_max_abs_err"] for c in cells]),
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "bound_distinct_ms": top["bound_distinct_ms"],
        "library_ms": top["library_ms"], "shape": top["shape"],
        "cells": cells, "card": card,
    }


@contextlib.contextmanager
def select_k_path():
    """``top_k_smallest`` on a main path: ``SELECT_K_LAUNCHES`` at 0 just
    before it, the route of each call counted, and each kernel launch
    held bitwise (values' bits and indices) against
    ``top_k_smallest_plain`` on its own input as it runs, the mismatches
    summed on the card and read once after the path (so the path's times
    include the sorts). The input of the last launch of each (rows, n, k)
    is kept for :func:`select_k_path_entry`."""
    from raft_tpu_torch.spatial import selection as tsel

    fits, launch = tsel.select_k_kernel_fits, tsel.top_k_smallest_kernel
    seen = {"routes": collections.Counter(), "sorted": collections.Counter(),
            "shapes": collections.Counter(), "last": {}, "mismatches": 0}

    def routing(x, k):
        kernel = fits(x, k)
        seen["routes"]["kernel" if kernel else "sort"] += 1
        if not kernel:
            seen["sorted"][x.device.type, str(x.dtype), tuple(x.shape),
                           k] += 1
        return kernel

    def recording(x, k):
        v, i = launch(x, k)
        wv, wi = tsel.top_k_smallest_plain(x, k)
        seen["mismatches"] = seen["mismatches"] + (i != wi).sum() + (
            v.view(torch.int32) != wv.view(torch.int32)).sum()
        key = (x.numel() // x.shape[-1], x.shape[-1], k)
        seen["shapes"][key] += 1
        seen["last"][key] = x
        return v, i

    tsel.SELECT_K_LAUNCHES = 0
    tsel.select_k_kernel_fits = routing
    tsel.top_k_smallest_kernel = recording
    try:
        yield seen
    finally:
        tsel.select_k_kernel_fits = fits
        tsel.top_k_smallest_kernel = launch


def select_k_path_entry(seen, what, card):
    """Check what :func:`select_k_path` saw on a path: the kernel's
    launch count equals the calls routed to it and the launches it
    recorded, and no launch differed from the plain version. Then time
    the kernel (:func:`time_select_k`) at every (rows, n, k) the path gave
    it, on the input of its last launch there. Returns the launches and
    the timings by shape."""
    from raft_tpu_torch.spatial import selection as tsel

    launches = tsel.SELECT_K_LAUNCHES
    shapes, routes = seen["shapes"], seen["routes"]
    check(launches > 0 and launches == routes["kernel"]
          == sum(shapes.values()),
          f"{what}: {launches} select_k launches, {routes['kernel']} calls "
          f"routed to the kernel, {sum(shapes.values())} recorded")
    mismatches = int(seen["mismatches"])
    check(mismatches == 0, f"{what}: {mismatches} selected entries differ "
          "from top_k_smallest_plain")
    log(f"{what}: top_k_smallest launched the selection kernel {launches} "
        f"times, each bitwise the plain version, by (rows, n, k) "
        f"{dict(shapes)}; {routes['sort']} calls took the sort, by "
        f"(device, dtype, shape, k) {dict(seen['sorted'])}")
    timed = []
    for key in sorted(shapes):
        ms, plain_ms, library_ms, bound_ms, bound_by = time_select_k(
            seen["last"][key], key[2])
        log(f"[{card}] select_k on the {what} at (rows, n, k) {key}, "
            f"{shapes[key]} launches: kernel {ms:.4f} ms ({bound_ms / ms:.1%} "
            f"of the bound), bound {bound_ms:.5f} ms ({bound_by}), sort "
            f"{plain_ms:.4f} ms, torch.topk {library_ms:.4f} ms")
        timed.append({"shape": list(key), "launches": shapes[key], "ms": ms,
                      "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by})
    return {"launches": launches, "sort_calls": routes["sort"],
            "by_shape": timed}


def select_k_entry(paths, cells, card):
    """The ``kernels`` entry of the selection kernel: its launches on the
    IVF-Flat, IVF-PQ and brute-force main paths (``paths``, by the entry
    that carried them), its times at the shape they launched most, every
    path shape's times, and the cells' shapes (``cells``, from
    :func:`select_k_step`)."""
    check(set(paths) == {"flat_scan_subchunk_min", "pq_adc_subchunk_min",
                         "chunk_mins"},
          f"select_k paths from {sorted(paths)}")
    launched = collections.Counter()
    timed = {}
    for path in paths.values():
        for t in path["by_shape"]:
            launched[tuple(t["shape"])] += t["launches"]
            timed.setdefault(tuple(t["shape"]), t)
    top = timed[launched.most_common(1)[0][0]]
    return {
        "name": "select_k", "route": "cuda",
        "source": "raft_tpu_torch/csrc/select_k.cu",
        "replaces": "none (lax.top_k, which XLA lowers)",
        "entry": "top_k_smallest",
        "launches": sum(p["launches"] for p in paths.values()),
        "paths": {"ivf_flat": paths["flat_scan_subchunk_min"],
                  "ivf_pq": paths["pq_adc_subchunk_min"],
                  "brute_force": paths["chunk_mins"]},
        "max_abs_err": 0.0,
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"], "shape": top["shape"],
        "cells": cells, "card": card,
    }


def lut_call_counts(searches, batches):
    """Check the ``pq_lut_rows`` calls of each grouped PQ search (from
    :func:`impl_calls`) against what its engine should make, and return
    (kernel-engine LUT chunks, one-hot list blocks). The kernel engine's
    calls take the queries (nq rows), one a LUT chunk, as many as the
    search's ADC launches (its batch in ``batches``, from
    :func:`path_batches`); the one-hot engine's take them with the pad
    row (nq + 1 rows), one a list block of list_block * qcap pairs."""
    chunks = blocks = 0
    kernel_searches = iter(batches)
    for args, kw, calls in searches:
        nq, qcap, list_block = args[1].shape[0], args[4], args[5]
        n_lists = args[0].centroids.shape[0]
        onehot = [c for c in calls if c[0].shape[0] == nq + 1]
        kern = [c for c in calls if c[0].shape[0] == nq]
        adc = next(kernel_searches)[1] if args[0].kernel else []
        check(len(onehot) + len(kern) == len(calls)
              and (not onehot or not kern) and len(kern) == len(adc)
              and len(onehot) in (0, -(-n_lists // list_block))
              and all(c[4].shape[0] == list_block * qcap for c in onehot)
              and all(c[4].shape[0] > 0 for c in calls),
              f"pq search of {nq}: {len(kern)} LUT chunks for {len(adc)} "
              f"ADC launches, {len(onehot)} one-hot LUT blocks for "
              f"{n_lists} lists in blocks of {list_block}")
        chunks += len(kern)
        blocks += len(onehot)
    return chunks, blocks


def pq_phase(args, card, dev, data):
    """The IVF-PQ path and its ADC kernel; returns the kernel's entry of
    the ``kernels`` line."""
    from raft_tpu_torch.spatial.ann import ivf_pq
    from raft_tpu_torch.spatial.ann import pq_kernel as pk

    x, q_np, true = data
    gen = torch.Generator().manual_seed(args.seed)
    fn_name = "pq_adc_subchunk_min"
    errs = []
    for lb, q, m, k_codes, l_pad in ((8, 24, PQ_DIM, 1 << PQ_BITS, 512),
                                     (3, 13, 5, 32, 136),
                                     (2, 13, 96, 256, 264)):
        bounds = _bounds(gen, lb, l_pad, dev)
        for integer in (True, False):
            luts, codes_t = pq_inputs(gen, lb, q, m, k_codes, l_pad,
                                      dev, integer)
            errs.append(bitwise(pk.pq_adc_subchunk_min,
                                pk.pq_adc_subchunk_min_plain,
                                (luts, codes_t, bounds),
                                f"{fn_name} ({lb},{q},{m * k_codes},"
                                f"{l_pad}) integer={integer}"))
    for m, k_codes in ((PQ_DIM, 1 << PQ_BITS), (5, 7), (96, 256)):
        for q in (1, 8, 24, 65):
            for integer in (True, False):
                call = pq_lists_inputs(gen, 9, q, m, k_codes, 1032, dev,
                                       integer)
                errs.append(bitwise(pk.pq_adc_lists, pk.pq_adc_lists_plain,
                                    call, f"pq_adc_lists M={m} K={k_codes} "
                                    f"Q={q} integer={integer}"))
    log(f"kernel check {fn_name}: bitwise on integer and Gaussian LUTs "
        "at (8, 24, 6144, 512), (3, 13, 160, 136) and (2, 13, 24576, "
        "264); pq_adc_lists bitwise at (M, K) (24, 256), (5, 7), (96, 256), "
        "Q 1/8/24/65, dead slots, empty/full/tail windows")
    lut = pq_lut_step(card, dev, args.seed)

    def key(a):
        # (query slots, M*K, Lpad) of one launch
        return (a[1].shape[1], a[0].shape[1], a[5])

    # the main path, with every launch counter at 0 just before it; each
    # kernel-engine batch and the calls it launched are kept
    rng = np.random.default_rng(args.seed + 3)
    qb = torch.as_tensor(q_np, device=dev)
    pk.LAUNCHES = 0
    pk.LUT_LAUNCHES = 0
    engine_fallbacks("ivf_pq", reset=True)
    keep, lut_keep = [], []
    with kernel_calls(pk, "pq_adc_lists", key, keep) as shapes, \
            path_batches("ivf_pq", keep) as batches, \
            kernel_calls(pk, "pq_lut_rows", lambda a: a[4].shape[0],
                         lut_keep), \
            impl_calls("ivf_pq", lut_keep) as searches, \
            select_k_path() as selected, rerank_path() as reranked:
        index, _ = quantized_path("pq", x, qb, true, rng, card, dev)
    launches = pk.LAUNCHES
    select_k = select_k_path_entry(selected, "IVF-PQ main path", card)
    reranks = rerank_path_entry(reranked, "IVF-PQ main path", card)
    del selected, reranked
    lut_launches = pk.LUT_LAUNCHES
    lut["launches"] = lut_launches
    log(f"pq path: pq_adc_lists launched {launches} times, by (Q, M*K, "
        f"Lpad): {dict(shapes)}; pq_lut_rows {lut_launches} times; "
        f"ENGINE_FALLBACKS {engine_fallbacks("ivf_pq")}")
    check(launches > 0, "the pq path never launched the ADC kernel")

    chunks, blocks = lut_call_counts(searches, batches)
    check(lut_launches == chunks + blocks == len(lut_keep)
          and chunks == launches,
          f"{lut_launches} LUT launches for {chunks} kernel-engine chunks "
          f"({launches} ADC launches) and {blocks} one-hot list blocks")
    # the LUT kernel against its plain version on every call of the path
    errs += [bitwise(pk.pq_lut_rows, pk.pq_lut_rows_plain, call,
                     "pq_lut_rows on path inputs") for call in lut_keep]
    log(f"kernel check on the pq path: {len(searches)} searches, "
        f"pq_lut_rows launched once for each of {chunks} kernel-engine "
        f"chunks and {blocks} one-hot list blocks, every call bitwise "
        "equal to the plain version")
    del lut_keep, searches
    check(engine_fallbacks("ivf_pq") == 0,
          f"{engine_fallbacks("ivf_pq")} pq searches left the kernel")

    # launches per batch: one where the batch's nq * p pairs fit one LUT
    # chunk, else one per chunk of lists under the pair budget, each with
    # a live pair
    n_lists = index.centroids.shape[0]
    max_pairs = ivf_pq._max_lut_pairs(PQ_DIM << PQ_BITS)
    per_batch = collections.Counter()
    for q, calls in batches:
        nq = q.shape[0]
        pairs = [int((c[1] >= 0).sum()) for c in calls]
        per_batch[nq, calls[0][1].shape[1], len(calls)] += 1
        check(len(calls) == 1 if nq * QZ_PROBES <= max_pairs else
              (sum(c[1].shape[0] for c in calls) <= n_lists
               and all(0 < n <= max_pairs or c[1].shape[0] == 1
                       for n, c in zip(pairs, calls))),
              f"pq batch of {nq}: {len(calls)} launches with live pairs "
              f"{pairs} (one, or LUT chunks of at most {max_pairs} pairs)")
    log(f"pq path: {len(batches)} kernel-engine batches, ADC launches per "
        "batch by (queries, Q): "
        + ", ".join(f"{a} x {q_}: {n} ({c} batches)"
                    for (a, q_, n), c in sorted(per_batch.items()))
        + f"; 256 8-list blocks a batch before, at most {max_pairs} live "
        "pairs a chunk")
    check(sum(len(c) for _, c in batches) == launches,
          "pq launches outside the recorded batches")

    # the kernel against its plain version on every launch of the path
    errs += [bitwise(pk.pq_adc_lists, pk.pq_adc_lists_plain, call,
                     "pq_adc_lists on path inputs") for call in keep]
    log(f"kernel check on the pq path: all {len(keep)} pq_adc_lists calls "
        "bitwise equal to the plain version")
    by_batch = batch_per_key(batches, lambda nq, c: (nq,) + key(c[0]))
    del keep, batches

    timed = {}
    for (nq, *shp), (_, calls, warm) in sorted(by_batch.items()):
        ms, plain_ms, gathered_ms, library_ms = time_pq_batch(calls)
        bound_ms, bound_by = pq_batch_bound(calls)
        live_ms, _ = pq_batch_bound(calls, live_only=True)
        timed[nq, *shp] = (ms, plain_ms, library_ms, bound_ms, bound_by,
                           gathered_ms, len(calls), live_ms)
        pairs = sum(int((c[1] >= 0).sum()) for c in calls)
        log(f"[{card}] pq_adc_lists per batch of {nq}"
            f"{' (the warmup, all zeros)' if warm else ''} at (Q, M*K, Lpad) "
            f"{tuple(shp)}, {len(calls)} launches, {pairs} live pairs: "
            f"kernel {ms:.4f} ms ({bound_ms / ms:.1%} of the bound, "
            f"{live_ms / ms:.1%} of the live-minima bound), bound "
            f"{bound_ms:.5f} ms ({bound_by}), live-minima bound "
            f"{live_ms:.5f} ms, gathered form {gathered_ms:.4f} ms (8-list "
            f"code gathers + launches; the bound is "
            f"{bound_ms / gathered_ms:.1%} of it), library "
            f"{library_ms:.4f} ms, plain {plain_ms:.4f} ms")
    # the line reports the batch size of the shape launched most, its
    # smallest bucket
    shp = shapes.most_common(1)[0][0]
    nq = min(k[0] for k in timed if tuple(k[1:]) == shp)
    ms, plain_ms, library_ms, bound_ms, bound_by, gathered_ms, n, live_ms = \
        timed[(nq,) + shp]

    # the mutation tier on this index, its counters at 0 just before it
    pk.LAUNCHES = 0
    engine_fallbacks("ivf_pq", reset=True)
    mnums, n_kernel = mutable_quantized("pq", index, x, qb, dev, card)
    mnums.update(launches=pk.LAUNCHES, kernel_searches=n_kernel,
                 engine_fallbacks=engine_fallbacks("ivf_pq"))
    log(f"[{card}] pq mutation: " + json.dumps(mnums))
    check(pk.LAUNCHES >= n_kernel and engine_fallbacks("ivf_pq") == 0,
          f"pq mutation: {pk.LAUNCHES} pq_adc_lists launches for "
          f"{n_kernel} kernel-engine searches, fallbacks "
          f"{engine_fallbacks("ivf_pq")}")
    # approx_knn_search on this index, its counter at 0 just before it:
    # the grouped path, #4 held bitwise against its plain version
    from raft_tpu_torch.spatial.ann import approx_knn_search

    pk.LAUNCHES = 0
    engine_fallbacks("ivf_pq", reset=True)
    akeep = []
    # the entry point's defaults: mode "auto" at 4,096 queries takes the
    # grouped path, whose qcap=None sizes qcap from this batch's probes
    kw = dict(n_probes=QZ_PROBES, refine_ratio=PQ_REFINE)
    with kernel_calls(pk, "pq_adc_lists", key, akeep):
        sync(dev)
        t0 = time.perf_counter()
        got = approx_knn_search(index, qb, K, **kw)
        sync(dev)
        approx_ms = 1e3 * (time.perf_counter() - t0)
    approx_launches = pk.LAUNCHES
    want = ivf_pq.ivf_pq_search_grouped(index, qb, K, **kw)
    check(approx_launches > 0 and engine_fallbacks("ivf_pq") == 0
          and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"approx_knn_search on IVF-PQ: {approx_launches} pq_adc_lists "
          f"launches, {engine_fallbacks("ivf_pq")} fallbacks, or not bitwise "
          "ivf_pq_search_grouped")
    errs += [bitwise(pk.pq_adc_lists, pk.pq_adc_lists_plain, call,
                     "pq_adc_lists of approx_knn_search") for call in akeep]
    log(f"[{card}] approx_knn_search on IVF-PQ at {qb.shape[0]} queries: "
        f"{approx_ms:.2f} ms, {approx_launches} pq_adc_lists launches (each "
        "bitwise its plain version), answers bitwise ivf_pq_search_grouped")
    del akeep
    # the sharded IVF-PQ step, its counters at 0 just before it
    t0 = time.perf_counter()
    snums = sharded_pq_step(args, card, dev, data, index)
    log(f"sharded PQ step: {time.perf_counter() - t0:.1f} s")
    return {
        "name": fn_name,
        "route": "cuda",
        "source": "raft_tpu_torch/csrc/pq_scan.cu",
        "replaces": "raft_tpu/spatial/ann/pq_kernel.py:107",
        "entry": "pq_adc_lists",
        "launches": launches + snums["launches"] + approx_launches,
        "launches_by_shape": {"x".join(map(str, k)): n
                              for k, n in shapes.items()},
        "approx": {"ms": approx_ms, "launches": approx_launches},
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_live_ms": live_ms,
        "library_ms": library_ms,
        "gathered_ms": gathered_ms,
        "launches_per_batch": n,
        "batch": nq,
        "shape": [n_lists] + list(shp),
        "card": card,
        "mutation": mnums,
        "sharded": snums,
        "lut": lut,
        "select_k_path": select_k,
        "rerank_path": reranks,
    }


def sharded_pq_step(args, card, dev, data, index):
    """Sharded IVF-PQ (``raft_tpu_torch.comms.mnmg_ivf``) over the
    quantized paths' 500,000 rows: bench.py's ``extra_mnmg_ivf_pq``
    configuration built at P = 8 ranks on the card (every row once), the
    4,096 batch at qcap "throughput" on both engines against the oracle
    and the single-device index, #4 launched on every rank and held
    against its plain version at each rank's shapes (the sentinel list
    read as empty), the batch's host syncs counted; P = 1 by reshard
    (its refine pools a subset: distances no better than P = 8's;
    bitwise at a saturated refine pool); rank 3 down at replication 2
    with a FailoverPlan (coverage 1.0; bitwise at a saturated pool),
    without a replica (``probe_coverage``'s formula, none of its ids), a
    NaN row, ``recover_rank`` from an archive, ~100 requests through the
    ``ServingExecutor``, an upsert / delete round, the host-clock times.
    #4's launches are counted over the step alone. Returns its numbers,
    kept under #4's ``sharded`` key."""
    import tempfile

    from raft_tpu_torch.comms import (
        build_comms, mnmg_ivf_pq_build, mnmg_ivf_pq_search, place_index,
        recover_rank,
    )
    from raft_tpu_torch.obs import MetricRegistry
    from raft_tpu_torch.resilience import (
        FailoverPlan, ReplicaPlacement, ShardHealth,
    )
    from raft_tpu_torch.serving import ServingExecutor
    from raft_tpu_torch.spatial.ann import (
        IVFPQParams, ivf_pq_search_grouped, save_index,
    )
    from raft_tpu_torch.spatial.ann import pq_kernel as pk
    from raft_tpu_torch.spatial.ann.common import coarse_probe

    x, q_np, true = data
    rng = np.random.default_rng(args.seed + 60)
    nums = {"card": card, "ranks": SHARD_P}
    cuda0 = (torch.device("cuda", torch.cuda.current_device())
             if dev.type == "cuda" else dev)
    comms, comms1 = build_comms([cuda0] * SHARD_P), build_comms([cuda0])
    qb = torch.as_tensor(q_np, device=dev)
    tmp = tempfile.TemporaryDirectory()

    # the single device's answers on both engines, before the counters
    # go to 0
    for name, engine in (("kernel", None), ("legacy", False)):
        _, i_s = ivf_pq_search_grouped(index, qb, K, n_probes=QZ_PROBES,
                                       qcap="throughput",
                                       refine_ratio=PQ_REFINE,
                                       use_kernel=engine)
        nums[f"recall_single_{name}"] = recall(i_s, true)

    def key(a):
        return (a[1].shape[1], a[0].shape[1], a[5])

    pk.LAUNCHES = 0
    engine_fallbacks("ivf_pq", reset=True)
    with kernel_calls(pk, "pq_adc_lists", key) as shapes:
        sync(dev)
        t0 = time.perf_counter()
        sidx = mnmg_ivf_pq_build(comms, x, IVFPQParams(
            n_lists=QZ_LISTS, pq_dim=PQ_DIM, pq_bits=PQ_BITS,
            kmeans_n_iters=10, kmeans_init="random", max_list_cap=512))
        sync(dev)
        nums["build_s"] = time.perf_counter() - t0
        szs = sidx.list_sizes.cpu().numpy()
        sids = sidx.sorted_ids.cpu().numpy()
        got = np.concatenate([sids[r, :szs[r].sum()]
                              for r in range(SHARD_P)])
        check(got.shape[0] == QZ_ROWS
              and np.array_equal(np.sort(got), np.arange(QZ_ROWS)),
              "the sharded PQ build does not hold every row exactly once")
        # the served buckets at the default qcap rule, the batch at the
        # throughput rule (the single-device PQ row's)
        qc = {b: sidx.warmup(comms, b, k=K, n_probes=QZ_PROBES,
                             qcap="throughput" if b == SHARD_BATCH else None,
                             refine_ratio=PQ_REFINE)
              for b in SHARD_BUCKETS + (SHARD_BATCH,)}
        for b in SHARD_BUCKETS:
            sidx.warmup(comms, b, k=K, n_probes=QZ_PROBES, qcap=qc[b],
                        refine_ratio=PQ_REFINE, shard_mask=True)
        nums["qcap"] = qc
        log(f"[{card}] sharded PQ build: {QZ_ROWS} x {DIM} over {SHARD_P} "
            f"ranks in {nums['build_s']:.2f} s ({sidx.centroids.shape[0]} "
            f"lists after the cap, nl_pad {sidx.nl_pad}, n_pad "
            f"{sidx.n_pad}); qcap by bucket {qc}")

        def sharded(q, idx=None, c=comms, **kw):
            kw.setdefault("qcap", qc.get(q.shape[0], q.shape[0]))
            kw.setdefault("refine_ratio", PQ_REFINE)
            return mnmg_ivf_pq_search(c, sidx if idx is None else idx, q, K,
                                      n_probes=QZ_PROBES, **kw)

        # the 4,096 batch on the kernel engine: its launches, the ranks
        # that made them, its host syncs
        keep = []
        before = pk.LAUNCHES
        with kernel_calls(pk, "pq_adc_lists", key, keep), \
                host_syncs() as syncs:
            d8, i8 = sharded(qb)
            sync(dev)
        per_batch = pk.LAUNCHES - before
        n_ranks_launched = len({c[2].data_ptr() for c in keep})
        nums.update(launches_per_batch=per_batch,
                    ranks_launched=n_ranks_launched,
                    host_syncs_per_batch=sum(syncs.values()),
                    host_syncs_by_line=dict(syncs))
        _, i8_legacy = sharded(qb, use_kernel=False)
        nums.update(recall_kernel=recall(i8, true),
                    recall_legacy=recall(i8_legacy, true))
        log(f"[{card}] sharded PQ {SHARD_BATCH}-query batch: recall@10 "
            f"kernel {nums['recall_kernel']:.4f}, legacy "
            f"{nums['recall_legacy']:.4f}, single-device index "
            f"{nums['recall_single_kernel']:.4f} / "
            f"{nums['recall_single_legacy']:.4f}; pq_adc_lists launched "
            f"{per_batch} times by {n_ranks_launched} ranks; "
            f"{nums['host_syncs_per_batch']} host syncs in the batch "
            f"({dict(syncs)})")
        check(all(nums[f"recall_{n}"] >= nums[f"recall_single_{n}"] - 0.02
                  for n in ("kernel", "legacy")),
              f"sharded PQ recall below the single device's - 0.02: {nums}")
        check(n_ranks_launched == SHARD_P and per_batch >= SHARD_P,
              f"#4 launched by {n_ranks_launched} of {SHARD_P} ranks")
        # #4 against its plain version at each rank's shapes, and every
        # list without rows (the sentinel) read as empty; these launches
        # are not the path's
        saved = pk.LAUNCHES
        errs, n_empty = [], 0
        for call in keep:
            errs.append(bitwise(pk.pq_adc_lists, pk.pq_adc_lists_plain, call,
                                f"pq_adc_lists on a rank at {key(call)}"))
            out = pk.pq_adc_lists(*call)
            shapes[key(call)] -= 2      # the two comparison launches
            bnd, lut_map = call[4], call[1]
            empty = (bnd[:, 1] <= bnd[:, 0]) & (lut_map >= 0).any(1)
            n_empty += int(empty.sum())
            check(bool((out[empty] >= pk.BIG).all()),
                  "a list without rows did not read as empty")
        pk.LAUNCHES = saved
        nums["max_abs_err"] = max(errs)
        log(f"[{card}] sharded PQ batch's {len(keep)} pq_adc_lists calls "
            f"bitwise equal to the plain version; {n_empty} live lists "
            "without rows (the sentinel, every unowned probe slot) read as "
            "empty")
        check(n_empty >= SHARD_P, f"{n_empty} empty sentinel lists seen")
        del keep

        # P = 1: each probed list scanned by one rank either way, but P = 8
        # refines each rank's own top candidates (a superset of the P = 1
        # pool); at a saturated pool both refine every probed row
        idx1 = place_index(comms1, sidx)
        d1, i1 = sharded(qb, idx=idx1, c=comms1)
        n_better = int((d8 != d1).any(1).sum())
        check(bool((d8 <= d1).all()),
              "P = 8 distances worse than P = 1's (its pools are a superset)")
        q_sat = qb[:256]
        rr_sat = QZ_PROBES * sidx.max_list / K + 1.0
        d8s, i8s = sharded(q_sat, refine_ratio=rr_sat)
        d1s, i1s = sharded(q_sat, idx=idx1, c=comms1, refine_ratio=rr_sat)
        check(torch.equal(d8s, d1s) and ids_tied_only(d8s, i8s, i1s) == 0,
              "P = 8 and P = 1 differ at a saturated refine pool")
        nums["p8_better_than_p1_queries"] = n_better
        log(f"[{card}] sharded PQ P = 8 against P = 1 (reshard): at refine "
            f"{PQ_REFINE} P = 8 no worse anywhere, closer on {n_better} of "
            f"{SHARD_BATCH} queries (its per-rank pools are a superset); at "
            f"a saturated pool (refine {rr_sat:.0f}, 256 queries) distances "
            "bitwise, ids equal up to ties")

        # degraded: rank SHARD_DOWN down without a replica, then with one
        mask = np.ones(SHARD_P, np.int32)
        mask[SHARD_DOWN] = 0
        res = sharded(qb, shard_mask=mask)
        probes, _ = coarse_probe(qb.float(), sidx.centroids, QZ_PROBES)
        want_cov = ((sidx.owner.long()[probes] != SHARD_DOWN).float().sum(1)
                    * (1.0 / QZ_PROBES))
        lost = torch.as_tensor(
            sids[SHARD_DOWN, :szs[SHARD_DOWN].sum()], device=dev)
        check(res.partial and torch.equal(res.coverage, want_cov)
              and not torch.isin(res.ids, lost).any().item(),
              f"PQ rank {SHARD_DOWN} down: coverage or a leaked id")
        sidx2 = place_index(comms, sidx, replication=2)
        health = ShardHealth(SHARD_P, telemetry=False)
        health.mark_down(SHARD_DOWN)
        plan = FailoverPlan.from_health(ReplicaPlacement.of_index(sidx2),
                                        health)
        res2 = sharded(qb, idx=sidx2, shard_mask=health, failover=plan)
        n_worse = int((res2.distances != d8).any(1).sum())
        res2s = sharded(q_sat, idx=sidx2, shard_mask=health, failover=plan,
                        refine_ratio=rr_sat)
        check(plan.fully_covered and bool((res2.coverage == 1.0).all())
              and bool((res2.distances >= d8).all())
              and bool((res2s.coverage == 1.0).all())
              and torch.equal(res2s.distances, d8s)
              and ids_tied_only(d8s, i8s, res2s.ids) == 0,
              "PQ failover at replication 2: not coverage 1.0, or not "
              "bitwise the healthy search at a saturated pool")
        nums["failover_differs_queries"] = n_worse
        qn = qb[:64].clone()
        qn[5, 7] = float("nan")
        res3 = sharded(qn, shard_mask=True)
        check(not bool(res3.row_valid[5]) and bool(res3.row_valid[:5].all())
              and bool(torch.isinf(res3.distances[5]).all())
              and bool((res3.ids[5] == -1).all()),
              "a NaN query row is not masked (PQ)")
        nums["coverage_down"] = float(res.coverage.mean())
        log(f"[{card}] sharded PQ degraded: rank {SHARD_DOWN} down, mean "
            f"coverage {nums['coverage_down']:.4f} (probe_coverage's "
            "formula), none of its ids; replication 2 with a FailoverPlan: "
            f"coverage 1.0; at refine {PQ_REFINE} the failover rank's "
            f"merged pool differs on {n_worse} queries (never closer), at "
            "a saturated pool distances bitwise the healthy search; a NaN "
            "row masked")
        del sidx2, idx1

        # a lost slab recovered from the archive
        path = os.path.join(tmp.name, "sharded_pq.npz")
        t0 = time.perf_counter()
        save_index(sidx, path)
        nums["save_s"] = time.perf_counter() - t0
        wrecked = dataclasses.replace(
            sidx, codes_sorted=sidx.codes_sorted.clone(),
            vectors_sorted=sidx.vectors_sorted.clone(),
            sorted_ids=sidx.sorted_ids.clone())
        wrecked.codes_sorted[SHARD_DOWN] = 0
        wrecked.vectors_sorted[SHARD_DOWN] = 0
        wrecked.sorted_ids[SHARD_DOWN] = 0
        t0 = time.perf_counter()
        healed = recover_rank(comms, wrecked, path, SHARD_DOWN)
        nums["recover_s"] = time.perf_counter() - t0
        dh, ih = sharded(qb, idx=healed)
        check(torch.equal(dh, d8) and torch.equal(ih, i8),
              "the recovered PQ index does not answer bitwise as the "
              "healthy")
        del wrecked, healed
        log(f"[{card}] sharded PQ recovery: archive {nums['save_s']:.2f} s, "
            f"recover_rank {nums['recover_s']:.2f} s, bitwise the healthy")

        # bucketed requests through the ServingExecutor
        reg = MetricRegistry()

        def dispatch(batch, shard_mask=None):
            return mnmg_ivf_pq_search(
                comms, sidx, batch, K, n_probes=QZ_PROBES,
                qcap=qc[batch.shape[0]], refine_ratio=PQ_REFINE,
                shard_mask=shard_mask)

        sizes = np.exp(rng.uniform(0.0, np.log(513.0), SHARD_REQUESTS))
        reqs = [x[rng.integers(0, QZ_ROWS, int(m))]
                for m in np.clip(sizes, 1, 512)]
        with ServingExecutor(dispatch, SHARD_BUCKETS, dim=DIM, device=dev,
                             registry=reg, runtime_inputs={
                                 "shard_mask": np.ones(SHARD_P, np.int32)}
                             ) as ex:
            t0 = time.perf_counter()
            outs = [f.result(timeout=120)
                    for f in [ex.submit(r) for r in reqs]]
            nums["serve_s"] = time.perf_counter() - t0
            cov = reg.gauge("serving_coverage_min", executor=ex.name).value
        for r, o in zip(reqs, outs):
            check(o.distances.shape == (r.shape[0], K)
                  and np.isfinite(o.distances).all()
                  and ((o.ids >= 0) & (o.ids < QZ_ROWS)).all()
                  and (np.diff(o.distances, axis=1) >= 0).all(),
                  "a served sharded PQ answer is malformed")
        check(cov == 1.0, f"serving_coverage_min {cov}")
        nums["served_rows"] = int(sum(r.shape[0] for r in reqs))
        log(f"[{card}] sharded PQ serving: {len(reqs)} requests, "
            f"{nums['served_rows']} rows through the ServingExecutor in "
            f"{nums['serve_s']:.3f} s, serving_coverage_min {cov}")

        # one upsert / delete round on the sharded PQ index, each #4 call
        # held bitwise against the plain version
        def hold_pq(call):
            err = bitwise(pk.pq_adc_lists, pk.pq_adc_lists_plain, call,
                          f"pq_adc_lists in the mutation round at "
                          f"{key(call)}")
            shapes[key(call)] -= 1      # the comparison's launch
            return err

        before = pk.LAUNCHES
        nums["mutation"] = mutable_round(
            comms, sidx, x, qb, qc[SHARD_BATCH], rng, "IVF-PQ", card, dev,
            (pk, "pq_adc_lists", hold_pq), n_probes=QZ_PROBES,
            refine_ratio=PQ_REFINE)
        nums["mutation"]["launches"] = pk.LAUNCHES - before
    nums["launches"] = pk.LAUNCHES
    nums["launches_by_shape"] = {"x".join(map(str, k)): n
                                 for k, n in shapes.items()}
    nums["engine_fallbacks"] = engine_fallbacks("ivf_pq")
    check(engine_fallbacks("ivf_pq") == 0,
          f"{engine_fallbacks("ivf_pq")} sharded PQ searches left the kernel")
    check(nums["mutation"]["launches"] > 0,
          "the sharded PQ mutation round never launched #4")

    # host clock, 5 calls each (not gated)
    def host_ms(fn, n=5):
        fn()
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        sync(dev)
        return 1e3 * (time.perf_counter() - t0) / n

    idx1 = place_index(comms1, sidx)
    nums["p8_ms"] = host_ms(lambda: sharded(qb))
    nums["p1_ms"] = host_ms(lambda: sharded(qb, idx=idx1, c=comms1))
    nums["single_ms"] = host_ms(lambda: ivf_pq_search_grouped(
        index, qb, K, n_probes=QZ_PROBES, qcap="throughput",
        refine_ratio=PQ_REFINE))
    log(f"[{card}] sharded PQ {SHARD_BATCH}-query batch, host clock over 5 "
        f"calls: P = 8 {nums['p8_ms']:.2f} ms, P = 1 {nums['p1_ms']:.2f} "
        f"ms, single-device index {nums['single_ms']:.2f} ms")
    tmp.cleanup()
    log(f"[{card}] sharded PQ step: " + json.dumps(nums))
    return nums


def ann_data(seed, dev):
    """:func:`ann_dataset` and the exact neighbours of its 4,096-query
    batch from the port's brute_force_knn: the data and oracle of the
    quantized and graph paths."""
    from raft_tpu_torch.spatial import brute_force_knn

    x, q, _ = ann_dataset(seed)
    _, true = brute_force_knn(torch.as_tensor(x, device=dev),
                              torch.as_tensor(q, device=dev), K)
    return x, q, true


def quantized_phases(args, card, dev, data):
    """Both quantized paths over the :func:`ann_data` dataset."""
    return [quantized_phase("sq", args, card, dev, data),
            pq_phase(args, card, dev, data)]


# ---------------------------------------------------------------------------
# Graph ANN: kNN-graph build -> beam search (beam_scan_score)
# ---------------------------------------------------------------------------


def beam_tol(q, yn_rows, ids):
    """Per-candidate bound on |kernel - plain| of the beam scan's exact
    distances: 2 d u (qn + yn + 2 |q| |y|), u = 2^-24 (the norms and the
    dot, each an f32 sum of d terms in two orders). ``yn_rows``: the
    table's squared row norms in f64."""
    qn = (q.double() ** 2).sum(1)[:, None]
    yn = yn_rows[ids.long()]
    return 2 * q.shape[1] * 2.0**-24 * (qn + yn + 2 * (qn * yn).sqrt())


def compare_beam_score(call, what, yn_rows=None, integer=False):
    """beam_scan_score on ``call`` = (q, table, ids, bounds, n) against
    its plain version: the minima bitwise, the exact distances +inf
    exactly at ids >= n and within :func:`beam_tol` elsewhere (bitwise
    with ``integer``). Returns max |exact kernel - plain| over live
    candidates."""
    from raft_tpu_torch.spatial.ann import graph_kernel as gk

    q, table, ids, _, n = call
    mins, exact = gk.beam_scan_score(*call)
    want_m, want_e = gk.beam_scan_score_plain(*call)
    torch.cuda.synchronize()
    if not torch.equal(mins, want_m):
        raise AssertionError(
            f"chip_smoke: {what}: {(mins != want_m).sum().item()} minima "
            "differ from the plain version")
    live = ids < n
    check(torch.equal(torch.isinf(exact), ~live),
          f"{what}: exact distances not +inf exactly at ids >= n")
    err = (exact[live] - want_e[live]).abs()
    if integer:
        check(torch.equal(exact, want_e),
              f"{what}: exact distances differ on integer inputs (max "
              f"{err.max().item() if err.numel() else 0.0})")
    if yn_rows is None:
        yn_rows = (table.double() ** 2).sum(1)
    tol = beam_tol(q, yn_rows, ids)[live]
    if not (err.double() <= tol).all():
        raise AssertionError(
            f"chip_smoke: {what}: exact distances off by "
            f"{err.max().item()} > the f32 summation bound")
    return err.max().item() if err.numel() else 0.0


def check_beam_kernel(seed, dev):
    """beam_scan_subchunk_min and both outputs of beam_scan_score against
    their plain versions on integer and Gaussian rows with
    sentinel-padded ids, ragged, empty and full bounds, at the path's
    width, a width off the 16-byte load, and a Cpad over several blocks:
    the minima bitwise, the exact distances bitwise on integer rows and
    within :func:`beam_tol` on Gaussian ones. Returns max |kernel -
    plain|."""
    from raft_tpu_torch.spatial.ann import graph_kernel as gk

    gen = torch.Generator().manual_seed(seed)
    errs = []
    for nq, d, n, c_pad in ((64, DIM, 4096, 512), (7, 19, 300, 136),
                            (3, DIM, 1000, 1024), (2, DIM, 4096, 1024)):
        bounds = _bounds(gen, nq, c_pad, dev)
        for integer in (True, False):
            if integer:
                table = torch.randint(-8, 8, (n + 1, d), generator=gen).float()
                q = torch.randint(-8, 8, (nq, d), generator=gen).float()
            else:
                table = torch.randn((n + 1, d), generator=gen)
                q = torch.randn((nq, d), generator=gen)
            table[n] = 1e15                       # the sentinel row
            ids = torch.randint(0, n + 1, (nq, c_pad), generator=gen,
                                dtype=torch.int32)
            ids[:, -(c_pad // 4):] = n            # sentinel padding
            args = (q.to(dev), table.to(dev), ids.to(dev), bounds)
            what = f"({nq}, {d}, {n}, {c_pad}) integer={integer}"
            errs.append(bitwise(gk.beam_scan_subchunk_min,
                                gk.beam_scan_subchunk_min_plain, args,
                                f"beam_scan_subchunk_min {what}"))
            errs.append(compare_beam_score(args + (n,),
                                           f"beam_scan_score {what}",
                                           integer=integer))
    log("kernel check beam_scan_subchunk_min / beam_scan_score: minima "
        "bitwise, exact distances bitwise on integer rows and within 2 d "
        "2^-24 (qn + yn + 2 |q| |y|) on Gaussian ones (max |diff| "
        f"{max(errs)}), sentinel-padded ids, ragged/empty/full bounds, at "
        "(64, 96, 4096, 512), (7, 19, 300, 136), (3, 96, 1000, 1024) and "
        "(2, 96, 4096, 1024)")
    return max(errs)


def beam_bound(ids, d):
    """Each input read once — the ids, each distinct table row they name
    (f32), the f32 queries, the bounds — and the minima and the exact
    distances written once; at the f32 rate, a dot on rounded and on
    unrounded operands (2 FMAs) per (candidate, feature), and the two
    norms (2 FMAs) per (distinct row or query, feature). Returns
    (bound_ms, bound_by, distinct rows, the no-reuse ms: every named row
    read from device memory, as the TPU kernel's gathered operand was)."""
    nq, c_pad = ids.shape
    distinct = torch.unique(ids).numel()
    rest = (nq * c_pad * 4 + nq * 4 * d + nq * c_pad // 2 + 8 * nq
            + nq * c_pad * 4)
    ms, by = bound(distinct * 4 * d + rest,
                   4.0 * (nq * c_pad + distinct + nq) * d, FP32_FLOP_PER_S)
    no_reuse = nq * c_pad * 4 * d + rest
    return ms, by, distinct, 1e3 * no_reuse / HBM_BYTES_PER_S


def time_beam(q, table, ids, bounds, n):
    """ms of the beam kernel (both outputs, then the minima alone), its
    plain version, and the library yardstick (``table[ids]``, a bf16
    ``bmm``, the norms and the 8-row ``amin``, and an f32 ``bmm`` for the
    exact distances; timed only, never called by the port), over input
    copies."""
    from raft_tpu_torch.core.device import full_f32
    from raft_tpu_torch.spatial.ann import graph_kernel as gk

    nq, c_pad = ids.shape
    sets = [s + (n,) for s in input_copies(q, table, ids, bounds)]
    ms = cuda_time_ms(gk.beam_scan_score, sets)
    mins_ms = cuda_time_ms(lambda *a: gk.beam_scan_subchunk_min(*a[:4]),
                           sets)
    plain_ms = cuda_time_ms(gk.beam_scan_score_plain, sets, iters=10,
                            warm=1)

    @full_f32
    def library(qa, ta, ia, _, nn):
        rows = ta[ia.long()]                               # (NQ, Cpad, d)
        rb, qb = rows.to(torch.bfloat16), qa.to(torch.bfloat16)
        dots = torch.bmm(rb, qb[:, :, None])[:, :, 0].float()
        rf, qf = rb.float(), qb.float()
        d2 = ((qf * qf).sum(-1)[:, None] + (rf * rf).sum(-1)) - 2.0 * dots
        mins = d2.reshape(nq, c_pad // 8, 8).amin(-1)
        ex = ((qa * qa).sum(-1)[:, None] + (rows * rows).sum(-1)
              - 2.0 * torch.bmm(rows, qa[:, :, None])[:, :, 0])
        return mins, torch.where(ia < nn, ex, torch.inf)

    library_ms = cuda_time_ms(library, sets, iters=10, warm=1)
    del sets
    return ms, plain_ms, library_ms, mins_ms


def walk_divergence(index, qb, beam, iters, rows):
    """Replay both engines' walks of the batch round by round (the
    ``on_round`` hook of ``graph._beam_impl``) and, for each query in
    ``rows``, find the first round whose frontier or merged pool differs
    as a set of ids. Returns one report a query: that round, which
    selection differed, the ids only the kernel engine selected and those
    only the exact engine selected, with their f64 distances and
    tolerances (:func:`beam_tol`), and ``near_tie``: every id one engine
    selected instead of another lies within tol(a) + tol(b) of it, so
    f32 sums in another order (each within its tolerance) can flip the
    choice."""
    from raft_tpu_torch.spatial.ann import graph as gmod

    sel = torch.as_tensor(rows, device=qb.device)
    n, table = index.n, index.data_padded
    hb = gmod._auto_hash_bits(iters, beam, index.storage.degree,
                              index.storage.entries.shape[0])
    traces = {}
    for name, engine in (("kernel", True), ("exact", False)):
        trace = traces[name] = []
        gmod._beam_impl(index, qb, k=K, beam=beam, iters=iters,
                        hash_bits=hb, use_kernel=engine,
                        on_round=lambda f, pi, pd, tr=trace: tr.append(
                            (f[sel].cpu(), pi[sel].cpu())))
    reports = []
    for j, r in enumerate(rows):
        q = qb[r].double()

        def dist_tol(ids):
            live = [i for i in sorted(ids) if i < n]
            y = table[torch.as_tensor(live, device=table.device).long()]
            y = y.double()
            qn, yn = (q * q).sum(), (y * y).sum(1)
            tol = 2 * y.shape[1] * 2.0**-24 * (qn + yn + 2 * (qn * yn).sqrt())
            out = {i: (float("inf"), 0.0) for i in ids if i >= n}
            out.update({i: (dv, tv) for i, dv, tv in zip(
                live, ((y - q) ** 2).sum(1).tolist(), tol.tolist())})
            return out

        rep = {"query": r, "round": None, "kind": None, "near_tie": False}
        for t, ((fk, pk), (fe, pe)) in enumerate(zip(traces["kernel"],
                                                     traces["exact"])):
            for kind, a, b in (("frontier", fk, fe), ("pool", pk, pe)):
                a, b = set(a[j].tolist()), set(b[j].tolist())
                if a != b:
                    only_k, only_e = dist_tol(a - b), dist_tol(b - a)
                    rep.update(round=t, kind=kind, kernel_only=only_k,
                               exact_only=only_e, near_tie=all(
                                   abs(dk - de) <= tk + te
                                   for dk, tk in only_k.values()
                                   for de, te in only_e.values()))
                    break
            if rep["kind"] is not None:
                break
        reports.append(rep)
    return reports


def ids_tied_only(d, a, b):
    """Queries whose ids differ beyond equal-distance runs (the interior
    runs must hold the same id set; the run cut by k, distances only)."""
    d, a, b = d.cpu().numpy(), a.cpu().numpy(), b.cpu().numpy()
    bad = 0
    for r in np.flatnonzero((a != b).any(1)):
        start, k = 0, d.shape[1]
        for end in range(1, k + 1):
            if end == k or d[r, end] != d[r, start]:
                if (end < k or start == 0) and (
                        set(a[r, start:end]) != set(b[r, start:end])):
                    bad += 1
                    break
                start = end
    return bad


def p50_ms(fn, dev, repeats=50, warm=3):
    """Median host-clock ms of ``fn()`` then a synchronise."""
    for _ in range(warm):
        fn()
    sync(dev)
    lat = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        sync(dev)
        lat.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(lat))


def reachable(adj, entries):
    """Rows reachable from ``entries`` over an (n, degree) adjacency."""
    n = adj.shape[0]
    seen = np.zeros(n, bool)
    seen[entries] = True
    frontier = np.asarray(entries, np.int64)
    while frontier.size:
        nxt = adj[frontier].ravel()
        nxt = np.unique(nxt[(nxt >= 0) & ~seen[np.maximum(nxt, 0)]])
        seen[nxt] = True
        frontier = nxt
    return int(seen.sum())


def beam_key(a):
    # (queries, padded candidates) of one launch
    return tuple(a[2].shape)


def graph_path(x, qb, true, rng, card, dev, keep):
    """graph_ann_row on the card: build -> the IVF-Flat baseline's recall
    -> recall at each beam on both engines (the kernel engine's distances
    must equal the exact engine's) -> warm each bucket at the smallest
    beam within 0.01 of IVF-Flat's recall -> serve requests -> the nq = 1
    p50 of both engines beside IVF-Flat's at qcap 1. ``keep`` collects
    the kernel's inputs of one 4,096-query search per beam and of one
    nq = 1 search. Returns the summary of the path."""
    from raft_tpu_torch.spatial import brute_force_knn
    from raft_tpu_torch.spatial import fused_knn as fz
    from raft_tpu_torch.spatial.ann import (
        GraphParams, IVFFlatParams, graph_build, graph_search,
        ivf_flat_build, ivf_flat_search_grouped,
    )
    from raft_tpu_torch.spatial.ann import graph as gmod
    from raft_tpu_torch.spatial.ann import graph_kernel as gk

    def fused_counts():
        return dict(fz.LAUNCHES, gather_rescores=fz.RESCORE_GATHER_CALLS)

    fused0 = fused_counts()
    # the patch's inputs, to hold its device form against the plain one
    patch_in = []
    device_patch = gmod._patch_reachability

    def kept_patch(adj, entries, xf, *a, **kw):
        patch_in.append((adj.clone(), np.array(entries)))
        return device_patch(adj, entries, xf, *a, **kw)

    gmod._patch_reachability = kept_patch
    try:
        t0 = time.perf_counter()
        index = graph_build(x, GraphParams(
            degree=GRAPH_DEGREE, intermediate_degree=2 * GRAPH_DEGREE,
            n_entry=GRAPH_ENTRIES, seed=0), metric="sqeuclidean", device=dev)
        sync(dev)
        build_s = time.perf_counter() - t0
    finally:
        gmod._patch_reachability = device_patch
    st = index.build_stats
    (adj0, entries0), = patch_in
    t0 = time.perf_counter()
    want_adj, want_st = gmod._patch_reachability_plain(
        adj0, entries0, index.data_padded[:-1])
    plain_s = time.perf_counter() - t0
    same = (torch.equal(want_adj, index.storage.adjacency[:-1])
            and want_st == {k: st[k] for k in want_st})
    log(f"[{card}] graph patch: the device form ({st['patch_s']:.2f} s) "
        f"against its plain version ({plain_s:.2f} s): adjacency and counts "
        f"{'equal' if same else 'DIFFER'}")
    check(same, "the device patch differs from its plain version")
    del adj0, want_adj, patch_in
    fused = {k: v - fused0[k] for k, v in fused_counts().items()}
    adj = index.storage.adjacency.cpu().numpy()
    n_reach = reachable(adj[:-1], index.storage.entries.cpu().numpy())
    log(f"[{card}] graph build: {QZ_ROWS} x {DIM}, degree {GRAPH_DEGREE} "
        f"(intermediate {2 * GRAPH_DEGREE}) in {build_s:.2f} s: kNN graph "
        f"{st['knn_graph_s']:.2f} s ({st['edges']} edges; fused kNN "
        f"launches and gather rescores {fused}), prune "
        f"{st['prune_s']:.2f} s, patch {st['patch_s']:.2f} s "
        f"({st['patch_edges']} edges written to {st['patched_rows']} rows; "
        f"unreached rows by round {st['patch_misses']}); {n_reach} of "
        f"{QZ_ROWS} rows reachable from the entries")
    # the fused kNN's phase 1 runs chunk_mins; at d = 96 its rescore is
    # the gather route (the rescore kernel takes d % 128 == 0, the JAX rule)
    check(fused["chunk_mins"] > 0,
          "the graph build's kNN graph did not run the chunk_mins kernel")
    check(fused["rescore_scores"] + fused["gather_rescores"]
          == fused["chunk_mins"], f"unexpected kNN routes {fused}")
    check(adj.shape == (QZ_ROWS + 1, GRAPH_DEGREE)
          and ((adj >= -1) & (adj < QZ_ROWS)).all()
          and (adj[-1] == -1).all(), "malformed adjacency")
    check(n_reach == QZ_ROWS, f"{QZ_ROWS - n_reach} rows unreachable")
    del adj

    # the IVF-Flat baseline over the same corpus (graph_ann_row)
    t0 = time.perf_counter()
    ivf = ivf_flat_build(x, IVFFlatParams(
        n_lists=QZ_LISTS, kmeans_n_iters=10, kmeans_init="random",
        max_list_cap=GRAPH_IVF_CAP), metric="sqeuclidean", device=dev)
    qc = ivf.warmup(QZ_QUERIES, k=K, n_probes=QZ_PROBES)
    _, ids = ivf_flat_search_grouped(ivf, qb, K, n_probes=QZ_PROBES, qcap=qc)
    ivf_rec = recall(ids, true)
    log(f"[{card}] IVF-Flat baseline ({QZ_LISTS} lists, {QZ_PROBES} probes) "
        f"built and warmed in {time.perf_counter() - t0:.2f} s; "
        f"{QZ_QUERIES}-query recall@10 {ivf_rec:.4f}")

    sweep = {}
    for beam in GRAPH_BEAMS:
        it = index.warmup(QZ_QUERIES, k=K, beam=beam)
        res = {}
        for name, engine in (("kernel", None), ("exact", False)):
            calls = []
            with kernel_calls(gk, "beam_scan_score", beam_key,
                              calls if name == "kernel" else None), \
                    kernel_calls(gmod, "score_l2_candidates",
                                 lambda a: tuple(a[1].shape)) as rescores:
                sync(dev)
                t0 = time.perf_counter()
                d, i = graph_search(index, qb, K, beam=beam, iters=it,
                                    use_kernel=engine)
                sync(dev)
            res[name] = (d, i, 1e3 * (time.perf_counter() - t0))
            n_rescores = sum(rescores.values())
            if calls:
                keep[("batch", beam)] = calls
                # the rounds take the scan's exact distances: no gathered
                # rows, no score_l2_candidates but the init's and the tail's
                check(n_rescores == 2,
                      f"beam {beam}: the kernel engine's search called "
                      f"score_l2_candidates {n_rescores} times "
                      f"({dict(rescores)}), not the init's and the tail's")
            else:
                check(n_rescores == it + 2,
                      f"beam {beam}: the exact engine's search called "
                      f"score_l2_candidates {n_rescores} times")
        dk, ik, ms_k = res["kernel"]
        de, ie, ms_e = res["exact"]
        # the kernel's exact sums and score_l2_candidates add in other
        # orders, so a walk may take another turn where two candidates tie
        # to within that rounding: such queries (final distances differ)
        # are printed and each must be a near-tie at its first differing
        # round; every other query's distances are equal and its ids equal
        # up to ties
        split = (dk != de).any(1)
        diverged = split.nonzero().flatten().tolist()
        agree = ~split
        reports = (walk_divergence(index, qb, beam, it, diverged)
                   if diverged else [])
        for rep in reports:
            r = rep["query"]
            log(f"beam {beam}, query {r}: walks diverge at round "
                f"{rep['round']} ({rep['kind']}): kernel engine only "
                f"{rep.get('kernel_only')}, exact engine only "
                f"{rep.get('exact_only')} (id: (f64 distance, tolerance)); "
                f"near-tie {rep['near_tie']}; final kernel {dk[r].tolist()} "
                f"ids {ik[r].tolist()}, exact {de[r].tolist()} ids "
                f"{ie[r].tolist()}")
        check(all(rep["near_tie"] for rep in reports),
              f"beam {beam}: a diverged walk is not a near-tie")
        bad = ids_tied_only(de[agree], ie[agree], ik[agree])
        check(bad == 0, f"beam {beam}: {bad} queries' ids differ beyond ties")
        sweep[beam] = dict(recall_kernel=recall(ik, true),
                           recall_exact=recall(ie, true), kernel_ms=ms_k,
                           exact_ms=ms_e, iters=it,
                           diverged_near_ties=len(diverged))
        log(f"[{card}] graph {QZ_QUERIES}-query batch, beam {beam} "
            f"({it} iters): recall@10 kernel "
            f"{sweep[beam]['recall_kernel']:.4f} ({ms_k:.2f} ms, "
            f"{1e3 * QZ_QUERIES / ms_k:.0f} queries/s), exact "
            f"{sweep[beam]['recall_exact']:.4f} ({ms_e:.2f} ms); "
            f"{len(diverged)} walks diverged at a near-tie, on the other "
            f"{int(agree.sum())} queries distances equal and ids equal up "
            "to ties; score_l2_candidates calls a "
            f"search: kernel engine 2 (init and tail), exact engine {it + 2}")
    met = [b for b in GRAPH_BEAMS
           if sweep[b]["recall_kernel"] >= ivf_rec - 0.01]
    beam = met[0] if met else GRAPH_BEAMS[-1]
    log(f"[{card}] smallest beam within 0.01 of IVF-Flat's recall@10 "
        f"{ivf_rec:.4f}: {beam if met else f'none (serving at {beam})'}")

    t0 = time.perf_counter()
    iters = {b: index.warmup(b, k=K, beam=beam) for b in BUCKETS}
    log(f"[{card}] graph warmup at beam {beam}: iters per bucket {iters} "
        f"in {time.perf_counter() - t0:.2f} s")

    def noisy_rows(m):
        return (x[rng.integers(0, QZ_ROWS, m)]
                + 0.3 * rng.standard_normal((m, DIM), dtype=np.float32))

    requests, served, _ = serve_requests(
        lambda q, b: graph_search(index, q, K, beam=beam, iters=iters[b]),
        noisy_rows, rng, QZ_REQUESTS, DIM, QZ_ROWS, card, "graph")
    sample = requests[:20]
    qs = torch.as_tensor(np.concatenate(sample), device=dev)
    _, want = brute_force_knn(torch.as_tensor(x, device=dev), qs, K)
    r_served = recall(torch.cat([served[id(r)][1] for r in sample]), want)
    log(f"[{card}] graph served recall@10 (first 20 requests): "
        f"{r_served:.4f}")
    check(r_served >= 0.8, f"graph served recall@10 {r_served}")

    # the docs/graph_ann.md acceptance figure: nq = 1 p50 of the beam
    # search beside IVF-Flat's at its latency point (qcap 1)
    q1 = qb[:1].contiguous()
    qcap1 = ivf.warmup(1, k=K, n_probes=QZ_PROBES)
    p50 = {
        "ivf_flat": p50_ms(lambda: ivf_flat_search_grouped(
            ivf, q1, K, n_probes=QZ_PROBES, qcap=qcap1), dev),
        "graph_kernel": p50_ms(lambda: graph_search(
            index, q1, K, beam=beam, iters=iters[min(BUCKETS)]), dev),
        "graph_exact": p50_ms(lambda: graph_search(
            index, q1, K, beam=beam, iters=iters[min(BUCKETS)],
            use_kernel=False), dev),
    }
    calls = []
    with kernel_calls(gk, "beam_scan_score", beam_key, calls):
        graph_search(index, q1, K, beam=beam, iters=iters[min(BUCKETS)])
    keep[("one", beam)] = calls
    log(f"[{card}] nq = 1 p50 (host clock, 50 searches): graph beam {beam} "
        f"kernel engine {p50['graph_kernel']:.3f} ms, exact engine "
        f"{p50['graph_exact']:.3f} ms; IVF-Flat qcap {qcap1} "
        f"{p50['ivf_flat']:.3f} ms")
    del ivf
    return dict(index=index, beam=beam, ivf_recall=ivf_rec, sweep=sweep,
                p50=p50, build_s=build_s)


def graph_phase(args, card, dev, data):
    """The graph-ANN path and its beam-scan kernel; returns the kernel's
    entry of the ``kernels`` line."""
    from raft_tpu_torch.spatial.ann import graph as gmod
    from raft_tpu_torch.spatial.ann import graph_kernel as gk

    x, q_np, true = data
    errs = [check_beam_kernel(args.seed, dev)]
    lib = gk._lib()
    rows = gk.rows_per_block(DIM)
    check(lib.raft_beam_scan_rows_per_block(DIM) == rows
          and lib.raft_beam_scan_smem_bytes(DIM)
          == gk._smem_bytes(DIM, rows),
          "the beam wrapper's shared-memory model disagrees with the "
          "kernel's")

    # the main path, with every launch counter at 0 just before it
    rng = np.random.default_rng(args.seed + 4)
    qb = torch.as_tensor(q_np, device=dev)
    keep = {}
    gk.LAUNCHES = 0
    fallbacks0 = gmod.ENGINE_FALLBACKS
    with kernel_calls(gk, "beam_scan_score", beam_key) as shapes:
        out = graph_path(x, qb, true, rng, card, dev, keep)
    launches = gk.LAUNCHES
    fallbacks = gmod.ENGINE_FALLBACKS - fallbacks0
    log(f"graph path: beam_scan_score launched {launches} times, by "
        f"(queries, Cpad): {dict(shapes)}; ENGINE_FALLBACKS {fallbacks}")
    check(launches > 0, "the graph path never launched beam_scan_score")
    check(launches == sum(shapes.values()),
          "beam_scan launches outside beam_scan_score on the graph path")
    check(fallbacks == 0, f"{fallbacks} graph searches left the kernel")

    # the kernel against its plain version on the path's own inputs: every
    # round of one 4,096-query search per beam and of one nq = 1 search
    index = out["index"]
    yn_rows = (index.data_padded.double() ** 2).sum(1)
    n_calls = 0
    for calls in keep.values():
        errs += [compare_beam_score(call, "beam_scan_score on path inputs",
                                    yn_rows)
                 for call in calls]
        n_calls += len(calls)
    del yn_rows
    path_shapes = sorted({beam_key(c[0]) for c in keep.values()})
    log(f"kernel check beam_scan_score: {n_calls} launches on the path's "
        f"own inputs (shapes {path_shapes}): minima bitwise equal to the "
        "plain version, exact distances within 2 d 2^-24 (qn + yn + 2 |q| "
        f"|y|), max |diff| {max(errs)}")
    per_round = [torch.unique(c[2]).numel()
                 for c in keep[("batch", out["beam"])]]
    log(f"graph path: distinct candidate ids per round of the "
        f"{QZ_QUERIES}-query batch at beam {out['beam']}: {per_round}")

    # times at the path's shapes, each at the round whose candidate lists
    # name the most distinct rows (once the walk converges, a round's lists
    # hold mostly the sentinel), and kernel-only at degree 32 (beam 32 x
    # 32 neighbours = 1,024 candidates) on random ids over the same table
    timed = {}
    for calls in keep.values():
        shp = beam_key(calls[0])
        call = max(calls, key=lambda c: torch.unique(c[2]).numel())
        timed[shp] = time_beam(*call) + beam_bound(call[2], DIM)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    ids32 = torch.randint(0, index.n + 1, (QZ_QUERIES, 1024), generator=gen,
                          device=dev, dtype=torch.int32)
    full = torch.tensor([[0, 1024]], dtype=torch.int32,
                        device=dev).expand(QZ_QUERIES, 2).contiguous()
    deg32 = (qb, index.data_padded, ids32, full, index.n)
    errs.append(compare_beam_score(deg32, "beam_scan_score at degree 32"))
    timed["degree32"] = time_beam(*deg32) + beam_bound(ids32, DIM)
    del deg32, ids32
    # the sift1m-graph cell's launch: 10,000 queries x 2,048 candidates
    # (beam 32 x degree 64) of width 128 over 1M rows, random ids
    tbl = torch.randn((SIFT_ROWS + 1, SIFT_DIM), generator=gen, device=dev)
    tbl[SIFT_ROWS] = 1e15
    q128 = torch.randn((SIFT_QUERIES, SIFT_DIM), generator=gen, device=dev)
    ids64 = torch.randint(0, SIFT_ROWS, (SIFT_QUERIES, 2048), generator=gen,
                          device=dev, dtype=torch.int32)
    full = torch.tensor([[0, 2048]], dtype=torch.int32,
                        device=dev).expand(SIFT_QUERIES, 2).contiguous()
    deg64 = (q128, tbl, ids64, full, SIFT_ROWS)
    errs.append(compare_beam_score(deg64, "beam_scan_score at degree 64"))
    timed["degree64_d128"] = time_beam(*deg64) + beam_bound(ids64, SIFT_DIM)
    del deg64, ids64, tbl, q128
    for shp, (ms, plain_ms, library_ms, mins_ms, bound_ms, bound_by,
              distinct, no_reuse_ms) in timed.items():
        log(f"[{card}] beam_scan_score {shp} (queries, Cpad), "
            f"{shapes.get(shp, 0)} launches: kernel {ms:.4f} ms (minima "
            f"alone {mins_ms:.4f} ms), plain {plain_ms:.4f} ms, library "
            f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}; "
            f"{distinct} distinct rows), {bound_ms / ms:.1%} of the bound; "
            f"no-reuse bytes {no_reuse_ms:.5f} ms")
    shp = beam_key(keep[("batch", out["beam"])][0])
    ms, plain_ms, library_ms, _, bound_ms, bound_by = timed[shp][:6]
    return {
        "name": "beam_scan_subchunk_min",
        "route": "cuda",
        "source": "raft_tpu_torch/csrc/beam_scan.cu",
        "replaces": "raft_tpu/spatial/ann/graph_kernel.py:88",
        "launches": launches,
        "launches_by_shape": {"x".join(map(str, k)): n
                              for k, n in shapes.items()},
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "shape": [shp[0], shp[1], DIM],
        "timed": {("x".join(map(str, k)) if isinstance(k, tuple) else k):
                  dict(zip(("ms", "plain_ms", "library_ms", "minima_ms",
                            "bound_ms", "bound_by", "distinct_rows",
                            "no_reuse_ms"), v))
                  for k, v in timed.items()},
        "graph": {"beam": out["beam"], "ivf_recall": out["ivf_recall"],
                  "p50_ms": out["p50"], "build_s": out["build_s"],
                  "sweep": {str(b): v for b, v in out["sweep"].items()}},
        "card": card,
    }


# ---------------------------------------------------------------------------
# Brute-force kNN: fused chunk-min + chunk-rescore kernels
# ---------------------------------------------------------------------------


def _tol(q, yn_max, d):
    """Per-query bound on |kernel - plain| for f32 sums of d terms in two
    orders: 2 d u (max ||y||^2 + 2 ||q|| max ||y||), u = 2^-24 (the
    recursive-summation error bound, twice)."""
    qn = q.float().norm(dim=1, keepdim=True)
    return 2 * d * 2.0**-24 * (yn_max + 2 * qn * math.sqrt(yn_max))


def chunk_mins_routes():
    """``knn_chunk_mins_calls_total`` by route: the phase-1 kernels the
    process has launched (``plain`` for CPU calls)."""
    from raft_tpu_torch.obs import default_registry

    return {c.labels["route"]: c.value for c in
            default_registry().series("knn_chunk_mins_calls_total")}


def compare_chunk_mins(q, y, yn, npad, cd):
    """chunk_mins kernel vs plain version within :func:`_tol` (f32 sums
    in another order), on whichever route the shape takes
    (``fused_knn.chunk_mins_route``); returns max |kernel - plain|."""
    from raft_tpu_torch.spatial import fused_knn as fz

    got = fz.chunk_mins(q, y, yn, npad, cd)
    want = fz.chunk_mins_plain(q, y, yn, npad, cd)
    err = (got - want).abs()
    tol = _tol(q, yn.max().item(), q.shape[1])
    if not (err <= tol).all():
        raise AssertionError(
            f"chunk_mins {tuple(q.shape)} x {tuple(y.shape)} {y.dtype} "
            f"{cd}: off by {err.max().item()} > the f32 summation bound")
    return err.max().item()


def compare_rescore(q, cids, y):
    """rescore_scores kernel vs plain version within :func:`_tol`;
    returns max |kernel - plain|."""
    from raft_tpu_torch.spatial import fused_knn as fz

    got = fz.rescore_scores(q, cids, y)
    want = fz.rescore_scores_plain(q, cids, y)
    err = (got - want).abs()
    yn_max = max((y[s:s + (1 << 20)].float() ** 2).sum(1).max().item()
                 for s in range(0, y.shape[0], 1 << 20))
    if not (err <= _tol(q, yn_max, q.shape[1])).all():
        raise AssertionError(
            f"rescore_scores {tuple(q.shape)} x {tuple(cids.shape)} "
            f"{y.dtype}: off by {err.max().item()} > the f32 summation "
            "bound")
    return err.max().item()


def check_fused_kernels(seed):
    """chunk_mins and rescore_scores against their plain versions at a
    ragged and an aligned shape: bitwise on integer-exact inputs (f32 and
    bf16 storage, f32 and bf16 compute, chunk ids past the index), within
    the f32 summation bound on Gaussian ones. Returns the max Gaussian
    |kernel - plain| of each."""
    from raft_tpu_torch.spatial import fused_knn as fz

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    errs = {"chunk_mins": 0.0, "rescore_scores": 0.0}
    for m, n, d in ((37, 8192 + 37, 19), (200, 16384, 128)):
        npad = -(-n // 2048) * 2048
        q = torch.randint(-8, 8, (m, d), generator=gen).float().to(dev)
        y = torch.randint(-8, 8, (n, d), generator=gen).float().to(dev)
        cids = torch.randint(0, npad // 128, (m, 24),
                             generator=gen).int().to(dev)
        for yt in (y, y.to(torch.bfloat16)):
            yn = (yt.float() ** 2).sum(1)
            for cd in (torch.float32, torch.bfloat16):
                got = fz.chunk_mins(q, yt, yn, npad, cd)
                want = fz.chunk_mins_plain(q, yt, yn, npad, cd)
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"chunk_mins ({m}, {n}, {d}) {yt.dtype} {cd}: "
                      f"{(got != want).sum().item()} entries differ on "
                      "integer-exact inputs")
            got = fz.rescore_scores(q, cids, yt)
            want = fz.rescore_scores_plain(q, cids, yt)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"rescore_scores ({m}, {n}, {d}) {yt.dtype}: "
                  f"{(got != want).sum().item()} entries differ on "
                  "integer-exact inputs")
        qg = torch.randn((m, d), generator=gen).to(dev)
        yg = torch.randn((n, d), generator=gen).to(dev)
        for yt in (yg, yg.to(torch.bfloat16)):
            yn = (yt.float() ** 2).sum(1)
            for cd in (torch.float32, torch.bfloat16):
                errs["chunk_mins"] = max(errs["chunk_mins"],
                                         compare_chunk_mins(qg, yt, yn, npad,
                                                            cd))
            errs["rescore_scores"] = max(errs["rescore_scores"],
                                         compare_rescore(qg, cids, yt))
        log(f"fused kernel check ({m}, {n}, {d}): bitwise on integer-exact "
            "inputs (f32/bf16 storage, f32/bf16 compute); Gaussian inputs "
            "within 2 d 2^-24 (max|y|^2 + 2 |q| max|y|) per query (f32 "
            f"sums in another order), max |kernel - plain| {errs}")
    return errs


@contextlib.contextmanager
def fused_calls(keep, calls=None):
    """Count the calls of the chunk_mins and rescore_scores wrappers by
    shape and keep the last call's inputs of each shape in ``keep`` (a
    served batch, not a warmup's zero queries); ``keep["rescore_scores"]``
    also holds the last rescore call of each shape and index partition.
    ``calls``, a list, also receives every call as (name, inputs). The
    wrappers still run (and count their launches) as before."""
    from raft_tpu_torch.spatial import fused_knn as fz

    wrappers = (fz.chunk_mins, fz.rescore_scores)
    shapes = {"chunk_mins": collections.Counter(),
              "rescore_scores": collections.Counter()}

    def chunk_mins(q, y, yn, npad, cd=torch.float32):
        key = (q.shape[0], y.shape[0], q.shape[1], str(y.dtype)[6:],
               str(cd)[6:])
        shapes["chunk_mins"][key] += 1
        keep["chunk_mins", key] = (q, y, yn, npad, cd)
        if calls is not None:
            calls.append(("chunk_mins", (q, y, yn, npad, cd)))
        return wrappers[0](q, y, yn, npad, cd)

    def rescore_scores(q, cids, y):
        key = (q.shape[0], cids.shape[1], y.shape[0], q.shape[1],
               str(y.dtype)[6:])
        shapes["rescore_scores"][key] += 1
        keep["rescore_scores", key] = (q, cids, y)
        keep.setdefault("rescore_scores", {})[key + (y.data_ptr(),)] = (
            q, cids, y)
        if calls is not None:
            calls.append(("rescore_scores", (q, cids, y)))
        return wrappers[1](q, cids, y)

    fz.chunk_mins, fz.rescore_scores = chunk_mins, rescore_scores
    try:
        yield shapes
    finally:
        fz.chunk_mins, fz.rescore_scores = wrappers


def true_dists(parts, q, ids):
    """f64 L2 distances of the returned ids (global over ``parts``)."""
    rows = []
    flat = ids.reshape(-1).long()
    off = 0
    out = torch.empty(flat.shape[0], dtype=torch.float64, device=q.device)
    for part in (parts if isinstance(parts, (list, tuple)) else [parts]):
        sel = (flat >= off) & (flat < off + part.shape[0])
        rows = part[flat[sel] - off].double()
        qq = q.double().repeat_interleave(ids.shape[1], 0)[sel]
        out[sel] = ((rows - qq) ** 2).sum(1).sqrt()
        off += part.shape[0]
    return out.reshape(ids.shape)


def check_dists(got, parts, q, ids, what):
    want = true_dists(parts, q, ids)
    rel = ((got.double() - want).abs() / want.clamp_min(1e-6)).max().item()
    check(rel <= 1e-4, f"{what}: distances off by {rel:.3g} relative")
    return rel


def sift_path(seed, card, dev, parts_kept):
    """The brute-force path at SIFT-1M's shape: served requests, one
    10,000-query batch (f32 and bf16 phase 1), the scan path on 1,000 of
    those queries. Returns the index and the big batch's queries."""
    from raft_tpu_torch.distance import row_norm_sq
    from raft_tpu_torch.spatial import brute_force_knn
    from raft_tpu_torch.spatial import fused_knn as fz

    rng = np.random.default_rng(seed)
    x = torch.as_tensor(clustered_rows(rng, SIFT_ROWS, SIFT_DIM), device=dev)
    norms = row_norm_sq(x)                  # once, kept with the index
    sync(dev)

    def noisy_rows(m):
        rows = x[torch.as_tensor(rng.integers(0, SIFT_ROWS, m), device=dev)]
        return (rows.cpu().numpy()
                + 0.3 * rng.standard_normal((m, SIFT_DIM), dtype=np.float32))

    # a deployment checks once that the card runs its largest phase-1 grid
    _, bn = fz._plan_blocks(SIFT_QUERIES, SIFT_ROWS, SIFT_DIM)
    grid = fz._grid_steps(SIFT_QUERIES, -(-SIFT_ROWS // bn) * bn)
    check(fz.probe_grid_steps(grid), f"the card refused a {grid}-block grid")

    t0 = time.perf_counter()
    for b in BUCKETS:
        brute_force_knn(x, np.zeros((b, SIFT_DIM), np.float32), K,
                        index_norms=norms)
    sync(dev)
    log(f"[{card}] brute-force warmup of {len(BUCKETS)} buckets: "
        f"{time.perf_counter() - t0:.2f} s")

    requests, served, p50 = serve_requests(
        lambda q, b: brute_force_knn(x, q, K, index_norms=norms),
        noisy_rows, rng, BF_REQUESTS, SIFT_DIM, SIFT_ROWS, card,
        "brute-force")
    qs = torch.as_tensor(np.concatenate(requests), device=dev)
    true = exact_knn(x, qs, K).cpu()
    got = torch.cat([served[id(r)][1] for r in requests])
    got_d = torch.cat([served[id(r)][0] for r in requests])
    check_dists(got_d.to(dev), x, qs, got.to(dev), "served")
    which = np.concatenate([[served[id(r)][2]] * r.shape[0]
                            for r in requests])
    for b, ms in p50.items():
        sel = torch.as_tensor(which == b)
        log(f"[{card}] bucket {b}: p50 {ms:.3f} ms, recall@10 "
            f"{recall(got[sel], true[sel]):.4f}")
    r_served = recall(got, true)
    log(f"[{card}] served recall@10 (all {len(which)} rows): "
        f"{r_served:.4f}")
    check(r_served >= 0.999, f"served recall@10 {r_served}")

    qb = torch.as_tensor(noisy_rows(SIFT_QUERIES), device=dev)
    true = exact_knn(x, qb, K)
    results = {}
    for name, kw in (("f32", {}),
                     ("bf16", {"compute_dtype": torch.bfloat16,
                               "extra_chunks": 32})):
        sync(dev)
        t0 = time.perf_counter()
        d, ids = brute_force_knn(x, qb, K, index_norms=norms, **kw)
        sync(dev)
        ms = 1e3 * (time.perf_counter() - t0)
        results[name] = (recall(ids, true), ms,
                         check_dists(d, x, qb, ids, f"{name} batch"))
    sync(dev)
    t0 = time.perf_counter()
    d, ids = brute_force_knn(x, qb[:1000], K, use_fused=False)
    sync(dev)
    results["scan"] = (recall(ids, true[:1000]),
                       1e3 * (time.perf_counter() - t0),
                       check_dists(d, x, qb[:1000], ids, "scan"))
    for name, (r, ms, rel) in results.items():
        nq = 1000 if name == "scan" else SIFT_QUERIES
        log(f"[{card}] SIFT-shape {nq}-query batch, {name}: recall@10 "
            f"{r:.4f}, {ms:.2f} ms, {1e3 * nq / ms:.0f} queries/s, "
            f"distances within {rel:.3g} relative of f64")
    check(results["f32"][0] >= 0.999, f"f32 recall@10 {results['f32'][0]}")
    check(results["scan"][0] >= 0.999, f"scan recall@10 {results['scan'][0]}")
    check(results["bf16"][0] >= 0.99, f"bf16 recall@10 {results['bf16'][0]}")
    parts_kept["sift"] = (x, norms, qb)


def wide_path(seed, card, dev, parts_kept):
    """Full width of the 10M x 768 regime at reduced depth: 2M bf16 rows
    in two partitions, 1,024 queries, bf16 phase 1."""
    from raft_tpu_torch.spatial import brute_force_knn

    g = torch.Generator(device=dev).manual_seed(seed)
    centers = torch.randn((2000, WIDE_DIM), generator=g, device=dev) * 2.0
    parts, norms = [], []
    for _ in range(2):
        lab = torch.randint(0, 2000, (WIDE_ROWS // 2,), generator=g,
                            device=dev)
        p = (centers[lab] + torch.randn((WIDE_ROWS // 2, WIDE_DIM),
                                        generator=g, device=dev))
        parts.append(p.to(torch.bfloat16))
        norms.append((parts[-1].float() ** 2).sum(1))
        del p, lab
    pick = torch.randint(0, WIDE_ROWS, (WIDE_QUERIES,), generator=g,
                         device=dev)
    base = torch.where((pick < WIDE_ROWS // 2)[:, None],
                       parts[0][pick.clamp(max=WIDE_ROWS // 2 - 1)],
                       parts[1][(pick - WIDE_ROWS // 2).clamp(min=0)])
    q = base.float() + 0.3 * torch.randn((WIDE_QUERIES, WIDE_DIM),
                                         generator=g, device=dev)
    true = exact_knn(parts, q, K)
    sync(dev)
    t0 = time.perf_counter()
    d, ids = brute_force_knn(parts, q, K, use_fused=True,
                             compute_dtype=torch.bfloat16, extra_chunks=32,
                             index_norms=norms)
    sync(dev)
    ms = 1e3 * (time.perf_counter() - t0)
    r = recall(ids, true)
    rel = check_dists(d, parts, q, ids, "wide batch")
    log(f"[{card}] {WIDE_ROWS} x {WIDE_DIM} bf16 in 2 partitions (depth cut "
        "from the 9.2M x 768 regime of BASELINE.md for the smoke's time "
        f"limit), {WIDE_QUERIES} queries: recall@10 {r:.4f}, {ms:.2f} ms, "
        f"{1e3 * WIDE_QUERIES / ms:.0f} queries/s, distances within "
        f"{rel:.3g} relative of f64")
    check(r >= 0.99, f"wide recall@10 {r}")
    parts_kept["wide"] = (parts, norms, q)


def time_chunk_mins(q, y, yn, npad, cd, library):
    """ms of the chunk_mins kernel, its plain version and (with
    ``library``) the addmm + amin yardstick, over input copies."""
    from raft_tpu_torch.core.device import full_f32
    from raft_tpu_torch.spatial import fused_knn as fz

    sets = [(a, b, c, npad, cd) for a, b, c in input_copies(q, y, yn)]
    ms = cuda_time_ms(fz.chunk_mins, sets)
    plain_ms = cuda_time_ms(fz.chunk_mins_plain, sets, iters=10, warm=1)
    lib_ms = None
    if library:
        m = q.shape[0]

        n = y.shape[0]

        @full_f32
        def lib(qa, ya, yna, *_):
            # the (m, n) score matrix, then the min of each 128-column
            # chunk through a strided view (the ragged last chunk apart)
            t = torch.addmm(yna, qa, ya.float().T, alpha=-2.0)
            full = n // 128
            mins = t.as_strided((m, full, 128), (n, 128, 1)).amin(2)
            if n % 128:
                mins = torch.cat([mins, t[:, full * 128:].amin(
                    1, keepdim=True)], 1)
            return mins

        # at 10,000 queries x 1M rows the score matrix is 40 GB of f32
        try:
            lib_ms = cuda_time_ms(lib, sets, iters=10 if m < 4096 else 3,
                                  warm=1)
        except torch.cuda.OutOfMemoryError as e:
            log(f"chunk_mins library yardstick at ({m}, {n}): out of device "
                f"memory ({str(e).splitlines()[0]})")
        torch.cuda.empty_cache()
    del sets
    return ms, plain_ms, lib_ms


def time_chunk_mins_bf16_library(q, y, yn):
    """ms of the bf16 library yardstick of chunk_mins: one cuBLAS bf16
    product with f32 output (``torch.mm(..., out_dtype=torch.float32)``
    where this torch has it, else bf16 ``addmm`` with its output upcast),
    then ``ynorm - 2 g`` in place and the min of each 128-column chunk;
    the operands are rounded to bf16 outside the timed call. Returns
    (ms or None when the score matrix does not fit, the call's name)."""
    m, n = q.shape[0], y.shape[0]
    full = n // 128
    sets = [(a.to(torch.bfloat16), b.to(torch.bfloat16), c)
            for a, b, c in input_copies(q, y, yn)[:2]]
    try:
        torch.mm(sets[0][0][:1], sets[0][1][:1].T, out_dtype=torch.float32)
        name = "torch.mm(out_dtype=float32)"
    except (TypeError, RuntimeError):
        name = "addmm(bf16).float()"

    def lib(qb, yb, ynb):
        if name.startswith("torch.mm"):
            t = torch.mm(qb, yb.T, out_dtype=torch.float32).mul_(-2.0)
            t.add_(ynb)
        else:
            t = torch.addmm(ynb.to(torch.bfloat16), qb, yb.T,
                            alpha=-2.0).float()
        mins = t.as_strided((m, full, 128), (n, 128, 1)).amin(2)
        if n % 128:
            mins = torch.cat([mins, t[:, full * 128:].amin(1, keepdim=True)],
                             1)
        return mins

    try:
        ms = cuda_time_ms(lib, sets, iters=3, warm=1)
    except torch.cuda.OutOfMemoryError as e:
        log(f"chunk_mins bf16 library yardstick at ({m}, {n}): out of device "
            f"memory ({str(e).splitlines()[0]})")
        ms = None
    del sets
    torch.cuda.empty_cache()
    return ms, name


def chunk_mins_bound(m, n, d, npad, itemsize, cd):
    nbytes = m * d * 4 + n * d * itemsize + n * 4 + m * (npad // 128) * 4
    rate = BF16_FLOP_PER_S if cd == "bfloat16" else FP32_FLOP_PER_S
    return bound(nbytes, 2.0 * m * n * d, rate)


def rescore_bound(q, cids, y):
    """Each distinct chunk the ids touch read once, q and the ids read
    once, the scores written once; at the f32 rate, the dot (one FMA) per
    (pair, row, feature) and the row norm (one FMA) per (distinct row,
    feature). Also returns the no-reuse byte count."""
    m, d = q.shape
    c = cids.shape[1]
    row_bytes = 128 * d * y.element_size()
    distinct = torch.unique(cids).numel()
    extra = m * d * 4 + m * c * 4 + m * c * 128 * 4
    ms, by = bound(distinct * row_bytes + extra,
                   2.0 * (m * c + distinct) * 128 * d, FP32_FLOP_PER_S)
    return ms, by, distinct, m * c * row_bytes + extra


def brute_force_phase(args, card, dev):
    """The brute-force kNN path and its three kernels; returns their
    entries of the ``kernels`` line."""
    from raft_tpu_torch.obs import metrics as obs_metrics
    from raft_tpu_torch.spatial import fused_knn as fz
    from raft_tpu_torch.spatial import knn as bfk

    lib = fz._lib()
    check(lib.raft_fused_max_grid_x() == fz._MAX_GRID_STEPS_DEFAULT,
          "the card's 1-D grid limit differs from the port's")
    group = lib.raft_fused_rescore_group()
    gerrs = check_fused_kernels(args.seed)
    _, bn = fz._plan_blocks(SIFT_QUERIES, SIFT_ROWS, SIFT_DIM)
    npad = -(-SIFT_ROWS // bn) * bn
    sift_grid = fz._grid_steps(SIFT_QUERIES, npad)
    check(fz.probe_grid_steps(sift_grid),
          f"probe_grid_steps({sift_grid}) refused the SIFT phase-1 grid")
    check(not fz.probe_grid_steps(2**31),
          "probe_grid_steps(2**31) ran past the 1-D grid limit")
    log(f"probe_grid_steps: True at the SIFT phase-1 grid ({sift_grid} "
        "blocks), False at 2**31 blocks")

    # the main path, with every launch counter at 0 just before it
    for key in fz.LAUNCHES:
        fz.LAUNCHES[key] = 0
    bfk.SCAN_FALLBACKS = 0
    fz.RESCORE_GATHER_CALLS = 0
    keep, kept = {}, {}
    routes0 = chunk_mins_routes()
    with fused_calls(keep) as shapes, select_k_path() as selected:
        sift_path(args.seed, card, dev, kept)
        wide_path(args.seed, card, dev, kept)
    launches = dict(fz.LAUNCHES)
    routes = {r: v - routes0.get(r, 0)
              for r, v in chunk_mins_routes().items()}
    log(f"brute-force path: phase-1 launches by route {routes} (wgmma: "
        f"d <= {fz.WGMMA_MAX_D} with bf16 compute; mma: wider; f32: f32 "
        "compute)")
    if obs_metrics.enabled():
        check(sum(routes.values()) == launches["chunk_mins"],
              f"phase-1 routes {routes} do not add up to "
              f"{launches['chunk_mins']} launches")
        check(routes.get("wgmma", 0) > 0 and routes.get("mma", 0) > 0,
              f"the brute-force path missed a bf16 phase-1 route: {routes}")
    select_k = select_k_path_entry(selected, "brute-force path", card)
    del selected
    log(f"brute-force path: launches {launches}, by shape "
        f"{ {k: dict(v) for k, v in shapes.items()} }")
    for name, n in launches.items():
        check(n > 0, f"the brute-force path never launched {name}")
    check(bfk.SCAN_FALLBACKS == 0,
          f"{bfk.SCAN_FALLBACKS} CUDA partitions left the fused kernels")
    check(fz.RESCORE_GATHER_CALLS == 0,
          f"{fz.RESCORE_GATHER_CALLS} fused calls took the gather rescore")

    # the kernels against their plain versions on the path's own inputs:
    # f32 compute on the first 256 queries; the SIFT wgmma route on every
    # query, so each block's query ring wraps as on the main path; all
    # chunks
    x, norms, qb = kept["sift"]
    errs = dict(gerrs)
    errs["chunk_mins"] = max(errs["chunk_mins"], compare_chunk_mins(
        qb[:256].contiguous(), x, norms, npad, torch.float32))
    errs["chunk_mins"] = max(errs["chunk_mins"], compare_chunk_mins(
        qb.contiguous(), x, norms, npad, torch.bfloat16))
    parts, wnorms, wq = kept["wide"]
    _, wbn = fz._plan_blocks(WIDE_QUERIES, WIDE_ROWS // 2, WIDE_DIM)
    wpad = -(-(WIDE_ROWS // 2) // wbn) * wbn
    errs["chunk_mins"] = max(errs["chunk_mins"], compare_chunk_mins(
        wq[:256].contiguous(), parts[0], wnorms[0], wpad, torch.bfloat16))
    held = {d: fz.chunk_mins_route(d, torch.bfloat16)
            for d in (SIFT_DIM, WIDE_DIM)}
    log(f"chunk_mins held against plain on both bf16 routes: {held} (by d)")
    # every kept rescore call in full (each shape's last, each wide
    # partition's): a launch's pair groups depend on all of its queries
    for key, (q, cids, y) in keep["rescore_scores"].items():
        err = compare_rescore(q, cids, y)
        errs["rescore_scores"] = max(errs["rescore_scores"], err)
        log(f"rescore_scores {key[:-1]} (index at {key[-1]:#x}) in full vs "
            f"plain: max |kernel - plain| {err}")
    log(f"kernels vs plain on the path's inputs (chunk_mins: all "
        f"{qb.shape[0]} SIFT queries on wgmma, the first 256 on the f32 and "
        "768-wide routes, all chunks; rescore_scores: every kept call in "
        "full): "
        f"max |kernel - plain| {errs}")

    out = []
    # chunk_mins: the shape launched most, then the 10,000-query batch
    (cm_key, _), = shapes["chunk_mins"].most_common(1)
    timed = {}
    for key in dict.fromkeys([cm_key, (SIFT_QUERIES, SIFT_ROWS, SIFT_DIM,
                                       "float32", "float32")]):
        q, y, yn, npad_k, cd = keep[("chunk_mins", key)]
        ms, plain_ms, lib_ms = time_chunk_mins(q, y, yn, npad_k, cd,
                                               library=True)
        bound_ms, bound_by = chunk_mins_bound(*key[:3], npad_k,
                                              y.element_size(), key[4])
        timed[key] = (ms, plain_ms, lib_ms, bound_ms, bound_by)
        log(f"[{card}] chunk_mins {key}, {shapes['chunk_mins'][key]} "
            f"launches: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib_ms if lib_ms is None else f'{lib_ms:.4f}'} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), "
            f"{bound_ms / ms:.1%} of the bound")
    ms, plain_ms, lib_ms, bound_ms, bound_by = timed[cm_key]
    # bf16 compute (the tensor-core kernel) at both bf16 batches
    bf16 = {}
    for label, key in (("sift_10k", (SIFT_QUERIES, SIFT_ROWS, SIFT_DIM,
                                     "float32", "bfloat16")),
                       ("wide", (WIDE_QUERIES, WIDE_ROWS // 2, WIDE_DIM,
                                 "bfloat16", "bfloat16"))):
        q, y, yn, npad_k, cd = keep[("chunk_mins", key)]
        kms, kplain, _ = time_chunk_mins(q, y, yn, npad_k, cd, library=False)
        klib, lib_name = time_chunk_mins_bf16_library(q, y, yn)
        kb, kby = chunk_mins_bound(*key[:3], npad_k, y.element_size(), key[4])
        bf16[label] = {"shape": list(key),
                       "route": fz.chunk_mins_route(key[2], key[4]),
                       "launches": shapes["chunk_mins"][key], "ms": kms,
                       "plain_ms": kplain, "library_ms": klib,
                       "library_call": lib_name, "bound_ms": kb,
                       "bound_by": kby}
        log(f"[{card}] chunk_mins bf16 compute {key}, "
            f"{shapes['chunk_mins'][key]} launches: kernel {kms:.4f} ms "
            f"({kb / kms:.1%} of the bound), plain {kplain:.4f} ms, library "
            f"({lib_name}) {klib if klib is None else f'{klib:.4f}'} ms, "
            f"bound {kb:.4f} ms ({kby})")
    out.append({
        "name": "chunk_mins", "route": "cuda",
        "source": "raft_tpu_torch/csrc/fused_knn.cu",
        "replaces": "raft_tpu/spatial/fused_knn.py:85",
        "launches": launches["chunk_mins"],
        "launches_by_shape": {"x".join(map(str, k)): v for k, v in
                              shapes["chunk_mins"].items()},
        "max_abs_err": errs["chunk_mins"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        "shape": list(cm_key), "card": card,
        "sift_10k": dict(zip(("ms", "plain_ms", "library_ms", "bound_ms",
                              "bound_by"), timed[
            (SIFT_QUERIES, SIFT_ROWS, SIFT_DIM, "float32", "float32")])),
        "bf16": bf16,
    })

    # rescore_scores: the shape launched most, then the three batches' own
    # (f32 and bf16 phase 1 at the SIFT shape, the wide partitions)
    (rs_key, _), = shapes["rescore_scores"].most_common(1)
    timed = {}
    for key in dict.fromkeys([
            rs_key, (SIFT_QUERIES, 24, SIFT_ROWS, SIFT_DIM, "float32"),
            (SIFT_QUERIES, 48, SIFT_ROWS, SIFT_DIM, "float32"),
            (WIDE_QUERIES, 48, WIDE_ROWS // 2, WIDE_DIM, "bfloat16")]):
        q, cids, y = keep[("rescore_scores", key)]
        sets = input_copies(q, cids, y)
        ms = cuda_time_ms(fz.rescore_scores, sets)
        plain_ms = cuda_time_ms(fz.rescore_scores_plain, sets, iters=10,
                                warm=1)
        del sets
        bound_ms, bound_by, distinct, no_reuse = rescore_bound(q, cids, y)
        # the launch's blocks: each chunk's pairs in groups of at most
        # `group` (ids outside the index share one bucket)
        n_chunks = -(-y.shape[0] // 128)
        bucket = cids.reshape(-1).long()
        bucket = torch.where((bucket >= 0) & (bucket < n_chunks), bucket,
                             n_chunks)
        count = torch.bincount(bucket, minlength=n_chunks + 1)
        groups = int((-(-count // group)).sum())
        timed[key] = (ms, plain_ms, bound_ms, bound_by, distinct, groups)
        log(f"[{card}] rescore_scores {key}, "
            f"{shapes['rescore_scores'][key]} launches: kernel {ms:.4f} ms, "
            f"plain (the yardstick) {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}; {distinct} distinct chunks, "
            f"{groups} groups of <= {group} pairs), {bound_ms / ms:.1%} of "
            f"the bound; no-reuse bytes {no_reuse / 1e9:.3f} GB = "
            f"{1e3 * no_reuse / HBM_BYTES_PER_S:.4f} ms")
    ms, plain_ms, bound_ms, bound_by = timed[rs_key][:4]
    out.append({
        "name": "rescore_scores", "route": "cuda",
        "source": "raft_tpu_torch/csrc/fused_knn.cu",
        "replaces": "raft_tpu/spatial/fused_knn.py:180",
        "launches": launches["rescore_scores"],
        "launches_by_shape": {"x".join(map(str, k)): v for k, v in
                              shapes["rescore_scores"].items()},
        "max_abs_err": errs["rescore_scores"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "shape": list(rs_key), "card": card,
        "timed": {"x".join(map(str, k)): dict(zip(
            ("ms", "plain_ms", "bound_ms", "bound_by", "distinct_chunks",
             "groups"), v)) for k, v in timed.items()},
    })

    # the probe at the SIFT phase-1 grid: the raw launch, then a clone
    src = torch.arange(1024, dtype=torch.float32, device=dev).reshape(8, 128)
    dst = torch.zeros_like(src)
    copies = torch.zeros(2, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def probe(s, o):
        check(lib.raft_fused_probe_grid_steps(s.data_ptr(), o.data_ptr(),
                                              copies.data_ptr(), sift_grid,
                                              stream) == 0,
              "probe launch failed")

    probe(src, dst)
    check(torch.equal(dst, src) and copies.tolist() == [1, sift_grid - 1],
          f"the probe's tile was not copied by its last block alone "
          f"(copies {copies.tolist()})")
    dst.zero_()

    def empty():
        check(lib.raft_fused_probe_empty(sift_grid, stream) == 0,
              "empty probe launch failed")

    ms = cuda_time_ms(probe, [(src, dst)])
    check(torch.equal(dst, src) and copies.tolist() == [56, sift_grid - 1],
          f"the probe's copy differs or ran in other blocks than the last "
          f"(copies {copies.tolist()} after 56 launches)")
    plain_ms = cuda_time_ms(lambda s, o: o.copy_(s), [(src, dst)])
    # the bound: the function's own work is one (8, 128) f32 tile read
    # and written once, at the memory rate, or the time of an empty
    # kernel over the same grid — the card's floor for issuing that many
    # blocks, the operations the probe exists to run — whichever is
    # larger
    floor_ms = cuda_time_ms(empty, [()])
    bytes_ms = bound(2 * src.numel() * 4, 0.0, FP32_FLOP_PER_S)[0]
    bound_ms = max(bytes_ms, floor_ms)
    bound_by = "bytes" if bytes_ms >= floor_ms else "operations"
    log(f"[{card}] probe_grid_steps kernel at {sift_grid} blocks "
        f"{ms:.4f} ms, plain (one tile copy) {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: empty kernel over the grid "
        f"{floor_ms:.4f} ms, one tile in and out {bytes_ms:.7f} ms), "
        f"{bound_ms / ms:.1%} of the bound (the last block copies)")
    out.append({
        "name": "probe_grid_steps", "route": "cuda",
        "source": "raft_tpu_torch/csrc/fused_knn.cu",
        "replaces": "raft_tpu/spatial/fused_knn.py:443",
        "launches": launches["probe_grid_steps"],
        "max_abs_err": (dst - src).abs().max().item(), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bytes_ms": bytes_ms, "block_floor_ms": floor_ms,
        "library_ms": None, "shape": [sift_grid], "card": card,
    })
    out[0]["select_k_path"] = select_k
    return out


# the concurrency auditor on the card: an IVF-Flat index of its own
# (200,000 rows of width 96, 256 lists), requests of 1-64 rows from 32
# templates (so the result cache hits), four submitters racing close()
LC_ROWS, LC_LISTS, LC_TEMPLATES = 200_000, 256, 32
LC_SUBMITTERS, LC_PER_SUBMITTER, LC_CLOSE_AFTER = 4, 100, 250
LC_INGEST_ROUNDS, LC_INGEST_ROWS = 8, 64


def static_pass(card):
    """``python -m raft_tpu_torch.analysis`` and its ``--threads`` tier
    over the port and this script, in process: both must find nothing,
    and the lock-order graph must be the pinned order, cycle-free."""
    from raft_tpu_torch.analysis import main as analysis_main

    root = os.path.dirname(os.path.abspath(__file__))
    targets = [os.path.join(root, "raft_tpu_torch"),
               os.path.join(root, "chip_smoke.py")]
    out = {}
    for tier, flags in (("lint", []), ("threads", ["--threads"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = analysis_main([*flags, "--format", "json", *targets])
        out[tier] = json.loads(buf.getvalue())
        found = [f"{f['path']}:{f['line']}: [{f['rule']}] {f['message']}"
                 for f in out[tier]["findings"]]
        check(rc == 0 and not found,
              f"static pass ({tier}): rc {rc}, findings:\n"
              + "\n".join(found))
    log(f"[{card}] static pass: {out['lint']['checked_files']} files, "
        f"0 lint findings ({out['lint']['suppressed']} suppressed), "
        f"0 thread findings ({out['threads']['suppressed']} suppressed), "
        f"{len(out['threads']['edges'])} lock-order edges, no drift, "
        "no cycle")
    return out


def lockcheck_phase(args, card, dev):
    """The concurrency auditor on the card, after every timed point: a
    lock made while the tracer is on stays traced, so nothing this phase
    builds reaches a timed phase. The static pass (0 findings), then the
    runtime tracer on with the port's pinned order
    (``raft_tpu_torch/analysis/lock_order.json``) over: a few hundred
    requests through a ``ServingExecutor`` on the card (admission, flight
    recorder, result cache), their submits racing ``close()``; a
    durable-ingest round (upserts and deletes through ``DurableIngest``
    over a WAL, its group commit flushing beside them); and the
    supervisor's kill -> reroute -> heal cycle at P = 8. Then
    ``assert_clean()``, and one line with the observed edges and the
    hold outliers."""
    import tempfile

    from raft_tpu_torch import errors
    from raft_tpu_torch.analysis import threads as lockcheck
    from raft_tpu_torch.comms import build_comms
    from raft_tpu_torch.durability import wal
    from raft_tpu_torch.obs import MetricRegistry
    from raft_tpu_torch.obs.flight import FlightRecorder
    from raft_tpu_torch.resilience import AdmissionController
    from raft_tpu_torch.serving import ResultCache, ServingExecutor
    from raft_tpu_torch.spatial.ann import mutation as mut
    from raft_tpu_torch.spatial.ann.ivf_flat import (
        IVFFlatParams, ivf_flat_build, ivf_flat_search_grouped,
    )
    from raft_tpu_torch.testing.heal_rows import self_heal_row

    static = static_pass(card)
    rng = np.random.default_rng(args.seed + 90)
    x = clustered_rows(rng, LC_ROWS, DIM)
    t0 = time.perf_counter()
    index = ivf_flat_build(x, IVFFlatParams(
        n_lists=LC_LISTS, kmeans_n_iters=5, kmeans_init="random",
    ), device=dev)
    qcaps = {b: index.warmup(b, k=K, n_probes=N_PROBES) for b in BUCKETS}
    sync(dev)
    log(f"[{card}] lock tracer: index {LC_ROWS} x {DIM}, {LC_LISTS} lists, "
        f"built and warmed in {time.perf_counter() - t0:.2f} s")
    templates = (x[rng.integers(0, LC_ROWS, LC_TEMPLATES)]
                 + 0.3 * rng.standard_normal((LC_TEMPLATES, DIM),
                                             dtype=np.float32))

    prev = lockcheck.set_enabled(True)
    lockcheck.clear()
    check(lockcheck.load_pinned_order(),
          "the port's pinned lock order did not load")
    t0 = time.perf_counter()
    try:
        # 1. the executor, its submits racing close()
        ex = ServingExecutor(
            lambda b, **_: ivf_flat_search_grouped(
                index, b, K, n_probes=N_PROBES, qcap=qcaps[b.shape[0]]),
            BUCKETS, dim=DIM, device=dev, flush_age_s=0.002,
            max_in_flight=4,
            admission=AdmissionController(max_concurrent=4, max_queue=256),
            flight=FlightRecorder(capacity=256, name="lockcheck"),
            result_cache=ResultCache(K, device=dev,
                                     registry=MetricRegistry()),
            registry=MetricRegistry(), name="lockcheck")
        check(isinstance(ex._lock, lockcheck.TracedLock),
              "the executor's lock is not traced")
        counts = collections.Counter()
        accepted = []
        res_lock = threading.Lock()

        def submitter(seed):
            srng = np.random.default_rng(seed)
            for _ in range(LC_PER_SUBMITTER):
                m = int(srng.integers(1, 65))
                rows = templates[srng.integers(0, LC_TEMPLATES, m)]
                try:
                    fut = ex.submit(rows)
                except errors.RaftLogicError:
                    with res_lock:
                        counts["closed"] += 1
                    return
                except errors.RaftOverloadError:
                    with res_lock:
                        counts["shed"] += 1
                    continue
                with res_lock:
                    accepted.append((m, fut))

        threads = [threading.Thread(target=submitter,
                                    args=(args.seed + 91 + i,),
                                    name=f"lockcheck-submitter-{i}")
                   for i in range(LC_SUBMITTERS)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        while (len(accepted) < LC_CLOSE_AFTER
               and any(t.is_alive() for t in threads)
               and time.monotonic() < deadline):
            time.sleep(0.001)
        ex.close(timeout_s=120)
        for t in threads:
            t.join(60)
        check(not any(t.is_alive() for t in threads),
              "a submitter wedged against close()")
        check(not ex._batcher.is_alive() and not ex._drainer.is_alive(),
              "an executor loop outlived close()")
        for m, fut in accepted:
            check(fut.done(), "an accepted request never resolved")
            if fut.exception() is not None:
                counts["failed"] += 1
                continue
            d, i = (np.asarray(torch.as_tensor(a).cpu()) for a in
                    fut.result())
            check(d.shape == i.shape == (m, K) and np.isfinite(d).all()
                  and ((i >= 0) & (i < LC_ROWS)).all(),
                  f"a traced answer of shape {d.shape} is not finite ids")
            counts["answered"] += 1
        check(counts["answered"] >= LC_CLOSE_AFTER // 2,
              f"only {counts['answered']} traced requests answered")
        try:
            ex.submit(templates[:1])
            check(False, "a submit after close() was accepted")
        except errors.RaftLogicError:
            pass
        # 2. a durable-ingest round through the WAL
        with tempfile.TemporaryDirectory() as tmp:
            w = wal.WalWriter(os.path.join(tmp, "wal"),
                              flush_interval_s=0.0005)
            ing = wal.DurableIngest(mut.wrap_mutable(index, delta_cap=32),
                                    w)
            check(isinstance(ing._lock, lockcheck.TracedLock),
                  "the ingest lock is not traced")
            for r in range(LC_INGEST_ROUNDS):
                src = rng.integers(0, LC_ROWS, LC_INGEST_ROWS)
                ids = (LC_ROWS + r * LC_INGEST_ROWS
                       + np.arange(LC_INGEST_ROWS, dtype=np.int32))
                check(bool(np.asarray(ing.upsert(
                    x[src] + 0.01, ids.astype(np.int32))).all()),
                      f"ingest round {r}: an upsert was refused")
                check(bool(np.asarray(ing.delete(
                    np.asarray([r], np.int32))).all()),
                      f"ingest round {r}: a delete missed")
            ing.close()
            counts["ingest_lsn"] = int(ing.applied_lsn)
        # 3. the supervisor's kill -> reroute -> heal cycle
        cuda0 = (torch.device("cuda", torch.cuda.current_device())
                 if dev.type == "cuda" else dev)
        row = self_heal_row(build_comms([cuda0] * SHARD_P), x, templates,
                            k=K, n_probes=16, kill_at_s=0.2,
                            heal_at_s=0.9, duration_s=1.6,
                            seed=args.seed + 92)
        check("error" not in row and row["failed_requests"] == 0
              and row["supervisor_heals_ok"] >= 1 and row["all_serving"],
              f"traced heal: {row}")
        # every nested acquisition off the pinned order, or under a lock
        # at a dispatch, is a violation; an observed edge is a blessed one
        lockcheck.assert_clean()
        edges = lockcheck.observed_edges()
        outliers = lockcheck.hold_outliers()
    finally:
        lockcheck.set_enabled(prev)
    n_edges = sum(len(b) for b in edges.values())
    worst = collections.Counter(o.lock for o in outliers)
    line = {
        "static_findings": len(static["lint"]["findings"])
        + len(static["threads"]["findings"]),
        "pinned_edges": len(static["threads"]["edges"]),
        "violations": len(lockcheck.violations()),
        "observed_edges": n_edges,
        "edges": sorted(f"{a} -> {b}" for a, bs in edges.items()
                        for b in bs),
        "hold_outliers": len(outliers),
        "hold_outlier_ms_max": max((o.held_ms for o in outliers),
                                   default=0.0),
        "hold_outlier_locks": dict(worst),
        "answered": counts["answered"], "closed": counts["closed"],
        "shed": counts["shed"], "failed": counts["failed"],
        "ingest_lsn": counts["ingest_lsn"],
        "heals_ok": row["supervisor_heals_ok"],
        "traced_s": round(time.perf_counter() - t0, 3),
    }
    log(f"[{card}] lock tracer: " + json.dumps(line))
    lockcheck.clear()
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    # a crash in native code (the kernel libraries, the host library, the
    # profiler) prints every thread's stack before the process dies
    faulthandler.enable(all_threads=True)

    card = phase_device()
    dev = torch.device("cuda")
    phase_build()
    t0 = time.perf_counter()
    served, flat = ivf_flat_phase(args, card, dev)
    kernels = [flat]
    flat["wide_rows"] = wide_rows_phase(args, card, dev)
    flat["launches"] += flat["wide_rows"]["launches"]
    log(f"IVF-Flat phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    executor_phase(args, card, dev, *served)
    log(f"executor phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    flat["mutation"] = mutation_phase(args, card, dev, *served)
    log(f"mutation phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    flat["tier"] = tier_phase(args, card, dev, *served)
    log(f"tier phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    flat["sharded"] = sharded_phase(args, card, dev, *served)
    flat["launches"] += (flat["sharded"]["launches"]
                         + flat["sharded"]["mutation"]["launches"])
    log(f"sharded phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    flat["self_heal"] = self_heal_phase(args, card, dev, served[2])
    flat["launches"] += flat["self_heal"]["launches"]
    log(f"self-heal phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    flat["coarse_probe"] = coarse_phase(args, card, dev, served[0],
                                        served[2])
    log(f"coarse-probe phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    library = library_phase(args, card, dev, *served)
    flat["library"] = library
    flat["launches"] += library["launches"]
    del served
    log(f"library phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    feed = {}
    linkage = linkage_phase(args, card, dev, feed)
    log(f"linkage phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    toolkit_phase(args, card, dev, feed)
    del feed
    log(f"toolkit phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    data = ann_data(args.seed, dev)
    kernels += quantized_phases(args, card, dev, data)
    # the sharded phase's SQ step launched #3 too
    kernels[1]["launches"] += flat["sharded"]["sq_launches"]
    kernels.insert(0, subchunk_scan_entry(kernels[0], kernels[1]))
    log(f"IVF-SQ and IVF-PQ phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels.append(graph_phase(args, card, dev, data))
    del data
    log(f"graph phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels += brute_force_phase(args, card, dev)
    log(f"brute-force phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cells = select_k_step(card, dev, args.seed)
    log(f"select_k step: {time.perf_counter() - t0:.1f} s")
    kernels.append(select_k_entry(
        {e["name"]: e.pop("select_k_path") for e in kernels
         if "select_k_path" in e}, cells, card))
    t0 = time.perf_counter()
    cells = rerank_step(card, dev, args.seed)
    log(f"rerank step: {time.perf_counter() - t0:.1f} s")
    paths = {e["name"]: e.pop("rerank_path") for e in kernels
             if "rerank_path" in e}
    kernels.append(rerank_entry(
        {"ivf_flat": paths["flat_scan_subchunk_min"],
         "gist_width": flat["wide_rows"].pop("rerank_path"),
         "ivf_sq": paths["sq_scan_subchunk_min"],
         "ivf_pq": paths["pq_adc_subchunk_min"]}, cells, card))
    t0 = time.perf_counter()
    lockcheck_phase(args, card, dev)
    log(f"lock-tracer phase: {time.perf_counter() - t0:.1f} s")
    # the library phase's facade brute force and the linkage phase's kNN
    # graphs launched #6 and #7 too
    for entry in kernels:
        if entry["name"] in ("chunk_mins", "rescore_scores"):
            entry["launches"] += (library["fused_launches"][entry["name"]]
                                  + linkage["fused_launches"][entry["name"]])
            entry["library_max_abs_err"] = \
                library["fused_max_abs_err"].get(entry["name"])
            entry["linkage_launches"] = linkage["fused_launches"][
                entry["name"]]
            entry["linkage_max_abs_err"] = linkage["max_abs_err"][
                entry["name"]]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    check(len(kernels) == 10 and all(keys <= set(k) for k in kernels),
          "the kernels line needs all ten kernels with every key")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
