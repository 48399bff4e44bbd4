#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (raft_tpu_torch) on one Hopper card.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from ``raft_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version, times it, and drives the
port's main path at full width: an IVF-Flat index over 1,000,000
clustered rows of width 96 (DEEP's width) built with 1024 lists, warmed
per serving bucket, serving ~200 requests through the bucketed
micro-batcher and the grouped search, with recall@10 of both scan
engines against exact brute force. Any failed check raises, and the
script exits non-zero. The last two lines of stdout are one JSON object
per kernel run and the ``{"ok": true, ...}`` device line.

Imports neither JAX nor the JAX package. Needs one CUDA device of
compute capability 9.0; without one it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): the bound
# of a kernel is the larger of its bytes over the memory rate and its
# operations over the rate of their type.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

N_ROWS, DIM, N_LISTS, N_PROBES, K = 1_000_000, 96, 1024, 8, 10
BUCKETS = (8, 64, 512, 4096)
N_REQUESTS = 200


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


def input_copies(qr, slabs_t, bounds):
    """Enough copies of one scan's inputs (each keeping its strides) to
    fill four times the card's L2 cache, at least two."""
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                 50 << 20)
    nbytes = sum(t.numel() * t.element_size() for t in (qr, slabs_t, bounds))
    n = max(2, math.ceil(4 * l2 / nbytes))
    return [(qr.clone(), slabs_t.transpose(1, 2).clone().transpose(1, 2),
             bounds.clone()) for _ in range(n)]


def scan_bound(lb: int, q: int, d: int, l_pad: int):
    """(bound_ms, bound_by) of the sub-chunk scan: each input read once
    (bf16 queries and slab, int32 bounds), the f32 minima written once,
    2 flop per multiply-add at the bf16 rate."""
    nbytes = lb * (q * d * 2 + d * l_pad * 2) + lb * q * (l_pad // 8) * 4 \
        + lb * 2 * 4
    flops = 2.0 * lb * q * l_pad * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
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
    from raft_tpu_torch import _build
    from raft_tpu_torch.spatial.ann import flat_kernel

    t0 = time.perf_counter()
    out_dir = _build.build_all()
    build_s = time.perf_counter() - t0
    lib = flat_kernel._lib()
    check(lib.raft_flat_scan_smem_bytes(DIM) == flat_kernel._smem_bytes(DIM),
          "the wrapper's shared-memory model disagrees with the kernel's")
    log(f"build: csrc/*.cu -> {out_dir} in {build_s:.2f} s")


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
def scan_calls(keep=None):
    """Count the calls of the scan's wrapper by (Q, Lpad) shape and, with
    a list ``keep``, keep each call's inputs there. The wrapper still
    runs (and counts its launches) as before."""
    from raft_tpu_torch.spatial.ann import flat_kernel as fk

    wrapper = fk.flat_scan_subchunk_min
    shapes = collections.Counter()

    def recording(qrows, slabs_t, bounds):
        shapes[(qrows.shape[1], slabs_t.shape[2])] += 1
        if keep is not None:
            keep.append((qrows, slabs_t, bounds))
        return wrapper(qrows, slabs_t, bounds)

    fk.flat_scan_subchunk_min = recording
    try:
        yield shapes
    finally:
        fk.flat_scan_subchunk_min = wrapper


def clustered_rows(rng, n, d, n_centers=2000):
    centers = rng.standard_normal((n_centers, d), dtype=np.float32) * 2.0
    lab = rng.integers(0, n_centers, n)
    return centers[lab] + rng.standard_normal((n, d), dtype=np.float32)


def exact_knn(x, q, k, block=1 << 16):
    """Exact squared-L2 top-k ids by plain f32 brute force (the oracle)."""
    from raft_tpu_torch.core.device import full_f32

    @full_f32
    def run():
        qn = (q * q).sum(1)[:, None]
        best_v = torch.full((q.shape[0], k), float("inf"), device=q.device)
        best_i = torch.zeros((q.shape[0], k), dtype=torch.int64,
                             device=q.device)
        for s in range(0, x.shape[0], block):
            xb = x[s:s + block]
            d2 = qn + (xb * xb).sum(1)[None, :] - 2.0 * (q @ xb.T)
            v, i = torch.topk(d2, k, dim=1, largest=False)
            cat_v = torch.cat([best_v, v], 1)
            cat_i = torch.cat([best_i, i + s], 1)
            best_v, o = torch.topk(cat_v, k, dim=1, largest=False)
            best_i = torch.gather(cat_i, 1, o)
        return best_i
    return run()


def recall(ids, true):
    ids, true = ids.cpu().numpy(), true.cpu().numpy()
    return sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(ids, true)) / true.size


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main_path(seed, card, dev):
    """Build -> warm each bucket -> serve requests through the
    micro-batcher -> recall of both engines, on ``dev``. Returns the
    index, the warmed qcap of each bucket and the rows."""
    from raft_tpu_torch.serving.batching import (
        BucketSet, PendingRequest, pack_requests,
    )
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

    buckets = BucketSet.of(BUCKETS)
    t0 = time.perf_counter()
    qcaps = {b: index.warmup(b, k=K, n_probes=N_PROBES)
             for b in buckets.sizes}
    log(f"[{card}] warmup: qcap per bucket {qcaps} in "
        f"{time.perf_counter() - t0:.2f} s")

    def noisy_rows(m):
        return (x[rng.integers(0, N_ROWS, m)]
                + 0.3 * rng.standard_normal((m, DIM), dtype=np.float32))

    # request sizes log-uniform over 1..512 rows, arriving 1-4 at a time
    # ahead of each batch, so every bucket sees traffic
    sizes = np.exp(rng.uniform(0.0, np.log(513.0), N_REQUESTS))
    requests = [noisy_rows(int(m)) for m in np.clip(sizes, 1, 512)]
    arrivals = [PendingRequest(r, None, 0.0) for r in requests]
    pending = []
    served, lat = {}, {b: [] for b in buckets.sizes}
    t_serve = time.perf_counter()
    while arrivals or pending:
        n_new = int(rng.integers(1, 5))
        pending += arrivals[:n_new]
        arrivals = arrivals[n_new:]
        batch, pending = pack_requests(pending, buckets, DIM)
        t0 = time.perf_counter()
        d, ids = ivf_flat_search_grouped(
            index, batch.queries, K, n_probes=N_PROBES,
            qcap=qcaps[batch.bucket])
        d, ids = d.cpu(), ids.cpu()           # waits for the device
        lat[batch.bucket].append(1e3 * (time.perf_counter() - t0))
        for req, start in batch.entries:
            served[id(req.queries)] = (d[start:start + req.n_rows],
                                       ids[start:start + req.n_rows])
    serve_s = time.perf_counter() - t_serve
    n_rows = sum(r.shape[0] for r in requests)
    for r in requests:
        d, ids = served[id(r)]
        check(d.shape == (r.shape[0], K) and bool(torch.isfinite(d).all()),
              f"served distances of shape {tuple(d.shape)} not finite")
        check(bool(((ids >= 0) & (ids < N_ROWS)).all()),
              "served ids out of range")
        check(bool((d[:, 1:] >= d[:, :-1]).all()), "served distances unsorted")
    log(f"[{card}] serve: {len(requests)} requests, {n_rows} rows in "
        f"{sum(len(v) for v in lat.values())} batches, {serve_s:.3f} s, "
        f"{n_rows / serve_s:.0f} queries/s")
    for b, v in lat.items():
        if v:
            log(f"[{card}] bucket {b}: {len(v)} batches, p50 "
                f"{float(np.median(v)):.3f} ms")
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    card = phase_device()
    dev = torch.device("cuda")
    phase_build()

    from raft_tpu_torch.spatial.ann import flat_kernel as fk

    # kernel vs plain version: the fixed reference shape and a ragged one
    for shape in ((32, 64, DIM, 3072), (3, 13, 24, 136)):
        err = check_kernel(*shape, seed=args.seed)
        log(f"kernel check {shape}: bitwise on integer-exact inputs, "
            f"Gaussian max |kernel - plain| {err:.3g}")
    gen = torch.Generator().manual_seed(args.seed)
    qr, rows = _int_inputs(gen, 32, 64, DIM, 3072, dev)
    ref = time_kernel(qr, rows.transpose(1, 2), _bounds(gen, 32, 3072, dev))
    bound = scan_bound(32, 64, DIM, 3072)
    log(f"[{card}] flat_scan_subchunk_min (32, 64, {DIM}, 3072): "
        f"kernel {ref[0]:.4f} ms, plain {ref[1]:.4f} ms, library "
        f"{ref[2]:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")

    # the main path, with every launch counter at 0 just before it
    from raft_tpu_torch.spatial.ann import ivf_flat

    fk.LAUNCHES = 0
    ivf_flat.ENGINE_FALLBACKS = 0
    with scan_calls() as shapes:
        index, qcaps, x = main_path(args.seed, card, dev)
    launches = fk.LAUNCHES
    log(f"main path: flat_scan_subchunk_min launched {launches} times, "
        f"by (Q, Lpad): {dict(shapes)}")
    check(launches > 0, "the main path never launched the kernel")
    check(ivf_flat.ENGINE_FALLBACKS == 0,
          f"{ivf_flat.ENGINE_FALLBACKS} main-path searches left the kernel")

    # the kernel against its plain version on every list block of one
    # batch per bucket: the main path's own inputs (its slabs, bounds and
    # zero-padded query slots) at each (Q, Lpad) it launches
    from raft_tpu_torch.spatial.ann import ivf_flat_search_grouped

    rng = np.random.default_rng(args.seed + 1)
    max_err, by_shape = 0.0, {}
    for b in BUCKETS:
        q = torch.as_tensor(
            x[rng.integers(0, N_ROWS, b)]
            + 0.3 * rng.standard_normal((b, DIM), dtype=np.float32),
            device=dev)
        keep = []
        with scan_calls(keep):
            ivf_flat_search_grouped(index, q, K, n_probes=N_PROBES,
                                    qcap=qcaps[b])
        err = max(compare_to_plain(*call) for call in keep)
        shape = (keep[0][0].shape[1], keep[0][1].shape[2])
        log(f"kernel check, bucket {b} (Q, Lpad) {shape}: {len(keep)} "
            f"blocks within 1e-5 x (qn + yn), max |kernel - plain| {err:.3g}")
        max_err = max(max_err, err)
        by_shape.setdefault(shape, keep[0])
    check(set(by_shape) >= set(shapes),
          f"main-path shapes {set(shapes)} not all checked: {set(by_shape)}")
    del keep

    timed = {}
    for (q_, l_pad), call in sorted(by_shape.items()):
        ms, plain_ms, library_ms = time_kernel(*call)
        bound_ms, bound_by = scan_bound(call[0].shape[0], q_, DIM, l_pad)
        timed[q_, l_pad] = (ms, plain_ms, library_ms, bound_ms, bound_by)
        log(f"[{card}] flat_scan_subchunk_min main-path shape (32, {q_}, "
            f"{DIM}, {l_pad}), {shapes[q_, l_pad]} launches: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"{bound_ms / ms:.1%} of the bound")
    # the line reports the shape the main path launched most
    (qc, l_pad), _ = shapes.most_common(1)[0]
    ms, plain_ms, library_ms, bound_ms, bound_by = timed[qc, l_pad]

    print(json.dumps({"kernels": [{
        "name": "flat_scan_subchunk_min",
        "route": "cuda",
        "source": "raft_tpu_torch/csrc/flat_scan.cu",
        "replaces": "raft_tpu/spatial/ann/flat_kernel.py:115",
        "launches": launches,
        "launches_by_shape": {f"{a}x{b}": n for (a, b), n in shapes.items()},
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "shape": [32, qc, DIM, l_pad],
        "card": card,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
