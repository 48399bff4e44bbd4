"""The two-level coarse probe's recall and FLOP ratio over centroid sets
of 65,792 x 96 by coarse geometry, on one CUDA card.

    python3 -m raft_tpu_torch.tools.sweep_coarse [--seed N]
        [--overprobe 2 2.5 3 4] [--base 1024 8224] [--n-super 0 512]
        [--iters 10] [--smoke]

The rows are ``chip_smoke.py``'s IVF-Flat corpus (1,000,000 clustered
rows of width 96 around 2,000 centres) and the queries its recipe (rows
plus 0.3-std noise). For each ``--base`` count B the centroid set is B
k-means centroids of the rows (10 iterations, random init, bf16
operands: an IVF-Flat build's coarse quantizer; B = 1024 is the smoke's
served index) and 65,792 - B draws of them with 0.5-std Gaussian jitter
(``bench.py:966-981``, where B is the shard's 8,224 lists, 1/8 of the
set). The coarse index takes ``--n-super`` supers (0: the default
geometry, ~sqrt(65,792) = 256) with the default member cap for that
count (ceil(1.5 x mean)), and ``--iters`` k-means iterations. Each
(B, supers, iterations, overprobe) prints the supers kept, the member
cap, S, the FLOP ratio and ``coarse_probe_recall`` of both engines on
1,024 queries, one JSON line each, with the (query, super) pairs the
kernel engine's stage-2 qcap drops there. ``--smoke`` takes
``chip_smoke.py``'s coarse-phase inputs instead: the served index's
1,024 centroids (an IVF-Flat build of the rows), its jitter draws and
queries (``numpy`` seeded ``seed + 9``), the audit on the first 1,024.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

N_ROWS, DIM, N_CENTS, N_PROBES, N_AUDIT = 1_000_000, 96, 65_792, 16, 1024


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--overprobe", type=float, nargs="+",
                    default=[2.0, 2.5, 3.0, 4.0])
    ap.add_argument("--base", type=int, nargs="+", default=[1024, 8224])
    ap.add_argument("--n-super", type=int, nargs="+", default=[0])
    ap.add_argument("--iters", type=int, nargs="+", default=[10])
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)

    from raft_tpu_torch.cluster.kmeans import KMeansParams, kmeans_fit
    from raft_tpu_torch.spatial.ann import coarse as tco
    from raft_tpu_torch.spatial.ann import common as cm

    if not torch.cuda.is_available():
        raise SystemExit("sweep_coarse: needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    centers = rng.standard_normal((2000, DIM), dtype=np.float32) * 2.0
    x = (centers[rng.integers(0, 2000, N_ROWS)]
         + rng.standard_normal((N_ROWS, DIM), dtype=np.float32))
    q = torch.as_tensor(
        x[rng.integers(0, N_ROWS, N_AUDIT)]
        + 0.3 * rng.standard_normal((N_AUDIT, DIM), dtype=np.float32),
        device=dev)
    xt = torch.as_tensor(x, device=dev)
    card = torch.cuda.get_device_name(0)
    if args.smoke:
        from raft_tpu_torch.spatial.ann import IVFFlatParams, ivf_flat_build

        base = ivf_flat_build(xt, IVFFlatParams(
            n_lists=1024, kmeans_n_iters=10, kmeans_init="random",
        )).centroids.float()
        rng = np.random.default_rng(args.seed + 9)
        sel = torch.as_tensor(rng.integers(0, 1024, N_CENTS - 1024),
                              device=dev)
        jitter = torch.as_tensor(0.5 * rng.standard_normal(
            (N_CENTS - 1024, DIM), dtype=np.float32), device=dev)
        cents = torch.cat([base, base[sel] + jitter])
        q = torch.as_tensor(
            x[rng.integers(0, N_ROWS, 16_384)]
            + 0.3 * rng.standard_normal((16_384, DIM), dtype=np.float32),
            device=dev)[:N_AUDIT]
        for ns in args.n_super:
            for iters in args.iters:
                sweep(cm, q, cents, card, "smoke", ns, iters,
                      args.overprobe, args.seed)
        return 0
    for nb in args.base:
        t0 = time.perf_counter()
        base = kmeans_fit(xt, KMeansParams(
            n_clusters=nb, max_iter=10, seed=args.seed, init="random",
            compute_dtype="bfloat16")).centroids.float()
        sel = torch.as_tensor(rng.integers(0, nb, N_CENTS - nb), device=dev)
        jitter = torch.as_tensor(0.5 * rng.standard_normal(
            (N_CENTS - nb, DIM), dtype=np.float32), device=dev)
        cents = torch.cat([base, base[sel] + jitter])
        for ns in args.n_super:
            for iters in args.iters:
                sweep(cm, q, cents, card, nb, ns, iters, args.overprobe,
                      args.seed)
    return 0


def sweep(cm, q, cents, card, nb, ns, iters, overprobes, seed):
    t0 = time.perf_counter()
    coarse = cm.build_coarse_index(
        cents, n_super=ns or None,
        member_cap=(None if not ns
                    else max(8, -(-3 * -(-N_CENTS // ns) // 2))),
        kmeans_n_iters=iters, seed=seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    for op in overprobes:
        rec = {name: tco.coarse_probe_recall(
            q, cents, coarse, N_PROBES, overprobe=op, use_kernel=k)
            for name, k in (("legacy", False), ("kernel", True))}
        S = cm.n_super_probes(N_PROBES, coarse.n_super, op)
        qcap = tco._probe_qcap(q.shape[0], S, coarse.n_super)
        sup = tco._super_scan_kernel(q, coarse.super_cents, S, 256)
        slot = cm.invert_probe_map_ranked(sup, coarse.n_super, qcap)[3]
        drop = (slot >= qcap).reshape(q.shape[0], S)
        print(json.dumps({
            "card": card, "base": nb, "n_super_asked": ns or None,
            "iters": iters, "overprobe": op, "n_super": coarse.n_super,
            "max_members": coarse.max_members,
            "S": cm.n_super_probes(N_PROBES, coarse.n_super, op),
            "flop_ratio": cm.probe_flop_accounting(
                coarse, N_PROBES, overprobe=op)["ratio"],
            "recall": rec, "build_s": build_s, "qcap": qcap,
            "dropped_pairs": int(drop.sum()),
            "queries_with_drops": int(drop.any(1).sum()),
        }), flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
