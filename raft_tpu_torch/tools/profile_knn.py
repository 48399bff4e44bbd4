"""Where the time of one brute-force kNN batch goes, on one CUDA card.

    python3 -m raft_tpu_torch.tools.profile_knn [--bf16 | --wide]
        [--seed N] [--out DIR]

Makes the brute-force path's SIFT-1M-shaped index (1,000,000 clustered
rows of width 128, as ``chip_smoke.py``) with its row norms, then for a
512-query serving batch and the 10,000-query batch times 5 searches
(``brute_force_knn``, k=10, the fused kernels) on the host clock, each
ending in a synchronise, and traces the same searches with
``torch.profiler``. With ``--bf16`` phase 1 runs in bf16 on the tensor
cores (``compute_dtype=torch.bfloat16``, ``extra_chunks=32``, as
``chip_smoke.py``'s bf16 batch). With ``--wide`` it profiles
``chip_smoke.py``'s wide batch instead: 1,024 queries over 2,000,000
clustered bf16 rows of width 768 in two partitions, bf16 phase 1. It
prints, per batch: the wall time, the device busy
time (the union of the kernels' intervals), the idle share, and the
kernels that took the most device time. With ``--out`` it also writes
each trace as a Chrome trace there.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from raft_tpu_torch.distance import row_norm_sq
from raft_tpu_torch.spatial import brute_force_knn
from raft_tpu_torch.tools.profile_grouped import card_name, trace_calls

N_ROWS, DIM, K = 1_000_000, 128, 10
BATCHES = (512, 10_000)
WIDE_ROWS, WIDE_DIM, WIDE_QUERIES = 2_000_000, 768, 1024
ITERS = 5


def wide_batch(seed: int):
    """chip_smoke.py's wide batch: two bf16 partitions of clustered rows
    made on the card, their norms, 1,024 queries near rows."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    centers = torch.randn((2000, WIDE_DIM), generator=g, device="cuda") * 2
    parts = []
    for _ in range(2):
        lab = torch.randint(0, 2000, (WIDE_ROWS // 2,), generator=g,
                            device="cuda")
        parts.append((centers[lab] + torch.randn(
            (WIDE_ROWS // 2, WIDE_DIM), generator=g, device="cuda")
        ).to(torch.bfloat16))
    norms = [(p.float() ** 2).sum(1) for p in parts]
    pick = torch.randint(0, WIDE_ROWS // 2, (WIDE_QUERIES,), generator=g,
                         device="cuda")
    q = parts[0][pick].float() + 0.3 * torch.randn(
        (WIDE_QUERIES, WIDE_DIM), generator=g, device="cuda")
    return parts, norms, q


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 phase 1 (compute_dtype=bfloat16)")
    ap.add_argument("--wide", action="store_true",
                    help="the 2M x 768 bf16 batch (bf16 phase 1)")
    args = ap.parse_args(argv)
    card = card_name("profile_knn")
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    if args.wide:
        parts, norms, q = wide_batch(args.seed)
        wall, busy, top = trace_calls(
            lambda: brute_force_knn(parts, q, K, use_fused=True,
                                    compute_dtype=torch.bfloat16,
                                    extra_chunks=32, index_norms=norms),
            ITERS, None if args.out is None else args.out / "knn_wide.json")
        print(f"[{card}] brute-force batch of {WIDE_QUERIES} over "
              f"{WIDE_ROWS} x {WIDE_DIM} bf16 in 2 partitions (bf16 phase "
              f"1): {wall:.3f} ms per batch, device busy {busy:.3f} ms, "
              f"idle {1 - busy / wall:.1%}", flush=True)
        for name, ms, n in top:
            print(f"    {ms:9.4f} ms {n:7.1f}x  {name[:100]}", flush=True)
        return 0

    rng = np.random.default_rng(args.seed)
    centers = rng.standard_normal((2000, DIM), dtype=np.float32) * 2.0
    x_np = (centers[rng.integers(0, 2000, N_ROWS)]
            + rng.standard_normal((N_ROWS, DIM), dtype=np.float32))
    x = torch.as_tensor(x_np, device="cuda")
    norms = row_norm_sq(x)
    kw = ({"compute_dtype": torch.bfloat16, "extra_chunks": 32} if args.bf16
          else {})
    what = "bf16 phase 1" if args.bf16 else "f32 phase 1"
    for nq in BATCHES:
        q = torch.as_tensor(
            x_np[rng.integers(0, N_ROWS, nq)]
            + 0.3 * rng.standard_normal((nq, DIM), dtype=np.float32),
            device="cuda")
        wall, busy, top = trace_calls(
            lambda: brute_force_knn(x, q, K, index_norms=norms, **kw), ITERS,
            None if args.out is None else
            args.out / f"knn_{nq}{'_bf16' if args.bf16 else ''}.json")
        print(f"[{card}] brute-force batch of {nq} ({what}): {wall:.3f} ms "
              f"per batch, device busy {busy:.3f} ms, idle "
              f"{1 - busy / wall:.1%}", flush=True)
        for name, ms, n in top:
            print(f"    {ms:9.4f} ms {n:7.1f}x  {name[:100]}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
