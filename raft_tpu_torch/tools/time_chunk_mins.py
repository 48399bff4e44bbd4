"""Device time of brute-force phase 1 with bf16 compute at the smoke's two
bf16 shapes and the SIFT cell's shape at DEEP's width, on one CUDA card,
for the port in a given tree.

    python3 raft_tpu_torch/tools/time_chunk_mins.py [--root DIR] [--seed N]
        [--shape M,N,D,STORAGE ...]

Imports ``raft_tpu_torch`` from ``DIR`` (default: the checkout holding
this script), so one call can time two trees (a parent and a change) with
the same script and inputs. Shapes, as ``chip_smoke.py``'s bf16 batches
launch them: 10,000 queries x 1,000,000 x 128 f32 rows, and 1,024 queries
x 1,000,000 x 768 bf16 rows (one partition of the wide batch); then
10,000 x 1,000,000 x 96 f32 rows; npad as ``fused_l2_knn`` plans it
(``--shape`` replaces them). Rows are clustered Gaussians made on the card
from the seed. Each time is CUDA events over 20 warmed launches rotating
over copies of the inputs that overflow the L2 cache. Each shape also
names the kernel it took (``fused_knn.chunk_mins_route``; "mma" in a tree
that has no route rule, where every bf16 call ran the mma.sync kernel).
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

SHAPES = ((10_000, 1_000_000, 128, "float32"),
          (1_024, 1_000_000, 768, "bfloat16"),
          (10_000, 1_000_000, 96, "float32"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shape", action="append", default=None,
                    help="queries,rows,width,storage (float32|bfloat16)")
    args = ap.parse_args(argv)
    shapes = SHAPES if args.shape is None else [
        (int(a), int(b), int(c), st) for a, b, c, st in
        (sh.split(",") for sh in args.shape)]
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    from raft_tpu_torch.spatial import fused_knn as fz

    if not torch.cuda.is_available():
        raise SystemExit("time_chunk_mins: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    out = {"root": str(args.root), "card": card, "shapes": []}
    for m, n, d, storage in shapes:
        centers = torch.randn((2000, d), generator=g, device="cuda") * 2.0
        lab = torch.randint(0, 2000, (n,), generator=g, device="cuda")
        y = (centers[lab] + torch.randn((n, d), generator=g, device="cuda")
             ).to(getattr(torch, storage))
        q = (y[:m].float()
             + 0.3 * torch.randn((m, d), generator=g, device="cuda"))
        yn = (y.float() ** 2).sum(1)
        _, bn = fz._plan_blocks(m, n, d)
        npad = -(-n // bn) * bn
        nbytes = sum(t.numel() * t.element_size() for t in (q, y, yn))
        sets = [(q.clone(), y.clone(), yn.clone())
                for _ in range(max(2, math.ceil(4 * l2 / nbytes)))]
        del y, centers, lab
        for i in range(3):
            fz.chunk_mins(*sets[i % len(sets)], npad, torch.bfloat16)
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        iters = 20
        t0.record()
        for i in range(iters):
            fz.chunk_mins(*sets[i % len(sets)], npad, torch.bfloat16)
        t1.record()
        torch.cuda.synchronize()
        route = (fz.chunk_mins_route(d, torch.bfloat16)
                 if hasattr(fz, "chunk_mins_route") else "mma")
        out["shapes"].append({"shape": [m, n, d, storage, "bfloat16"],
                              "route": route,
                              "ms": t0.elapsed_time(t1) / iters})
        del sets
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
