"""Device time of the beam scan and the brute-force rescore at
``chip_smoke.py``'s path shapes, on one CUDA card, for the port in a given
tree.

    python3 raft_tpu_torch/tools/time_kernels.py [--root DIR] [--seed N]

Imports ``raft_tpu_torch`` from ``DIR`` (default: the checkout holding
this script), so one call can time two trees (a parent and a change) with
the same script and inputs; it uses only entry points both have.

* ``rescore_scores``: a SIFT-shaped index (1,000,000 clustered f32 rows of
  width 128) and 512 and 10,000 queries near rows, each query's candidate
  chunks its 24 (f32 phase 1) and, at 10,000, 48 (bf16 phase 1) best by
  ``chunk_mins``, as the smoke's serving batches and f32 and bf16
  batches pick them; and one partition of the wide batch (1,000,000
  clustered bf16 rows of width 768), 1,024 queries, 48 chunks each.
* the beam scan: a 500,000 x 96 f32 table and its sentinel row, ids
  ``(NQ, Cpad)`` at (4096, 1024), (4096, 512), (4096, 256) and (1, 1024)
  drawn at random over the rows with the last quarter the sentinel (the
  walk's padding); the minima alone (``beam_scan_subchunk_min``) and,
  where the tree has it, both outputs (``beam_scan_score``).

Each time is CUDA events over 20 warmed launches rotating over copies of
the inputs that overflow the L2 cache. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

RESCORE = ((512, 1_000_000, 128, "float32", "float32", 24),
           (10_000, 1_000_000, 128, "float32", "float32", 24),
           (10_000, 1_000_000, 128, "float32", "bfloat16", 48),
           (1_024, 1_000_000, 768, "bfloat16", "bfloat16", 48))
BEAM_ROWS, BEAM_DIM = 500_000, 96
BEAM = ((4096, 1024), (4096, 512), (4096, 256), (1, 1024))
ITERS = 20


def _time(fn, sets):
    import torch

    for i in range(3):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(ITERS):
        fn(*sets[i % len(sets)])
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / ITERS


def _copies(*ts):
    import torch

    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    nbytes = sum(t.numel() * t.element_size() for t in ts)
    return [tuple(t.clone() for t in ts)
            for _ in range(max(2, math.ceil(4 * l2 / nbytes)))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    from raft_tpu_torch.spatial import fused_knn as fz
    from raft_tpu_torch.spatial.ann import graph_kernel as gk

    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    out = {"root": str(args.root), "card": card, "rescore": [], "beam": []}

    index = {}
    for m, n, d, storage, cd, c in RESCORE:
        if (n, d, storage) not in index:
            index.clear()
            torch.cuda.empty_cache()
            centers = torch.randn((2000, d), generator=g, device="cuda") * 2
            lab = torch.randint(0, 2000, (n,), generator=g, device="cuda")
            y = (centers[lab] + torch.randn((n, d), generator=g,
                                            device="cuda")
                 ).to(getattr(torch, storage))
            index[(n, d, storage)] = (y, (y.float() ** 2).sum(1))
            del centers, lab
        y, yn = index[(n, d, storage)]
        q = (y[:m].float()
             + 0.3 * torch.randn((m, d), generator=g, device="cuda"))
        _, bn = fz._plan_blocks(m, n, d)
        npad = -(-n // bn) * bn
        mins = fz.chunk_mins(q, y, yn, npad, getattr(torch, cd))
        cids = torch.topk(mins, c, dim=1, largest=False).indices.to(
            torch.int32)
        del mins
        sets = _copies(q, cids, y)
        out["rescore"].append({
            "shape": [m, c, n, d, storage], "phase1": cd,
            "ms": _time(fz.rescore_scores, sets),
            "distinct_chunks": torch.unique(cids).numel()})
        del sets, q, cids
        torch.cuda.empty_cache()
    index.clear()

    table = torch.randn((BEAM_ROWS + 1, BEAM_DIM), generator=g,
                        device="cuda")
    table[BEAM_ROWS] = 1e15
    score = getattr(gk, "beam_scan_score", None)
    for nq, c_pad in BEAM:
        q = torch.randn((nq, BEAM_DIM), generator=g, device="cuda")
        ids = torch.randint(0, BEAM_ROWS, (nq, c_pad), generator=g,
                            device="cuda", dtype=torch.int32)
        ids[:, -(c_pad // 4):] = BEAM_ROWS
        bounds = torch.tensor([[0, c_pad]], dtype=torch.int32,
                              device="cuda").expand(nq, 2).contiguous()
        sets = _copies(q, table, ids, bounds)
        row = {"shape": [nq, c_pad, BEAM_DIM],
               "minima_ms": _time(gk.beam_scan_subchunk_min, sets)}
        if score is not None:
            row["score_ms"] = _time(
                lambda *a: score(*a, BEAM_ROWS), sets)
        out["beam"].append(row)
        del sets
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
