"""The spectral corpus's spread: for each row count and centre separation,
the k = 16 kNN graph's components, its share of cross-centre edges and
the purity of ``spectral.partition`` against the centres.

    python3 -m raft_tpu_torch.tools.sweep_spectral [--rows 16384 32768]
        [--sep 8 9 10] [--device cpu|cuda] [--threads 4]

The corpus is ``chip_smoke.py``'s spectral corpus (:func:`corpus`, which
the smoke imports): 8 centres ``sep`` noise-sigmas apart in random
directions of width 128, unit Gaussian noise, scaled by 0.01. Fewer rows
than the smoke's 131,072 leave the rows sparser, so more kNN edges cross
between centres; the smoke itself asserts one component at its size.
Prints one JSON line per (rows, sep), with the device it ran on.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch

DIM, CENTRES, K, SCALE = 128, 8, 16, 0.01


def corpus(n: int, sep: float, gen: torch.Generator, device,
           centres: int = CENTRES, dim: int = DIM, scale: float = SCALE):
    """(rows (n, dim) f32, true centre (n,)): ``centres`` centres at
    distance ~``sep`` from each other (random unit directions times
    sep / sqrt(2)), row i around centre i mod ``centres`` with unit
    Gaussian noise, all scaled by ``scale``. ``gen`` draws on
    ``device``."""
    dirs = torch.randn((centres, dim), generator=gen, device=device)
    c = dirs / dirs.norm(dim=1, keepdim=True) * (sep / math.sqrt(2))
    truth = torch.arange(n, device=device) % centres
    x = scale * (c[truth] + torch.randn((n, dim), generator=gen,
                                        device=device))
    return x, truth


def purity(labels, truth) -> float:
    """The share of rows whose label's most common true class is theirs."""
    labels, truth = labels.long(), truth.long()
    k = int(truth.max()) + 1
    joint = torch.bincount(labels * k + truth,
                           minlength=(int(labels.max()) + 1) * k)
    return float(joint.reshape(-1, k).max(1).values.sum()) / labels.numel()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[16384, 32768])
    ap.add_argument("--sep", type=float, nargs="+", default=[8.0, 9.0, 10.0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from raft_tpu_torch.sparse import csr_from_coo, knn_graph
    from raft_tpu_torch.sparse.connect import get_n_components
    from raft_tpu_torch.sparse.mst import boruvka_mst
    from raft_tpu_torch.spectral import (
        ClusterSolverConfig, EigenSolverConfig, partition,
    )

    torch.set_num_threads(args.threads)
    dev = torch.device(args.device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    for n in args.rows:
        for sep in args.sep:
            t0 = time.perf_counter()
            gen = torch.Generator(device=dev).manual_seed(args.seed)
            x, truth = corpus(n, sep, gen, dev)
            g = knn_graph(x, K)
            valid = g.valid_mask()
            cross = (truth[g.rows[valid].long()]
                     != truth[g.cols[valid].long()]).float().mean()
            res = partition(csr_from_coo(g), EigenSolverConfig(CENTRES),
                            ClusterSolverConfig(CENTRES))
            print(json.dumps({
                "device": kind, "rows": n, "sep": sep,
                "components": int(get_n_components(boruvka_mst(g).color)),
                "cross_edge_share": float(cross),
                "purity": purity(res.labels, truth),
                "seconds": time.perf_counter() - t0,
            }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
