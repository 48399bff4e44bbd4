"""The graph index on a clustered corpus, JAX package against the port,
on the CPU:

    JAX_PLATFORMS=cpu python tests/torch_graph_patch_study.py [--n 20000]
        [--clusters 40] [--threads 4]

Builds both packages' degree-16 graphs over n x 96 rows around
well-separated centres (uniform in [-10, 10), std 1: the geometry of
chip_smoke.py's corpus), prints the share of equal adjacency rows, the
port's build stages (the reachability patch's edges and unreached rows
by round), and recall@10 of both searches at beams 16/32/64 against an
exact numpy oracle on 256 noisy queries. The kNN graph of such a corpus
falls into one component per cluster, which is where the patch rewrites
most of the graph.
"""

import argparse
import time

import numpy as np
import torch

from raft_tpu.spatial.ann import GraphParams as JGraphParams
from raft_tpu.spatial.ann import graph_build as j_graph_build
from raft_tpu.spatial.ann import graph_search as j_graph_search
from raft_tpu_torch.spatial.ann import GraphParams, graph_build, graph_search


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--clusters", type=int, default=40)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)

    rng = np.random.default_rng(0)
    n, d = args.n, 96
    centers = rng.uniform(-10, 10, (args.clusters, d)).astype(np.float32)
    x = (centers[rng.integers(0, args.clusters, n)]
         + rng.standard_normal((n, d), dtype=np.float32))
    q = (x[rng.integers(0, n, 256)]
         + 0.3 * rng.standard_normal((256, d), dtype=np.float32))
    d2 = (q * q).sum(1)[:, None] + (x * x).sum(1)[None] - 2 * q @ x.T
    true = np.argsort(d2, 1)[:, :10]

    def recall(ids):
        return np.mean([len(set(a) & set(b)) / 10
                        for a, b in zip(np.asarray(ids), true)])

    t0 = time.time()
    j = j_graph_build(x, JGraphParams(degree=16, seed=0),
                      metric="sqeuclidean")
    print(f"JAX build {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    t = graph_build(x, GraphParams(degree=16, seed=0), metric="sqeuclidean",
                    device="cpu")
    print(f"port build {time.time() - t0:.1f} s {t.build_stats}", flush=True)
    same = (np.asarray(j.storage.adjacency)
            == t.storage.adjacency.numpy()).all(1).mean()
    print(f"adjacency rows equal: {same:.6f}")
    for beam in (16, 32, 64):
        _, ji = j_graph_search(j, q, 10, beam=beam)
        _, ti = graph_search(t, q, 10, beam=beam)
        print(f"beam {beam}: recall@10 JAX {recall(ji):.4f}, port "
              f"{recall(ti.numpy()):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
