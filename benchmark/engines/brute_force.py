"""Exact brute-force kNN through the port's public entry,
``brute_force_knn``, with the fused path's tuning of the configuration
(phase 1 in ``compute_dtype``, ``extra_chunks`` of margin) and the rows'
squared norms given. On a card the routing is the program's own
(``use_fused=None``: the fused kernels #6 and #7 on an H100); on the CPU
the fused path's plain versions run only when forced, so there it is
forced. The port is imported, and the build's kernels loaded, with this
module, before the rows are made (:func:`_load_build_kernels`)."""

from __future__ import annotations

import torch

from benchmark.engines import common
from raft_tpu_torch.linalg import row_norm
from raft_tpu_torch.spatial import brute_force_knn, fused_knn

DISTANCE = "sqeuclidean"   # l2_expanded returns squared L2 distances


def _load_build_kernels() -> None:
    """Load the CUDA kernels the build launches (the norms' product and
    row sum) into the process, where there is a card. A kernel's first
    launch in a process loads it (lazy module loading): 20–34 ms on the
    H100, in two modes, against the build's own 0.8–1.0 ms. A deployment's
    process pays that once, before its first index, so here it is set-up,
    and the timed build holds the build's own work."""
    if torch.cuda.is_available():
        row_norm(torch.ones((4, 128), device="cuda"))


_load_build_kernels()


def instrument(trace) -> None:
    """A traced run's spans: the phase-1 and rescore launches, with what
    their counts need (``roofline_knn``)."""
    common.span_launches(
        trace, fused_knn, "chunk_mins", "bench.chunk_mins",
        lambda q, y, *rest: (q.shape[0], y.shape[0], y.shape[1], y.element_size()))
    common.span_launches(
        trace, fused_knn, "rescore_scores", "bench.rescore",
        lambda q, cids, y: (cids, y.shape[0], y.shape[1], y.element_size()))


def build(x, cfg: dict, seed: int, device):
    """What the deployment does before its first query: the rows
    contiguous in their stored type on the card, and their squared norms
    taken once."""
    rows = x.to(getattr(torch, cfg["index"]["storage"])).contiguous()
    return {"rows": rows, "norms": row_norm(rows.float())}


def search_fn(index, cfg: dict, nq: int):
    """The search closure of batches of ``nq`` queries."""
    ix = cfg["index"]
    k = int(cfg["k"])
    rows, norms = index["rows"], index["norms"]
    use_fused = None if rows.device.type == "cuda" else True
    kw = {"metric": "l2_expanded", "compute_dtype": getattr(torch, ix["compute_dtype"]),
          "extra_chunks": int(ix["extra_chunks"]), "index_norms": [norms],
          "use_fused": use_fused}

    def search(q):
        return brute_force_knn(rows, q, k, **kw)

    return search


def yardstick(index, cfg: dict) -> None:
    return None
