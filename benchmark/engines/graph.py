"""The graph index (CAGRA-style) through the port's public entries:
``graph_build``, then ``GraphIndex.warmup`` once for the batch size and
``graph_search`` at the ``iters`` it returns, with the engine the
program's own rule picks (``use_kernel=None``: the beam kernel #5 on an
H100, the exact engine on the CPU).

The adapter reads the graph search's engine counter
(``search_obs.graph_engines``) when it hands its yardstick over, and
imports it with this module: a port without the walk's ranges and
counters fails the cell here, before the rows are made."""

from __future__ import annotations

import torch

from benchmark.engines import common
from raft_tpu_torch.spatial import fused_knn
from raft_tpu_torch.spatial.ann import GraphParams, graph_build, graph_search
from raft_tpu_torch.spatial.ann import graph_kernel
from raft_tpu_torch.spatial.ann.search_obs import graph_engines

DISTANCE = "l2"          # the search returns sqrt of the squared L2 distance


def _load_build_kernels() -> None:
    """Build (on a checkout's first run) and load the CUDA kernels the
    graph build launches, where there is a card: the kNN graph's phase 1
    and rescore and the selection kernel, through one small fused search.
    A deployment's process pays that once, before its first index, so
    here it is set-up, and the timed build holds the build's own work."""
    if torch.cuda.is_available():
        y = torch.zeros((8192, 128), device="cuda")
        fused_knn.fused_l2_knn(y[:16], y, 10)


_load_build_kernels()

# the beam-kernel launches whose ids a traced run keeps for the roofline
# (the ids of one launch take ~80 MB at the cell's shape): one call's
# rounds at 1M rows, and every call of the batch does the same work
KEEP_LAUNCHES = 24


def instrument(trace) -> None:
    """A traced run's spans: each beam-kernel launch, keeping the ids and
    width of the first :data:`KEEP_LAUNCHES` for ``roofline_graph``."""
    span = "bench.beam_scan"

    def keep(q, table, ids, bounds, n):
        return (ids, table.shape[1]) if len(trace.kept[span]) < KEEP_LAUNCHES else None

    common.span_launches(trace, graph_kernel, "beam_scan_score", span, keep)


def build(x, cfg: dict, seed: int, device):
    ix = cfg["index"]
    params = GraphParams(degree=int(ix["degree"]),
                         intermediate_degree=int(ix["intermediate_degree"]),
                         seed=int(ix["seed"]), n_entry=int(ix["n_entry"]))
    return graph_build(x, params, metric="l2", device=device)


def search_fn(index, cfg: dict, nq: int):
    """The warmed search closure of batches of ``nq`` queries."""
    k, beam = int(cfg["k"]), int(cfg["search"]["beam"])
    iters = index.warmup(nq, k=k, beam=beam)

    def search(q):
        return graph_search(index, q, k, beam=beam, iters=iters)

    return search


def yardstick(index, cfg: dict) -> dict:
    """The build's stages (``graph.build_stats``) and the searches the
    exact engine took, for the readers."""
    return {"build_stats": dict(index.build_stats),
            "exact_engine_calls": graph_engines("exact")}
