"""Ring dataflow over the ranks — the port of ``raft_tpu/comms/ring.py``:
with both operands row-sharded, each rank keeps one query shard and one
visiting index shard; each of P steps folds the visiting shard into the
running result and passes it on to the next rank (``ring_shift``), as
ring attention rotates its key/value blocks. Memory per rank is one
query shard and one index shard, against every shard's (m, k) results
for the allgather form (:func:`~.mnmg.mnmg_knn`). No CUDA kernel of the
port runs here: each step is the plain streaming scan of
:func:`raft_tpu_torch.spatial.knn._knn_single_part`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.comms.mnmg import _shard_rows, _stack_rows
from raft_tpu_torch.core.device import full_f32
from raft_tpu_torch.distance.distance_type import resolve_metric
from raft_tpu_torch.spatial.knn import _block_dist, _knn_single_part
from raft_tpu_torch.spatial.selection import merge_topk

__all__ = ["ring_knn", "ring_pairwise_distance"]


def ring_knn(comms, index, queries, k: int, *, metric="l2_sqrt_expanded",
             p: float = 2.0, block_n: int = 4096
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fully sharded brute-force kNN: queries AND index row-sharded; the
    index shards travel the ring and every rank folds each visitor into
    its queries' running top-k. Returns (distances (m, k), int32 global
    row ids (m, k)), the ranks' query blocks in order."""
    metric = resolve_metric(metric)
    xs, n, rows = _shard_rows(comms, index)
    qs, m, _ = _shard_rows(comms, queries)
    P = comms.size

    def body(ax, q_loc, x_loc):
        rv = torch.full((q_loc.shape[0], k), float("inf"),
                        device=q_loc.device)
        ri = torch.zeros((q_loc.shape[0], k), dtype=torch.int32,
                         device=q_loc.device)
        blk, owner = x_loc, ax.get_rank()
        for _ in range(P):
            d_loc, i_loc = _knn_single_part(q_loc, blk, k, metric, p,
                                            block_n, None)
            gidx = i_loc.to(torch.int32) + owner * rows
            d_loc = torch.where(gidx < n, d_loc, float("inf"))
            rv, ri = merge_topk(rv, ri, d_loc, gidx, select_min=True)
            # my shard goes to rank + 1; the one I receive is rank - 1's
            blk = ax.ring_shift(blk, 1)
            owner = (owner - 1) % P
        return rv, ri

    rv, ri = comms.run(body, sharded=(qs, xs), out="stacked")
    return _stack_rows(rv)[:m], _stack_rows(ri)[:m]


@full_f32
def ring_pairwise_distance(comms, x, y, *, metric="l2_sqrt_expanded",
                           p: float = 2.0) -> torch.Tensor:
    """The full (m, n) distance matrix with both operands row-sharded: the
    y shards travel the ring and each rank fills its row block's column
    stripe from each visitor."""
    metric = resolve_metric(metric)
    xs, m, _ = _shard_rows(comms, x)
    ys, n, y_rows = _shard_rows(comms, y)
    P = comms.size

    def body(ax, x_loc, y_loc):
        out = torch.zeros((x_loc.shape[0], P * y_rows), dtype=torch.float32,
                          device=x_loc.device)
        blk, owner = y_loc, ax.get_rank()
        for _ in range(P):
            out[:, owner * y_rows:(owner + 1) * y_rows] = _block_dist(
                x_loc, blk, metric, p).float()
            blk = ax.ring_shift(blk, 1)
            owner = (owner - 1) % P
        return out

    out = comms.run(body, sharded=(xs, ys), out="stacked")
    return _stack_rows(out)[:m, :n]
