"""Multi-rank algorithms over row-partitioned data — the port of
``raft_tpu/comms/mnmg.py`` (the reference's MNMG consumers): each rank
runs the single-device primitive on its shard and the results combine
through the communicator's collectives — kNN by a local top-k, one
allgather and a k-way merge (``knn_merge_parts``), k-means by allreduced
centroid sums. Neither launches a CUDA kernel of the port: brute force
here runs the plain streaming scan of
:func:`raft_tpu_torch.spatial.knn._knn_single_part` on each shard, as
the reference runs its XLA single-part search.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import errors
from raft_tpu_torch.cluster.kmeans import (
    KMeansOutput,
    KMeansParams,
    _update_centroids,
)
from raft_tpu_torch.comms.comms import ReduceOp
from raft_tpu_torch.comms.mnmg_ivf import _on, _sharded, _tensor
from raft_tpu_torch.core.device import full_f32
from raft_tpu_torch.distance.distance_type import resolve_metric
from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn
from raft_tpu_torch.spatial.knn import _knn_single_part
from raft_tpu_torch.spatial.selection import select_k, top_k_smallest

__all__ = ["mnmg_knn", "mnmg_kmeans_fit"]


def _shard_rows(comms, x):
    """A host (n, ...) array as equal row shards over the ranks (zero rows
    pad the last ones): returns (the local ranks' blocks as one sharded
    operand, n, rows a shard)."""
    x = np.asarray(x)
    if x.dtype == np.float64:
        x = x.astype(np.float32)
    n = x.shape[0]
    pad = (-n) % comms.size
    if pad:
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
    rows = x.shape[0] // comms.size
    blocks = [_tensor(x[r * rows:(r + 1) * rows], comms.rank_device(r))
              for r in comms.local_ranks]
    return _sharded(comms, blocks), n, rows


def _stack_rows(out):
    """Per-rank row blocks, stacked or listed, as one (P * rows, ...)
    tensor on the first block's device."""
    if isinstance(out, torch.Tensor):
        return out.reshape((-1,) + tuple(out.shape[2:]))
    return torch.cat([o.to(out[0].device) for o in out])


def mnmg_knn(comms, index, queries, k: int, *, metric="l2_sqrt_expanded",
             p: float = 2.0, block_n: int = 4096
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed brute-force kNN: the index row-sharded over the ranks,
    the queries replicated; each rank searches its shard, then one
    allgather and a merge give the global top-k on every rank (the
    reference's per-partition search + ``knn_merge_parts``). Returns
    (distances (m, k), int32 global row ids (m, k)) on the first local
    rank's device."""
    metric = resolve_metric(metric)
    xs, n, rows = _shard_rows(comms, index)
    q = torch.as_tensor(np.asarray(queries, np.float32)
                        if not isinstance(queries, torch.Tensor)
                        else queries)
    errors.check_k(k, n, "index rows")

    def body(ax, shard, qq):
        qq = _on(qq, shard.device)
        d_loc, i_loc = _knn_single_part(qq, shard, k, metric, p, block_n,
                                        None)
        # the padded tail rows of the last shard must not win the merge
        gidx = i_loc.to(torch.int32) + ax.get_rank() * rows
        d_loc = torch.where(gidx < n, d_loc, float("inf"))
        pd = ax.allgather(d_loc)                 # (P, m, k) in rank order
        pi = ax.allgather(gidx)
        m = qq.shape[0]
        return select_k(pd.permute(1, 0, 2).reshape(m, -1), k,
                        indices=pi.permute(1, 0, 2).reshape(m, -1))

    return comms.run(body, sharded=(xs,), replicated=(q,))


@full_f32
def mnmg_kmeans_fit(comms, x, params: Optional[KMeansParams] = None, *,
                    centroids=None, **kw) -> KMeansOutput:
    """Distributed Lloyd: rows sharded over the ranks; the assignment is
    local (``fused_l2_nn`` per shard), the centroid sums, counts and the
    residual are allreduced — MNMG k-means over the communicator.

    Init: k-means++ over the whole sharded set, as the reference: each
    step allgathers every rank's min-distance mass, finds the owner rank
    of a uniform draw on the global CDF, samples inside the owner's shard
    and broadcasts the chosen row by a masked allreduce. The draws come
    from a CPU ``torch.Generator`` seeded with ``params.seed`` (the JAX
    package's PRNG cannot be reproduced). ``centroids``: optional (k, d)
    initial centroids instead of the seeded init. Empty clusters jump to
    the globally farthest rows. Returns ``KMeansOutput`` with replicated
    centroids and the n rows' labels."""
    if params is None:
        params = KMeansParams(**kw)
    k = params.n_clusters
    xs, n, rows = _shard_rows(comms, x)
    errors.check_k(k, n, "n_clusters vs n rows")
    P = comms.size
    draws = torch.rand(k, generator=torch.Generator().manual_seed(
        int(params.seed)), dtype=torch.float32)
    init = None if centroids is None else torch.as_tensor(
        np.asarray(centroids, np.float32))

    def fit_local(ax, x_loc):
        dev = x_loc.device
        rank = ax.get_rank()
        valid = rank * rows + torch.arange(rows, device=dev) < n
        n_loc = int(valid.sum())
        d = x_loc.shape[1]

        def pick(i, d2):
            mass = torch.where(valid, d2, 0.0)
            tots = ax.allgather(mass.sum())                    # (P,)
            cum = torch.cumsum(tots, 0)
            u = draws[i].to(dev) * cum[-1]
            owner = torch.clamp(torch.searchsorted(cum, u[None],
                                                   right=True)[0], 0, P - 1)
            u_loc = u - (cum[owner] - tots[owner])
            cdf = torch.cumsum(mass, 0)
            loc = torch.clamp(torch.searchsorted(cdf, u_loc[None])[0], 0,
                              rows - 1)
            cand = x_loc[loc]
            return ax.allreduce(torch.where(owner == rank, cand, 0.0))

        if init is not None:
            cents = _on(init, dev).to(x_loc.dtype)
        else:
            cents = torch.zeros((k, d), dtype=x_loc.dtype, device=dev)
            cents[0] = pick(0, torch.where(valid, 1.0, 0.0))
            d2 = ((x_loc - cents[0]) ** 2).sum(1)
            for i in range(1, k):
                nxt = pick(i, d2)
                cents[i] = nxt
                d2 = torch.minimum(d2, ((x_loc - nxt) ** 2).sum(1))

        def assign(c):
            minv, mini = fused_l2_nn(x_loc, c)
            return mini, minv

        def reseed_empty(c, counts, minv):
            # empty centroids jump onto the globally farthest rows: each
            # rank offers its k farthest, one allgather pools them and
            # every rank picks the same winners
            mv = torch.where(valid, minv, float("-inf"))
            kk = min(k, rows)
            neg, li = top_k_smallest(-mv, kk)
            all_v = ax.allgather(-neg, tiled=True)            # (P*kk,)
            all_c = ax.allgather(x_loc[li], tiled=True)       # (P*kk, d)
            far = torch.sort(-all_v, stable=True)[1]
            empty = counts == 0
            er = torch.cumsum(empty.to(torch.int64), 0) - 1
            take = torch.where(empty, far[torch.clamp(er, 0,
                                                      far.shape[0] - 1)], 0)
            return torch.where(empty[:, None], all_c[take].to(c.dtype), c)

        it, prev, res = 0, float("-inf"), float("inf")
        while it < params.max_iter and abs(prev - res) / n > params.tol:
            labels, minv = assign(cents)
            sums, counts = _update_centroids(
                x_loc[:n_loc], labels[:n_loc], k, params.block_rows,
                params.compute_dtype)
            sums = ax.allreduce(sums)
            counts = ax.allreduce(counts)
            new = (sums / torch.clamp(counts, min=1.0)[:, None]).to(
                x_loc.dtype)
            cents = reseed_empty(new, counts, minv)
            prev, res = res, float(ax.allreduce(
                torch.where(valid, minv, 0.0).sum(), ReduceOp.SUM))
            it += 1
        labels, minv = assign(cents)
        inertia = ax.allreduce(torch.where(valid, minv, 0.0).sum())
        return cents, labels.to(torch.int32), inertia, it

    cents, labels, inertia, it = comms.run(
        fit_local, sharded=(xs,),
        out=("replicated", "stacked", "replicated", "replicated"))
    return KMeansOutput(cents, _stack_rows(labels)[:n], inertia, it)
