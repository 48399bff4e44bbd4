"""Sharded IVF-Flat — the port of ``raft_tpu/comms/mnmg_ivf_flat.py``:
exact scoring at list granularity over the ranks of a communicator.

The 10-60M-row regime is where this engine is the answer: raw vectors
fit the ranks' aggregate memory but not one device's, and exact scoring
beats compressed scoring per probed row. Built and served through the
shared shard machinery (:mod:`.mnmg_ivf`):

* **Shard lists, replicate the coarse quantizer** — greedy-LPT list
  ownership, each rank holding its lists' raw rows contiguously
  (``vectors_sorted``) with GLOBAL ids.
* **Queries replicate; rows never move.** Every rank probes the global
  centroids, keeps its owned probes (the sentinel list ``nl_pad - 1``,
  which has no rows, takes the rest) and runs the unchanged
  single-device grouped search
  (:func:`raft_tpu_torch.spatial.ann.ivf_flat._grouped_impl`) on its
  shard — with the kernel engine, one launch of the flat-scan kernel a
  batch on each rank.
* **Merge is a k-way top-k** over one (nq, k) allgather pair; the
  ``l2`` root is taken after the merge, through f64.

Degraded serving (``shard_mask=``, ``failover=``) returns a
:class:`~raft_tpu_torch.resilience.PartialSearchResult`: a down rank's
shards contribute +inf, or fail over onto live replica copies of an
R-way replicated index with no coverage loss; the mask and the route
are runtime operands of the same rank body.

The IVF-SQ sibling (:class:`MnmgIVFSQIndex`) is the same rank body in
its SQ mode: int8 QT_8bit code slabs (half the bf16 footprint) and the
replicated affine pair ``vmin`` / ``vscale``; each shard's grouped
search scans the codes in place with the IVF-SQ kernel.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from raft_tpu_torch import errors
from raft_tpu_torch.cluster.kmeans import kmeans_predict
from raft_tpu_torch.comms.mnmg_ivf import (
    _cdiv_host,
    _check_placed,
    _check_probe_args,
    _check_row_shards,
    _coarse_probe_operands,
    _degraded_operands,
    _exchange_and_assemble,
    _mutation_operands,
    _on,
    _rank_body,
    _train_coarse_distributed,
    place_index,
    shard_rows,
)
from raft_tpu_torch.comms.multihost import comms_levels, hier_axes
from raft_tpu_torch.resilience.degraded import PartialSearchResult
from raft_tpu_torch.spatial.ann import ivf_flat, ivf_sq
from raft_tpu_torch.spatial.ann.common import (
    CoarseIndex,
    ListStorage,
    resolve_qcap_arg,
    static_qcap,
)
from raft_tpu_torch.spatial.ann.ivf_flat import IVFFlatIndex, IVFFlatParams
from raft_tpu_torch.spatial.ann.ivf_sq import IVFSQParams, sq_encode

__all__ = [
    "MnmgIVFFlatIndex", "MnmgIVFSQIndex", "mnmg_ivf_flat_build",
    "mnmg_ivf_flat_build_distributed", "mnmg_ivf_flat_search",
    "mnmg_ivf_sq_build", "mnmg_ivf_sq_build_distributed",
    "mnmg_ivf_sq_search",
]


class _ShardViews:
    """Each local rank's shard of a sharded flat-family index as a
    single-device :class:`IVFFlatIndex` over its ``_SLAB`` field (views
    of the slabs, made on first use and kept, so the kernel engine's scan
    copies live as long as the index)."""

    _SLAB = "vectors_sorted"

    def shard(self, i: int) -> IVFFlatIndex:
        view = self._shards.get(i)
        if view is None:
            sids = self.sorted_ids[i]
            storage = ListStorage(
                sorted_ids=sids,
                list_offsets=self.list_offsets[i],
                # the grouped search reads no list_index; its row count
                # is the list count
                list_index=torch.zeros((self.nl_pad, 1), dtype=torch.int32,
                                       device=sids.device),
                list_sizes=self.list_sizes[i],
                n=self.n_pad,
                max_list=self.max_list,
            )
            # squared distances: the l2 root is taken after the merge
            view = IVFFlatIndex(self.local_cents[i],
                                getattr(self, self._SLAB)[i], storage,
                                "sqeuclidean")
            self._shards[i] = view
        return view

    def warmup(self, comms, nq: int, *, k: int = 10, n_probes: int = 8,
               qcap=None, list_block: int = 32, shard_mask=None,
               failover=None, overprobe: float = 2.0,
               merge_ways: typing.Optional[int] = None, mutation=None,
               wire: str = "bf16",
               use_kernel: typing.Optional[bool] = None,
               rerank_ratio: float = 4.0) -> int:
        """Dispatch one all-zeros (nq, d) batch through the index's
        search (building the kernels and each shard's scan copy of its
        rows on first use) and return the shape-only qcap to pass on
        every serving dispatch of this batch size. ``shard_mask=True``
        warms the degraded variant."""
        nl_g = int(self.centroids.shape[0])
        qc = static_qcap(qcap, nq, n_probes, nl_g)
        dev = comms.rank_device(comms.local_ranks[0])
        q0 = torch.zeros((nq, int(self.centroids.shape[1])),
                         dtype=torch.float32, device=dev)
        search = (mnmg_ivf_sq_search if isinstance(self, MnmgIVFSQIndex)
                  else mnmg_ivf_flat_search)
        search(comms, self, q0, k, n_probes=n_probes, qcap=qc,
               list_block=list_block, shard_mask=shard_mask,
               failover=failover, overprobe=overprobe,
               merge_ways=merge_ways, mutation=mutation, wire=wire,
               use_kernel=use_kernel, rerank_ratio=rerank_ratio)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return qc


@dataclasses.dataclass
class MnmgIVFFlatIndex(_ShardViews):
    """List-sharded IVF-Flat index over a communicator's ranks (the
    reference's field names and order, so the archive and the placement
    machinery apply unchanged). Sharded fields carry a leading axis over
    the ranks (:mod:`.mnmg_ivf`)."""

    centroids: typing.Any       # (n_lists_g, d) replicated
    owner: typing.Any           # (n_lists_g,) int32 — owning rank per list
    local_id: typing.Any        # (n_lists_g,) int32 — list id on its owner
    local_cents: typing.Any     # (P, nl_pad, d) — per-rank centroid slab
    vectors_sorted: typing.Any  # (P, n_pad + 1, d) raw rows, list-sorted
    sorted_ids: typing.Any      # (P, n_pad) int32 GLOBAL row ids
    list_offsets: typing.Any    # (P, nl_pad + 1) int32
    list_sizes: typing.Any      # (P, nl_pad) int32
    n_pad: int
    nl_pad: int
    max_list: int
    n_rows: int
    metric: str
    # R-way striped replica layout: each rank's slab holds `replication`
    # segments of nl_pad/replication lists — segment 0 its own primary
    # shard, segment j the shard (rank - j*replica_offset) % P
    replication: int = 1
    replica_offset: int = 1
    # optional two-level coarse quantizer over the GLOBAL probe set
    # (mnmg_ivf.attach_coarse_index)
    coarse: typing.Optional[CoarseIndex] = None
    # the ranks whose slabs a torch.distributed placement holds (None:
    # every rank)
    _placed: typing.Optional[tuple] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    # each local rank's shard as an IVFFlatIndex view of its slabs (their
    # kernel-engine scan copies are kept with them)
    _shards: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)


def mnmg_ivf_flat_build(comms, x, params: IVFFlatParams = IVFFlatParams(),
                        *, metric: str = "l2") -> MnmgIVFFlatIndex:
    """One-host convenience wrapper: row-shard ``x`` over the ranks (one
    shard at a time, :func:`~.mnmg_ivf.shard_rows`) and run the per-rank
    distributed build."""
    x = np.asarray(x)
    errors.expects(
        x.ndim == 2 and x.shape[0] >= 2,
        "x: expected a (n >= 2, d) matrix, got shape %s", tuple(x.shape),
    )
    if x.dtype == np.float64:
        x = x.astype(np.float32)    # as the JAX package stores f64 input
    xg, n_valid = shard_rows(comms, x)
    return mnmg_ivf_flat_build_distributed(comms, xg, params,
                                           n_valid=n_valid, metric=metric)


def mnmg_ivf_flat_build_distributed(
    comms, x, params: IVFFlatParams = IVFFlatParams(), *, n_valid=None,
    metric: str = "l2",
) -> MnmgIVFFlatIndex:
    """Build a list-sharded IVF-Flat index from PER-RANK row shards: ``x``
    the local ranks' (n_loc, d) blocks (a (P_local, n_loc, d) tensor or a
    list), ``n_valid`` (P,) the valid rows of every rank (default all);
    shard row (r, j) gets global id ``sum(n_valid[:r]) + j``.

    Pipeline: collective subsample -> replicated coarse k-means ->
    per-rank assignment (:func:`_assign_lists`) -> the shared
    distributed list assembly (oversized-list split on global
    within-list ranks, greedy-LPT ownership, bounded-round ``alltoall``
    row exchange, positional slab scatter). ``max_list_cap=None`` means
    AUTO here (``max(256, 2 * n / n_lists)``); pass 0 to disable."""
    nloc, d = _check_row_shards(comms, x)
    Pn = comms.size
    errors.expects(metric in ("l2", "sqeuclidean"),
                   "metric %r not supported (l2 | sqeuclidean)", metric)
    if n_valid is None:
        n_valid = np.full(Pn, nloc, np.int32)
    n_valid = np.asarray(n_valid, np.int32)
    errors.expects(n_valid.shape == (Pn,),
                   "n_valid: expected (%d,), got %s", Pn,
                   tuple(n_valid.shape))
    n = int(n_valid.sum())
    errors.check_k(params.n_lists, n, "n_lists vs dataset rows")
    nl = params.n_lists

    # phase 1: collective subsample -> replicated coarse quantizer
    _, coarse = _train_coarse_distributed(
        comms, x, n_valid, n, nl, None, params.kmeans_n_iters,
        params.kmeans_init, params.seed)
    cents = coarse.centroids
    # phase 2: per-rank assignment + global list sizes
    lbl_g, C = _assign_lists(comms, x, n_valid, cents, nl)
    cap = (params.max_list_cap if params.max_list_cap is not None
           else max(256, 2 * _cdiv_host(n, nl)))
    maps, slabs = _exchange_and_assemble(
        comms, x, n_valid, lbl_g, C, cents, cap, store_vectors=True)
    host = MnmgIVFFlatIndex(
        centroids=maps["cents_np"],
        owner=maps["owner"],
        local_id=maps["local_id"],
        local_cents=maps["lcents_sh"],
        vectors_sorted=slabs["vecs"],
        sorted_ids=slabs["sids"],
        list_offsets=maps["offs_sh"],
        list_sizes=maps["szs_sh"],
        n_pad=maps["n_pad"],
        nl_pad=maps["nl_pad"],
        max_list=maps["max_list"],
        n_rows=n,
        metric=metric,
    )
    if len(comms.local_ranks) != comms.size:
        host._placed = tuple(comms.local_ranks)
    return place_index(comms, host)


def _assign_lists(comms, x, n_valid, cents, nl: int):
    """Phase 2 of the flat-family distributed builds: per-rank
    nearest-centroid assignment (ties to the lowest centroid, full f32)
    in blocks of 2**20 rows, and one allgather of the local bincounts.
    Returns (labels, the local ranks' (n_loc,) int32 blocks; C (P, nl)
    int32 replicated count matrix)."""
    nloc, _ = _check_row_shards(comms, x)
    n_valid = np.asarray(n_valid, np.int32)
    B = max(1, min(nloc, 1 << 20))

    def asg_body(ax, xb, cents_in):
        dev = xb.device
        c = _on(torch.as_tensor(cents_in), dev).float()
        lbl = torch.cat([kmeans_predict(xb[s:s + B], c).to(torch.int32)
                         for s in range(0, nloc, B)])
        valid = (torch.arange(nloc, device=dev)
                 < int(n_valid[ax.get_rank()]))
        key = torch.where(valid, lbl.to(torch.int64), nl)
        cnt = torch.bincount(key, minlength=nl + 1)[:nl].to(torch.int32)
        return lbl, ax.allgather(cnt)

    return comms.run(asg_body, sharded=(x,), replicated=(cents,),
                     out=("stacked", "replicated"))


def _rank_search(ax, shard, *ops, k, n_probes, qcap, list_block, nl_pad,
                 use_coarse, overprobe, merge_ways, replication,
                 replica_offset, use_kernel, rerank_ratio, hier, wire,
                 mutated=False, dequant=None):
    """The flat family's rank body: :func:`~.mnmg_ivf._rank_body` with
    the unchanged single-device grouped search on this rank's shard as
    its scan (its SQ mode with ``dequant``). ``ops`` are the mutation
    blocks (row mask, delta rows, delta ids) when ``mutated``, then the
    replicated operands."""
    dev = shard.device
    mut, ops = (ops[:3], ops[3:]) if mutated else (None, ops)
    if dequant is not None:
        dequant = (_on(dequant[0], dev), _on(dequant[1], dev))

    def scan(qf, lp, row_mask):
        return ivf_flat._grouped_impl(
            shard, qf, k, n_probes, qcap, list_block, probes=lp,
            use_kernel=use_kernel, rerank_ratio=rerank_ratio,
            dequant=dequant, row_mask=row_mask)

    return _rank_body(ax, scan, dev, *ops, mut, k=k, n_probes=n_probes,
                      nl_pad=nl_pad, use_coarse=use_coarse,
                      overprobe=overprobe, merge_ways=merge_ways,
                      replication=replication, replica_offset=replica_offset,
                      use_kernel=use_kernel, hier=hier, wire=wire)


def mnmg_ivf_flat_search(
    comms, index: MnmgIVFFlatIndex, queries, k: int, *,
    n_probes: int = 8, qcap: typing.Union[int, str, None] = None,
    list_block: int = 32,
    qcap_max_drop_frac: typing.Optional[float] = None,
    shard_mask=None, failover=None, overprobe: float = 2.0,
    merge_ways: typing.Optional[int] = None, mutation=None,
    wire: str = "bf16", use_kernel: typing.Optional[bool] = None,
    rerank_ratio: float = 4.0,
):
    """Distributed grouped EXACT search over a list-sharded IVF-Flat
    index. Returns (distances, GLOBAL row ids), both (nq, k) on the first
    local rank's device; distances are rooted for ``metric='l2'``
    (through f64, after the merge) and squared for ``'sqeuclidean'``,
    as the single-device
    :func:`~raft_tpu_torch.spatial.ann.ivf_flat.ivf_flat_search_grouped`.
    Each probed list is scored by exactly one rank with the same scan,
    so results match the single-device search on the same lists.

    ``qcap`` as in the single-device grouped search (None: sized from
    the global probe map; ``"throughput"``; an int — serving passes the
    value :meth:`MnmgIVFFlatIndex.warmup` returned). ``shard_mask`` (a
    :class:`~raft_tpu_torch.resilience.ShardHealth`, a (P,) mask, a
    health report or True) selects the degraded variant and a
    :class:`~raft_tpu_torch.resilience.PartialSearchResult`; ``failover``
    (a :class:`~raft_tpu_torch.resilience.FailoverPlan` or a (P,) copy
    route, with ``shard_mask``) serves a down rank's shards from live
    replicas. ``overprobe`` widens the two-level probe when the index
    carries a coarse quantizer; ``merge_ways`` pads the merge to a
    deployment's shard count; ``wire`` picks the cross-host wire format
    on a two-level communicator. ``use_kernel`` picks each shard's scan
    engine as :func:`~raft_tpu_torch.spatial.ann.ivf_flat._resolve_scan_engine`
    does (None: the CUDA kernel on a Hopper card). ``mutation`` (an
    :class:`~.mnmg_mutation.MnmgMutationState` or
    :class:`~.mnmg_mutation.MnmgMutableIndex`) folds the per-rank
    tombstones into each shard's scan and merges an exact scan of the
    rank's delta segments before the cross-shard merge."""
    out = _flat_family_search(
        comms, index, queries, k, sq=False, n_probes=n_probes, qcap=qcap,
        list_block=list_block, qcap_max_drop_frac=qcap_max_drop_frac,
        shard_mask=shard_mask, failover=failover, overprobe=overprobe,
        merge_ways=merge_ways, mutation=mutation, wire=wire,
        use_kernel=use_kernel, rerank_ratio=rerank_ratio,
    )
    if index.metric != "l2":
        return out
    # the root after the merge; +inf slots (down shards, invalid rows)
    # stay +inf
    if isinstance(out, PartialSearchResult):
        return dataclasses.replace(out,
                                   distances=ivf_flat._sqrt(out.distances))
    vals, ids = out
    return ivf_flat._sqrt(vals), ids


def _flat_family_search(comms, index, queries, k, **kw):
    """Validate, resolve the engine per shard, and run the rank body over
    the local ranks; squared distances (the flat wrapper roots them)."""
    body, sharded, replicated, degraded = _prepare_flat_family(
        comms, index, queries, k, **kw)
    if not degraded:
        return comms.run(body, sharded=sharded, replicated=replicated)
    md, mi, cov, rv = comms.run(body, sharded=sharded,
                                replicated=replicated)
    return PartialSearchResult(distances=md, ids=mi, coverage=cov,
                               row_valid=rv)


def _prepare_flat_family(comms, index, queries, k, *, sq, n_probes, qcap,
                         list_block, qcap_max_drop_frac, shard_mask,
                         failover, overprobe, merge_ways, mutation, wire,
                         use_kernel, rerank_ratio):
    """The non-dispatching front half of :func:`_flat_family_search`:
    validation, qcap and engine resolution, and the rank body's operands.
    Returns ``(body, sharded, replicated, degraded)``."""
    local, dev0 = _check_placed(comms, index)
    q = torch.as_tensor(queries, device=dev0)
    if q.dtype == torch.float64:
        q = q.float()
    errors.check_matrix(q, "queries")
    errors.check_same_cols(q, index.centroids, "queries", "index")
    errors.expects(
        k <= n_probes * index.max_list,
        "k=%d exceeds the candidate pool (n_probes*max_list=%d)",
        k, n_probes * index.max_list,
    )
    errors.expects(
        k <= index.max_list,
        "k=%d exceeds max_list=%d — a single list cannot fill a per-list "
        "top-k row; lower k or rebuild with fewer lists", k, index.max_list,
    )
    nl_g = int(index.centroids.shape[0])
    n_hosts, inner_width = comms_levels(comms)
    _check_probe_args(index, nl_g, overprobe, merge_ways, inner_width, wire)
    qcap, _ = resolve_qcap_arg(
        qcap, q, index.centroids, nl_g, n_probes,
        max_drop_frac=qcap_max_drop_frac, coarse=index.coarse,
        overprobe=overprobe)
    list_block = max(1, min(list_block, index.nl_pad))
    d = int(index.centroids.shape[1])
    shards = [index.shard(i) for i in range(len(local))]
    resolve = (ivf_sq._resolve_sq_engine if sq
               else ivf_flat._resolve_scan_engine)
    engines = {s.device: resolve(use_kernel, d, qcap, s.device)
               for s in shards}
    dequant = ((_on(torch.as_tensor(index.vmin), dev0).float(),
                _on(torch.as_tensor(index.vscale), dev0).float())
               if sq else None)
    alive, route = _degraded_operands(comms, index, shard_mask, failover,
                                      dev0)
    mut = _mutation_operands(mutation, index, len(local))
    sup_c, mem_i, cpad = _coarse_probe_operands(index, d, dev0)
    statics = dict(
        k=k, n_probes=n_probes, qcap=qcap, list_block=list_block,
        nl_pad=int(index.nl_pad), use_coarse=index.coarse is not None,
        overprobe=float(overprobe),
        merge_ways=None if merge_ways is None else int(merge_ways),
        replication=int(index.replication),
        replica_offset=int(index.replica_offset),
        rerank_ratio=float(rerank_ratio), hier=hier_axes(comms),
        wire=wire if n_hosts > 1 else None, mutated=mut is not None,
    )

    def body(ax, shard, *ops):
        return _rank_search(ax, shard, *ops,
                            use_kernel=engines[shard.device],
                            dequant=dequant, **statics)

    replicated = (q, index.centroids, index.owner, index.local_id, sup_c,
                  mem_i, cpad, alive, route)
    return body, (shards,) + tuple(mut or ()), replicated, alive is not None


# ---------------------------------------------------------------- IVF-SQ
@dataclasses.dataclass
class MnmgIVFSQIndex(_ShardViews):
    """List-sharded int8 IVF-SQ index over a communicator's ranks — the
    SQ mode of the flat family's one rank body, with the reference's
    field names and order: ``codes_sorted`` holds int8 QT_8bit codes and
    the replicated affine pair ``vmin`` / ``vscale`` decodes them."""

    _SLAB = "codes_sorted"

    centroids: typing.Any       # (n_lists_g, d) replicated
    owner: typing.Any           # (n_lists_g,) int32
    local_id: typing.Any        # (n_lists_g,) int32
    local_cents: typing.Any     # (P, nl_pad, d)
    codes_sorted: typing.Any    # (P, n_pad + 1, d) int8, list-sorted
    vmin: typing.Any            # (d,) f32 replicated affine offset
    vscale: typing.Any          # (d,) f32 replicated affine scale
    sorted_ids: typing.Any      # (P, n_pad) int32 GLOBAL row ids
    list_offsets: typing.Any    # (P, nl_pad + 1) int32
    list_sizes: typing.Any      # (P, nl_pad) int32
    n_pad: int
    nl_pad: int
    max_list: int
    n_rows: int
    replication: int = 1
    replica_offset: int = 1
    # present (always None) so the layout machinery treats the SQ index
    # through the same field protocol as its sibling
    vectors_sorted: typing.Any = None
    coarse: typing.Optional[CoarseIndex] = None
    _placed: typing.Optional[tuple] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    _shards: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)


def mnmg_ivf_sq_build(comms, x, params=None) -> MnmgIVFSQIndex:
    """One-host convenience wrapper: row-shard ``x`` over the ranks and
    run the per-rank distributed SQ build."""
    x = np.asarray(x)
    errors.expects(
        x.ndim == 2 and x.shape[0] >= 2,
        "x: expected a (n >= 2, d) matrix, got shape %s", tuple(x.shape),
    )
    if x.dtype == np.float64:
        x = x.astype(np.float32)
    xg, n_valid = shard_rows(comms, x)
    return mnmg_ivf_sq_build_distributed(
        comms, xg, params if params is not None else IVFSQParams(),
        n_valid=n_valid)


def mnmg_ivf_sq_build_distributed(comms, x, params=None, *,
                                  n_valid=None) -> MnmgIVFSQIndex:
    """Build a list-sharded int8 IVF-SQ index from PER-RANK row shards —
    the SQ sibling of :func:`mnmg_ivf_flat_build_distributed` (same
    input convention and phases): collective subsample -> replicated
    coarse k-means (k-means++ seeding, as the reference) -> the shared
    assignment (:func:`_assign_lists`) -> a collective masked min/max
    for the QT_8bit affine stats -> per-rank int8 encode -> the shared
    list assembly with the codes as the exchange payload, one byte a
    dimension."""
    if params is None:
        params = IVFSQParams()
    nloc, d = _check_row_shards(comms, x)
    Pn = comms.size
    if n_valid is None:
        n_valid = np.full(Pn, nloc, np.int32)
    n_valid = np.asarray(n_valid, np.int32)
    n = int(n_valid.sum())
    errors.check_k(params.n_lists, n, "n_lists vs dataset rows")
    nl = params.n_lists
    _, coarse = _train_coarse_distributed(
        comms, x, n_valid, n, nl, None, params.kmeans_n_iters, "k-means++",
        params.seed)
    cents = coarse.centroids
    lbl_g, C = _assign_lists(comms, x, n_valid, cents, nl)

    # QT_8bit stats: per-rank masked min / max and one allgather each
    # (padding rows cannot drag the range toward zero)
    def stats_body(ax, xb):
        xb = xb.float()
        valid = (torch.arange(nloc, device=xb.device)
                 < int(n_valid[ax.get_rank()]))[:, None]
        big = 3.4e38
        mn = torch.where(valid, xb, big).amin(0)
        mx = torch.where(valid, xb, -big).amax(0)
        return ax.allgather(mn).amin(0), ax.allgather(mx).amax(0)

    vmin, vmax = comms.run(stats_body, sharded=(x,))
    vscale = torch.clamp(vmax - vmin, min=1e-12) / 255.0

    # per-rank int8 encode; the payload is the int8 pattern viewed as
    # uint8 (bit-preserving both ways)
    def enc_body(ax, xb, mn, sc):
        return sq_encode(xb, _on(mn, xb.device),
                         _on(sc, xb.device)).view(torch.uint8)

    codes_u8 = comms.run(enc_body, sharded=(x,), replicated=(vmin, vscale),
                         out="stacked")
    cap = (params.max_list_cap if params.max_list_cap is not None
           else max(256, 2 * _cdiv_host(n, nl)))
    maps, slabs = _exchange_and_assemble(
        comms, x, n_valid, lbl_g, C, cents, cap, store_vectors=False,
        codes_g=codes_u8, M=d)
    codes = slabs["codes"]
    codes = (codes.view(torch.int8) if isinstance(codes, torch.Tensor)
             else [c.view(torch.int8) for c in codes])
    host = MnmgIVFSQIndex(
        centroids=maps["cents_np"],
        owner=maps["owner"],
        local_id=maps["local_id"],
        local_cents=maps["lcents_sh"],
        codes_sorted=codes,
        vmin=vmin.float(),
        vscale=vscale.float(),
        sorted_ids=slabs["sids"],
        list_offsets=maps["offs_sh"],
        list_sizes=maps["szs_sh"],
        n_pad=maps["n_pad"],
        nl_pad=maps["nl_pad"],
        max_list=maps["max_list"],
        n_rows=n,
    )
    if len(comms.local_ranks) != comms.size:
        host._placed = tuple(comms.local_ranks)
    return place_index(comms, host)


def mnmg_ivf_sq_search(
    comms, index: MnmgIVFSQIndex, queries, k: int, *,
    n_probes: int = 8, qcap: typing.Union[int, str, None] = None,
    list_block: int = 32,
    qcap_max_drop_frac: typing.Optional[float] = None,
    shard_mask=None, failover=None, overprobe: float = 2.0,
    merge_ways: typing.Optional[int] = None, mutation=None,
    wire: str = "bf16", use_kernel: typing.Optional[bool] = None,
    rerank_ratio: float = 4.0,
):
    """Distributed grouped IVF-SQ search over a list-sharded int8 index —
    the SQ mode of the one rank body of :func:`mnmg_ivf_flat_search`,
    with the same knobs and contracts. Returns (squared L2 distances
    over the dequantized rows, GLOBAL row ids), both (nq, k);
    ``use_kernel`` picks each shard's engine as
    :func:`~raft_tpu_torch.spatial.ann.ivf_sq._resolve_sq_engine` does
    (None: the CUDA int8 dequant + scan kernel on a Hopper card)."""
    return _flat_family_search(
        comms, index, queries, k, sq=True, n_probes=n_probes, qcap=qcap,
        list_block=list_block, qcap_max_drop_frac=qcap_max_drop_frac,
        shard_mask=shard_mask, failover=failover, overprobe=overprobe,
        merge_ways=merge_ways, mutation=mutation, wire=wire,
        use_kernel=use_kernel, rerank_ratio=rerank_ratio,
    )
