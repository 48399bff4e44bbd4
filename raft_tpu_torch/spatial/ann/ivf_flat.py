"""IVF-Flat ANN index — the port of ``raft_tpu/spatial/ann/ivf_flat.py``.

Build: k-means coarse quantizer -> vectors permuted into contiguous lists
(:mod:`.common`). Search (per query): score queries x centroids, take the
top-nprobe lists, gather the padded probed lists, score the candidates
in exact f32, keep the k best. Grouped search (the serving path): the
one grouped body (:func:`.grouped.search`) over the rows'
:class:`~.grouped.FlatEngine` — each list scanned once per batch for all
its probing queries, with the hand-written CUDA sub-chunk-min scan
(:mod:`.flat_kernel`) and an exact f32 rerank, or with the legacy
materialized-tile scan.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Tuple

import torch

from raft_tpu_torch import errors
from raft_tpu_torch.cluster.kmeans import KMeansParams, kmeans_fit
from raft_tpu_torch.core.device import resolve_device
from raft_tpu_torch.spatial.ann import grouped, search_obs
from raft_tpu_torch.spatial.ann.common import (
    ListStorage,
    as_queries,
    build_list_storage,
    check_candidate_pool,
    coarse_probe,
    map_query_blocks,
    resolve_qcap_arg,
    score_l2_candidates,
    select_candidates,
    split_oversized_lists,
    static_qcap,
)

__all__ = [
    "IVFFlatParams",
    "IVFFlatIndex",
    "ivf_flat_build",
    "ivf_flat_search",
    "ivf_flat_search_grouped",
]

@dataclasses.dataclass(frozen=True)
class IVFFlatParams:
    """Analog of IVFFlatParam (reference ann_common.h: nlist, nprobe)."""

    n_lists: int = 64
    kmeans_n_iters: int = 20
    seed: int = 0
    kmeans_init: str = "k-means++"  # "random": cheap coarse quantizer
    # longest allowed inverted list (common.split_oversized_lists);
    # None/0 = off
    max_list_cap: typing.Optional[int] = None


@dataclasses.dataclass
class IVFFlatIndex:
    centroids: torch.Tensor      # (n_lists, d)
    data_sorted: torch.Tensor    # (n + 1, d) — last row is the sentinel (zeros)
    storage: ListStorage
    metric: str
    # the kernel engine's slab operands of data_sorted, by padded row count
    _scan_rows: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    def scan_rows(self, n_rows: int) -> torch.Tensor:
        """``data_sorted`` as a scan kernel's slab operand — bf16 for
        float rows, the int8 codes as they are for the IVF-SQ view — with
        zero rows appended up to ``n_rows``: made on first use, then kept
        (an index is not mutated in place). int8 codes that need no
        padding are returned without a copy."""
        return grouped.slab_rows(self.data_sorted, n_rows, self._scan_rows)

    def warmup(self, nq: int, *, k: int = 10, n_probes: int = 8,
               qcap=None, list_block: int = 32, stream_partials=None,
               use_kernel: typing.Optional[bool] = None,
               rerank_ratio: float = 4.0) -> int:
        """Run one all-zeros (nq, d) batch through the grouped serving
        search (building the CUDA kernels, the bf16 scan copy of the rows
        and initialising the device libraries on first use) and return the shape-only qcap
        (:func:`~.common.static_qcap`) to pass on every serving dispatch
        of this batch size."""
        qc = static_qcap(qcap, nq, n_probes, self.centroids.shape[0])
        q0 = torch.zeros((nq, self.centroids.shape[1]), dtype=torch.float32,
                         device=self.device)
        with search_obs.uncounted():
            ivf_flat_search_grouped(
                self, q0, k, n_probes=n_probes, qcap=qc,
                list_block=list_block, stream_partials=stream_partials,
                use_kernel=use_kernel, rerank_ratio=rerank_ratio,
            )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return qc


def ivf_flat_build(x, params: IVFFlatParams = IVFFlatParams(), *,
                   metric: str = "l2", device=None) -> IVFFlatIndex:
    """Build: k-means (bf16-operand centroid updates) + list permutation.
    ``device`` defaults to CUDA and raises when no CUDA device is
    present; pass ``device="cpu"`` to build on the CPU."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    if x.dtype == torch.float64:
        x = x.float()          # as the JAX package stores f64 input
    errors.check_matrix(x, "x", min_rows=2)
    errors.check_k(params.n_lists, x.shape[0], "n_lists vs dataset rows")
    out = kmeans_fit(
        x,
        KMeansParams(
            n_clusters=params.n_lists,
            max_iter=params.kmeans_n_iters,
            seed=params.seed,
            init=params.kmeans_init,
            compute_dtype="bfloat16",
        ),
    )
    labels_np, cents = out.labels.cpu().numpy(), out.centroids
    if params.max_list_cap:
        labels_np, cents = split_oversized_lists(
            labels_np, cents, params.max_list_cap
        )
    storage = build_list_storage(labels_np, cents.shape[0], dev)
    data_sorted = torch.cat([
        x[storage.sorted_ids.long()],
        torch.zeros((1, x.shape[1]), dtype=x.dtype, device=dev),
    ])
    return IVFFlatIndex(cents, data_sorted, storage, metric)


def ivf_flat_search(index: IVFFlatIndex, queries, k: int, *,
                    n_probes: int = 8, block_q: int = 512,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query search: returns (dists, ids) with original row ids
    (squared distances, sqrt applied for metric='l2'). Queries are
    processed in ``block_q`` blocks to bound the candidate gather."""
    q = as_queries(queries, index.centroids)
    check_candidate_pool(k, n_probes, index.storage)
    storage = index.storage

    def one_block(qb):
        qf = qb.float()
        probes, _ = coarse_probe(qf, index.centroids, n_probes)
        cand_pos = storage.list_index[probes].reshape(qb.shape[0], -1)
        cand_vecs = index.data_sorted[cand_pos.long()].float()
        d2 = score_l2_candidates(qf, cand_vecs, cand_pos < storage.n)
        return select_candidates(storage, cand_pos, d2, k)

    vals, ids = map_query_blocks(one_block, q, block_q)
    if index.metric == "l2":
        vals = _sqrt(vals)
    return vals, ids


def _sqrt(vals):
    # via f64: correctly rounded on every device (torch's f32 CPU sqrt
    # is not, and neither is XLA's)
    return torch.sqrt(torch.clamp_min(vals, 0.0).double()).float()


@search_obs.entry("ivf_flat")
def ivf_flat_search_grouped(
    index: IVFFlatIndex, queries, k: int, *, n_probes: int = 8,
    qcap: typing.Union[int, str, None] = None, list_block: int = 32,
    stream_partials: typing.Optional[bool] = None,
    qcap_max_drop_frac: typing.Optional[float] = None,
    use_kernel: typing.Optional[bool] = None,
    rerank_ratio: float = 4.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Throughput-mode IVF search, grouped by list instead of by query:
    each list's vectors are read once per batch and scored against all
    its probing queries (at most ``qcap``; overflow pairs drop, lowest
    probe rank kept first).

    ``qcap``: ``None`` auto-sizes from the actual probe map (at most 2%
    of pairs drop, logged); ``"throughput"`` ~0.75x the mean occupancy;
    an int as-is (serving passes the value ``index.warmup`` returned).

    ``use_kernel``: ``None`` runs the CUDA sub-chunk-min scan on a
    Hopper card when it fits (:func:`~.grouped.resolve_kernel`) — only
    the (qcap, l_pad/8) minima per list leave the kernel, and the top
    ``ceil(rerank_ratio*k)`` sub-chunks' rows are rescored in exact f32,
    so returned distances are exact (a CUDA index the kernel cannot serve
    runs the legacy scan, counted in ``grouped.ENGINE_FALLBACKS`` and
    warned about); ``False`` pins the legacy
    materialized-tile scan; ``True`` asks for the kernel path and raises
    when it cannot run. The engines return the same candidates by value
    (the rerank pool covers the top-k at the ``rerank_ratio`` margin);
    tied candidates may order differently.

    The IVF-SQ mode of this search is
    :func:`~.ivf_sq.ivf_sq_search_grouped`; tombstoned rows are searched
    through :func:`~.mutation.mutable_search`.

    With ``qcap`` large enough this returns what :func:`ivf_flat_search`
    returns for the same ``n_probes``."""
    q = as_queries(queries, index.centroids)
    storage = index.storage
    if k > storage.max_list:
        # a single list cannot fill a per-list top-k row
        errors.expects(
            not use_kernel,
            "use_kernel=True: k=%d > max_list=%d routes to the per-query "
            "search, which has no kernel path; lower k or rebuild with "
            "fewer lists", k, storage.max_list,
        )
        return ivf_flat_search(index, q, k, n_probes=n_probes)
    check_candidate_pool(k, n_probes, storage)
    n_lists = storage.list_index.shape[0]
    qcap, probes = resolve_qcap_arg(
        qcap, q, index.centroids, n_lists, n_probes,
        max_drop_frac=qcap_max_drop_frac, engine="ivf_flat",
    )
    list_block = max(1, min(list_block, n_lists))
    engine = grouped.FlatEngine.of(index, use_kernel, qcap, rerank_ratio)
    vals, ids = grouped.search(engine, q, k, n_probes, qcap, list_block,
                               probes=probes, stream_partials=stream_partials)
    if index.metric == "l2":
        vals = _sqrt(vals)
    return vals, ids
